"""Optimizers and gradient compression: the JAX package's ``optim``."""
from .adamw import (AdamWConfig, adamw_init, adamw_update, clip_by_global_norm,
                    cosine_schedule, global_norm)
from .adafactor import AdafactorConfig, adafactor_init, adafactor_update
from .compression import (ErrorFeedback, compress_int8, compressed_psum,
                          decompress_int8)

__all__ = ["AdafactorConfig", "adafactor_init", "adafactor_update",
           "AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "cosine_schedule", "global_norm",
           "compress_int8", "compressed_psum", "decompress_int8",
           "ErrorFeedback"]
