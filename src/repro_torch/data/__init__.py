"""The host-sharded token pipeline (a copy of the JAX package's)."""
from .pipeline import (DataConfig, Pipeline, make_pipeline,
                       synthetic_batch_specs)

__all__ = ["DataConfig", "Pipeline", "make_pipeline", "synthetic_batch_specs"]
