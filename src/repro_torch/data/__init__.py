"""The host-sharded token pipeline (a copy of the JAX package's)."""
from .pipeline import DataConfig, Pipeline, make_pipeline

__all__ = ["DataConfig", "Pipeline", "make_pipeline"]
