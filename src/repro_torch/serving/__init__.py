from .engine import ServeConfig, ServingEngine

__all__ = ["ServeConfig", "ServingEngine"]
