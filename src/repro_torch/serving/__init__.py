from .engine import ServeConfig, ServeEngine

__all__ = ["ServeConfig", "ServeEngine"]
