from .engine import RequestState, ServeConfig, ServingEngine

__all__ = ["RequestState", "ServeConfig", "ServingEngine"]
