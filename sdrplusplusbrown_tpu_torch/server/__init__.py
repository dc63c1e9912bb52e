from .http_server import HttpDebugServer

__all__ = ["HttpDebugServer"]
