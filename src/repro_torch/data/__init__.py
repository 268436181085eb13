from .stream import StreamSource

__all__ = ["StreamSource"]
