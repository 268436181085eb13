from .stream import StreamSource, batch_specs

__all__ = ["StreamSource", "batch_specs"]
