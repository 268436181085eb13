from .engine import PagedServeEngine, Request
from .paging import BlockAllocator, OutOfBlocks, PrefixCache, SequenceBlocks

__all__ = [
    "BlockAllocator",
    "OutOfBlocks",
    "PagedServeEngine",
    "PrefixCache",
    "Request",
    "SequenceBlocks",
]
