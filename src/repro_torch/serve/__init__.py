from .engine import (
    PagedServeEngine,
    Request,
    ServeEngine,
    make_decode_step,
    make_prefill_step,
)
from .paging import BlockAllocator, OutOfBlocks, PrefixCache, SequenceBlocks

__all__ = [
    "BlockAllocator",
    "OutOfBlocks",
    "PagedServeEngine",
    "PrefixCache",
    "Request",
    "SequenceBlocks",
    "ServeEngine",
    "make_decode_step",
    "make_prefill_step",
]
