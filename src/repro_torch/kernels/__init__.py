"""Kernels written by hand for Hopper (sm_90a), in CUDA C++.

Each kernel: a source under ``csrc/``, a wrapper module that checks its
inputs and launches it on PyTorch's current stream (and counts launches),
and a plain PyTorch version in ``ref.py`` that the wrapper runs for CPU
tensors and that tests hold the kernel against.  ``_build`` compiles the
sources with ``nvcc`` at first use.
"""

from . import ref
from .decode_attention import decode_attention, merge_partials, paged_decode_attention
from .flash_attention import flash_attention, flash_attention_bwd, flash_attention_train
from .flash_attention import route as flash_route
from .mlstm_chunk import mlstm_chunk, mlstm_chunk_bwd
from .rglru_scan import rglru_scan, rglru_scan_bwd
from .rmsnorm import rmsnorm

KERNELS = (rmsnorm, paged_decode_attention, decode_attention, merge_partials,
           flash_attention, flash_attention_bwd, rglru_scan, rglru_scan_bwd, mlstm_chunk,
           mlstm_chunk_bwd)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0


__all__ = ["KERNELS", "decode_attention", "flash_attention",
           "flash_attention_bwd", "flash_attention_train", "flash_route", "merge_partials",
           "mlstm_chunk", "mlstm_chunk_bwd", "paged_decode_attention", "ref",
           "reset_launch_counts", "rglru_scan", "rglru_scan_bwd", "rmsnorm"]
