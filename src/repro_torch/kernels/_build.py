"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (all sources at
once, one process each) and linked into one shared library with a plain C
interface.  The library lands in ``build/kernels/<hash>/`` at the root of
the checkout, keyed by a hash of the sources and the flags, so an edit
rebuilds and an unchanged tree reuses the last build.  Nothing is built
when the module is imported.  A failed build raises.

``counted`` is the one hook through which every wrapper reports a kernel
call, with its ``Cost``, to the op counters of
``repro_torch.launch.op_analysis``: on CPU tensors (the plain version) and
on a real launch alike.  It only counts.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # as in csrc/common.cuh
MAX_SMEM_BYTES = 232448  # dynamic shared memory one block may opt into on sm_90
# every entry point returns the cudaError_t of its launch
_SIGNATURES = {
    "repro_rmsnorm": ([_int, _int, _vp, _vp, _vp, _int, _int, _float, _vp],
                      ctypes.c_int),
    "repro_paged_decode_attention": (
        [_int, _int, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _int, _int,
         _int, _int, _int, _int, _int, _int, _int, _float, _vp],
        ctypes.c_int),
    "repro_paged_decode_smem_bytes": ([_int, _int, _int, _int, _int, _int],
                                      ctypes.c_longlong),
    "repro_paged_decode_max_tile": ([], ctypes.c_int),
    "repro_decode_attention": (
        [_int, _int, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _int, _int, _int,
         _int, _int, _int, _int, _float, _vp], ctypes.c_int),
    "repro_decode_merge": ([_int, _int, _vp, _vp, _vp, _int, _int, _int, _int, _vp],
                           ctypes.c_int),
    "repro_decode_attention_smem_bytes": ([_int, _int, _int, _int],
                                          ctypes.c_longlong),
    "repro_decode_attention_tensor_cores": ([_int, _int, _int, _vp, _vp, _vp],
                                            ctypes.c_int),
    "repro_flash_attention": (
        [_int, _int, _vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int, _int,
         _int, _int, _float, _vp], ctypes.c_int),
    "repro_flash_attention_max_head_dim": ([], ctypes.c_int),
    "repro_flash_attention_route": ([_int, _int, _vp, _vp, _vp, _vp, _int],
                                    ctypes.c_int),
    "repro_flash_attention_bwd": (
        [_int, _int, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _int,
         _vp, _int, _int, _int, _int, _int, _int, _int, _int, _float, _vp],
        ctypes.c_int),
    "repro_flash_attention_bwd_key_tile": ([], ctypes.c_int),
    "repro_flash_attention_bwd_f32_key_tile": ([], ctypes.c_int),
    "repro_rglru_scan": ([_int, _vp, _vp, _vp, _int, _int, _int, _vp],
                         ctypes.c_int),
    "repro_rglru_scan_bwd": ([_int, _vp, _vp, _vp, _vp, _vp, _int, _int, _int,
                              _vp], ctypes.c_int),
    "repro_mlstm_chunk": (
        [_int, _int, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
         _int, _int, _int, _int, _int, _int, _int, _int, _float, _vp],
        ctypes.c_int),
    "repro_mlstm_chunk_bwd": (
        [_int, _int] + [_vp] * 15 + [_int] * 8 + [_float, _vp], ctypes.c_int),
    "repro_mlstm_chunk_bwd_scratch": ([_int] * 5, ctypes.c_longlong),
    "repro_mlstm_chunk_max_dk": ([], ctypes.c_int),
    "repro_mlstm_chunk_max_chunk": ([], ctypes.c_int),
    "repro_error_string": ([_int], ctypes.c_char_p),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / "librepro_kernels.so"


def build() -> Path:
    """Compile and link the kernels unless this source hash is built."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _obj, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                               + "\n".join(log))
        staged = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(staged),
             *(str(obj) for _src, obj, _proc in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        (out.parent / "build.log").write_text("\n".join(log))
        os.replace(staged, out)  # atomic: a concurrent build sees all or nothing
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        text = library().repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text}) at launch")


def on_cpu(name: str, **tensors) -> bool:
    """True when every tensor lies on the CPU (the wrapper then runs the
    plain version), False when none does; raises on a mix."""
    where = {arg: t.device.type == "cpu" for arg, t in tensors.items()}
    if all(where.values()):
        return True
    if any(where.values()):
        cpu = [arg for arg, here in where.items() if here]
        raise ValueError(f"{name}: {', '.join(cpu)} on the CPU and the rest "
                         "not; the kernel takes CUDA tensors and the plain "
                         "version CPU tensors")
    return False


class Cost(NamedTuple):
    """The work one kernel call's function needs, whichever implementation
    runs: ``flops`` (a multiply-add counts two) and ``bytes`` of device
    memory (each input read once, each output written once).  Each wrapper
    module's ``*_cost`` functions reckon it from shapes (and, where the
    caller knows them, the valid lengths)."""

    flops: float
    bytes: float


# the op counters counting now (repro_torch.launch.op_analysis.OpCounter),
# innermost last
COUNTERS: list = []


@contextlib.contextmanager
def counted(name: str, cost):
    """One call of kernel ``name``, whose work is ``cost()`` (a ``Cost``),
    reported to every counter that is counting; one in kernel mode sets
    aside the ops run within (the plain version's, on CPU tensors) and
    counts the cost instead.  With no counter it does nothing; either way
    the call launches or raises as it would."""
    if not COUNTERS:
        yield
        return
    work = cost()
    for counter in COUNTERS:
        counter.enter_kernel(name, work)
    try:
        yield
    finally:
        for counter in reversed(COUNTERS):
            counter.exit_kernel(name)


def shapes_only() -> bool:
    """True when every counter counting is a dry-run's (kernel mode on fake
    tensors, ``shapes_only``): a wrapper then returns outputs of the right
    shapes and dtypes without running its plain version (its ``Cost`` is
    the count), and a loop of like steps runs one step counted as all of
    them (``repeated``)."""
    return bool(COUNTERS) and all(c.shapes_only for c in COUNTERS)


@contextlib.contextmanager
def repeated(n: int):
    """The ops within count ``n`` times: one step standing for a loop of
    ``n`` like steps under ``shapes_only``."""
    for counter in COUNTERS:
        counter.scale *= n
    try:
        yield
    finally:
        for counter in COUNTERS:
            counter.scale /= n


def refuse_grad(name: str, **tensors) -> None:
    """Raise under grad mode when any tensor requires grad: for a wrapper
    whose kernel has no backward (in either package), whose output would
    otherwise come back cut off from autograd."""
    if torch.is_grad_enabled():
        needs = [arg for arg, t in tensors.items() if t.requires_grad]
        if needs:
            raise RuntimeError(
                f"{name} has no backward, and {', '.join(needs)} require "
                "grad; call it under torch.no_grad()")


def check_inputs(name: str, device: torch.device, **tensors) -> None:
    """The wrappers' common checks: every tensor on ``device`` (a CUDA
    device) and contiguous.  Raises on anything the kernels do not take."""
    if device.type != "cuda":
        raise ValueError(f"{name}: tensors on {device}; the kernel takes "
                         "CUDA tensors and the plain version CPU tensors")
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the split plans
    size their grids by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the handle C takes."""
    return torch.cuda.current_stream(device).cuda_stream
