#!/usr/bin/env python3
"""Time the port's RMSNorm and chunkwise-mLSTM kernels on one NVIDIA GPU.

    python3 scripts/bench_norm_mlstm.py [ROOT ...]

For each ROOT (a checkout of this repository; by default the one holding
this script), in the order given, builds that checkout's kernels and times:

- ``repro_torch.kernels.rmsnorm`` at the decode shapes (8, 2048) and
  (64, 8, 128) and the prefill and training shapes (1024, 2048),
  (2048, 2048), (4096, 4096), (2048, 768) and (2048, 1536), in bf16 and in
  f32, with ``F.rms_norm`` on the same inputs as the yardstick;
- ``repro_torch.kernels.mlstm_chunk`` with its final carry at xlstm-125m's
  prefill shape (1, 2048, 4, 384), chunk 128, in bf16 and in f32, with each
  of its passes' device time (state and output; ``torch.profiler`` over
  three calls, as for the backward);
- ``repro_torch.kernels.mlstm_chunk_bwd`` at xlstm-125m's training shape
  (2, 1024, 4, 384), chunk 128, in bf16 and in f32, on the forward kernel's
  workspace, with each of its passes' device time (``torch.profiler`` over
  three calls: every kernel a call launches, by name);

with the largest error against the plain version and a SHA-256 of every
output, forward and backward (two checkouts whose kernels give the same
bits print the same digests).  Each ROOT runs in its
own process, so two versions can be compared on one card in one call: give
them in turns (A B B A).  Prints the card's name and power limit, then one
JSON line per ROOT.

    python3 scripts/bench_norm_mlstm.py --gates [ROOT ...]

runs instead, for each ROOT, xlstm-125m's per-layer mLSTM gate at full
width and 4 layers with random weights (seed 0), as ``chip_smoke.py``
holds it: each mLSTM layer's kernel output, on the q, k, v and gates its
forward over 4096 tokens hands it, against the f64 result, counting the
elements outside 5e-5 + 5e-4 rel of it (held: the kernel leaves no more
than the plain version), for a bf16 forward and for an f32 one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RMSNORM = ((8, 2048), (64, 8, 128), (1024, 2048), (2048, 2048), (4096, 4096),
           (2048, 768), (2048, 1536))
MLSTM = (1, 2048, 4, 384, 128)
MLSTM_BWD = (2, 1024, 4, 384, 128)


def digest(*tensors) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def pass_times(fn, calls: int = 3) -> dict:
    """Device ms per call of each kernel ``fn`` launches, by name, from
    torch.profiler over ``calls`` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us > 0:
            out[e.key[:90]] = us / calls / 1e3
    return out


def measure(root: str) -> dict:
    """Build and time ``root``'s kernels in this process."""
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    import torch.nn.functional as F

    import importlib

    import chip_smoke
    from repro_torch import kernels

    mlstm_mod = importlib.import_module("repro_torch.kernels.mlstm_chunk")

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in RMSNORM:
            d = shape[-1]
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            scale = torch.randn(d, generator=gen, device="cuda") * 0.1
            weight = (1.0 + scale).to(dtype)
            err = (kernels.rmsnorm(x, scale).float()
                   - kernels.ref.rmsnorm_ref(x, scale).float()).abs().max().item()
            res[f"rmsnorm {'x'.join(map(str, shape))} {dtype}"] = {
                "ms": chip_smoke.time_ms(lambda i: kernels.rmsnorm(x, scale)),
                "library_ms": chip_smoke.time_ms(lambda i: F.rms_norm(x, (d,), weight, 1e-6)),
                "max_abs_err": err, "sha256": digest(kernels.rmsnorm(x, scale))}
            del x
        B, S, H, dk, chunk = MLSTM
        q, k, v = (torch.randn(B, S, H, dk, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        i_pre = torch.randn(B, S, H, generator=gen, device="cuda") - 2.0
        f_pre = torch.randn(B, S, H, generator=gen, device="cuda") + 3.0
        args = (q, k, v, i_pre, f_pre)
        got, final = kernels.mlstm_chunk(*args, chunk=chunk, return_final=True)
        want, wfinal = kernels.ref.mlstm_chunk_ref(*args, chunk=chunk, return_final=True)
        err = max((g - w).abs().max().item()
                  for g, w in zip((got, *final), (want, *wfinal)))
        sha = digest(got, *final)
        del got, final, want, wfinal
        res[f"mlstm_chunk {B}x{S}x{H}x{dk} c{chunk} {dtype}"] = {
            "ms": chip_smoke.time_ms(lambda i: kernels.mlstm_chunk(
                *args, chunk=chunk, return_final=True), iters=5),
            "passes_ms": pass_times(lambda: kernels.mlstm_chunk(*args, chunk=chunk,
                                                                return_final=True)),
            "max_abs_err": err, "sha256": sha}
        del q, k, v, args
        B, S, H, dk, chunk = MLSTM_BWD
        q, k, v = (torch.randn(B, S, H, dk, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        log_i = torch.randn(B, S, H, generator=gen, device="cuda") - 2.0
        log_f = F.logsigmoid(torch.randn(B, S, H, generator=gen, device="cuda") + 3.0)
        dh = torch.randn(B, S, H, dk, generator=gen, device="cuda")
        h, _, (ws, den) = mlstm_mod.mlstm_chunk_fwd(q, k, v, log_i, log_f, chunk=chunk,
                                                    keep=True)
        args = (q, k, v, log_i, log_f, ws, den, h, dh)
        got = kernels.mlstm_chunk_bwd(*args, chunk=chunk)
        want = kernels.ref.mlstm_chunk_bwd_ref(q, k, v, log_i, log_f, dh, chunk=chunk)
        err = max(((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
                  for g, w in zip(got, want))
        sha, fwd_sha = digest(*got), digest(h, den)
        del got, want
        res[f"mlstm_chunk_bwd {B}x{S}x{H}x{dk} c{chunk} {dtype}"] = {
            "ms": chip_smoke.time_ms(lambda i: kernels.mlstm_chunk_bwd(*args, chunk=chunk),
                                     iters=5),
            "passes_ms": pass_times(lambda: kernels.mlstm_chunk_bwd(*args, chunk=chunk)),
            "max_err_over_largest": err, "sha256": sha, "forward_sha256": fwd_sha}
        del args, q, k, v, h, ws, den, dh
    return res


def gates(root: str) -> dict:
    """Elements outside the band around the f64 result, kernel and plain,
    for each mLSTM layer of xlstm-125m at 4 layers."""
    sys.path[:0] = [os.path.join(root, "src"), root]
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.convert import cast_params
    from repro_torch.models import ModelOptions, forward, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("xlstm-125m").with_(num_layers=4)
    params32 = init_params(cfg, seed=0, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 4096))).to("cuda")
    seen = []
    for dtype in ("bfloat16", "float32"):
        params = cast_params(params32, torch.bfloat16) if dtype == "bfloat16" else params32
        undo = chip_smoke.capture(kernels, "mlstm_chunk", seen)
        try:
            with torch.no_grad():
                forward(params, cfg, tokens, opts=ModelOptions(compute_dtype=dtype))
        finally:
            undo()
        del params
    del params32
    rows = []
    for args, kw in seen:
        got = kernels.mlstm_chunk(*args, **kw)
        want = kernels.ref.mlstm_chunk_ref(*args, **kw)
        exact = kernels.ref.mlstm_chunk_ref(*(a.double() for a in args), **kw)
        band = chip_smoke.MLSTM_ATOL + chip_smoke.MLSTM_RTOL * exact.abs()
        off = {name: ((x.double() - exact).abs() > band).sum().item()
               for name, x in (("kernel", got), ("plain", want))}
        rows.append({"shape": list(args[0].shape), "dtype": str(args[0].dtype),
                     "of": got.numel(), **off,
                     "kernel_vs_plain_max_abs": (got - want).abs().max().item(),
                     "held": bool(torch.isfinite(got).all()) and off["kernel"] <= off["plain"]})
        del got, want, exact, band
    return {"xlstm-125m 4 layers": rows}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] in ("--one", "--one-gates"):
        run = measure if sys.argv[1] == "--one" else gates
        print(json.dumps({"root": sys.argv[2], **run(sys.argv[2])}), flush=True)
        return 0
    mode, roots = "--one", sys.argv[1:]
    if roots[:1] == ["--gates"]:
        mode, roots = "--one-gates", roots[1:]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_norm_mlstm: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for root in roots or [HERE]:
        subprocess.run([sys.executable, __file__, mode, os.path.abspath(root)],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
