#!/usr/bin/env python3
"""Time the port's flash-attention backward kernel on one NVIDIA GPU.

    python3 scripts/bench_flash_bwd.py [--f32] [ROOT ...]

For each ROOT (a checkout of this repository; by default the one holding
this script), in the order given, builds that checkout's kernels and times
``repro_torch.kernels.flash_attention_bwd`` (bf16, causal) at gemma-2b's
shapes (1 and 2 x 1024 tokens, 8 heads, MQA, head dim 256) and qwen3-14b's
(2048 tokens, 40 heads, 8 KV heads, head dim 128), with the largest error
of dq, dk, dv against the plain version relative to its largest entry.
With ``--f32`` the inputs are f32 and the shapes gemma-2b's (1 x 1024),
qwen3-14b's, the trainer PE's (2 x 512, 8 heads, MQA, head dim 256) and
recurrentgemma-9b's windowed (4096 tokens, 16 heads, MQA, head dim 256,
window 2048); each row also says whether dq, dk, dv meet the f32
tolerance (5e-5 + 5e-4 rel) and which variant ran (``route``, where the
checkout has it).
Each ROOT runs in its own process, so two versions of the kernel can be
compared on one card in one call: give them in turns (A B B A).  Prints
the card's name and power limit, then one JSON line per ROOT.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1, 1024, 8, 1, 256, 0), (2, 1024, 8, 1, 256, 0), (1, 2048, 40, 8, 128, 0))
F32_SHAPES = ((1, 1024, 8, 1, 256, 0), (1, 2048, 40, 8, 128, 0), (2, 512, 8, 1, 256, 0),
              (1, 4096, 16, 1, 256, 2048))


def measure(root: str, f32: bool = False) -> dict:
    """Build and time ``root``'s kernel in this process."""
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch

    import chip_smoke
    from repro_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtype = torch.float32 if f32 else torch.bfloat16
    res = {}
    for B, S, H, KV, D, window in F32_SHAPES if f32 else SHAPES:
        q, do = (torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        out, lse = kernels.flash_attention(q, k, v, return_lse=True, window=window)
        args = (q, k, v, out, lse, do)
        got = kernels.flash_attention_bwd(*args, window=window)
        want = kernels.ref.flash_attention_bwd_ref(*args, True, window)
        row = {"rel_err": max(((g.float() - w.float()).abs().max()
                               / w.float().abs().max()).item() for g, w in zip(got, want))}
        if f32:
            row["within_f32_tol"] = all(
                bool(((g - w).abs() <= chip_smoke.BWD_F32_ATOL
                      + chip_smoke.BWD_F32_RTOL * w.abs()).all()) for g, w in zip(got, want))
            pick = getattr(kernels, "flash_route", None)  # older checkouts have none
            row["route"] = pick(q, k, v, do, backward=True) if pick else "no route query"
        del got, want
        row["ms"] = chip_smoke.time_ms(lambda i: kernels.flash_attention_bwd(
            *args, window=window), iters=10 if S * S * H <= 2**24 else 2)
        res[f"{B}x{S}x{H}x{KV}x{D} w{window}"] = row
        del q, k, v, do, out, lse, args
    return res


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        f32 = sys.argv[3] == "f32"
        print(json.dumps({"root": sys.argv[2], "dtype": "float32" if f32 else "bfloat16",
                          **measure(sys.argv[2], f32)}), flush=True)
        return 0
    roots = sys.argv[1:]
    dtype = "bf16"
    if roots[:1] == ["--f32"]:
        dtype, roots = "f32", roots[1:]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_flash_bwd: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for root in roots or [HERE]:
        subprocess.run([sys.executable, __file__, "--one", os.path.abspath(root), dtype],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
