#!/usr/bin/env python3
"""Time the port's flash-attention backward kernel on one NVIDIA GPU.

    python3 scripts/bench_flash_bwd.py [ROOT ...]

For each ROOT (a checkout of this repository; by default the one holding
this script), in the order given, builds that checkout's kernels and times
``repro_torch.kernels.flash_attention_bwd`` (bf16, causal) at gemma-2b's
shapes (1 and 2 x 1024 tokens, 8 heads, MQA, head dim 256) and qwen3-14b's
(2048 tokens, 40 heads, 8 KV heads, head dim 128), with the largest error
of dq, dk, dv against the plain version relative to its largest entry.
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
SHAPES = ((1, 1024, 8, 1, 256), (2, 1024, 8, 1, 256), (1, 2048, 40, 8, 128))


def measure(root: str) -> dict:
    """Build and time ``root``'s kernel in this process."""
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch

    import chip_smoke
    from repro_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for B, S, H, KV, D in SHAPES:
        q, do = (torch.randn(B, S, H, D, generator=gen, device="cuda").bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(B, S, KV, D, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        out, lse = kernels.flash_attention(q, k, v, return_lse=True)
        args = (q, k, v, out, lse, do)
        got = kernels.flash_attention_bwd(*args)
        want = kernels.ref.flash_attention_bwd_ref(*args)
        rel = max(((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
                  for g, w in zip(got, want))
        ms = chip_smoke.time_ms(lambda i: kernels.flash_attention_bwd(*args), iters=10)
        res[f"{B}x{S}x{H}x{KV}x{D}"] = {"ms": ms, "rel_err": rel}
    return res


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps({"root": sys.argv[2], **measure(sys.argv[2])}), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_flash_bwd: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for root in sys.argv[1:] or [HERE]:
        subprocess.run([sys.executable, __file__, "--one", os.path.abspath(root)],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
