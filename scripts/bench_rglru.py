#!/usr/bin/env python3
"""Time the port's RG-LRU scan kernel on one NVIDIA GPU.

    python3 scripts/bench_rglru.py [ROOT ...]

For each ROOT (a checkout of this repository; by default the one holding
this script), in the order given, builds that checkout's kernels and times
``repro_torch.kernels.rglru_scan`` in f32 at recurrentgemma-9b's prefill
shape (1, 4096, 4096), at (4, 1024, 4096), (1, 16384, 4096) and at a
sequence off the stages, (1, 1000, 4096), on the inputs of
``chip_smoke.check_rglru`` (log_a = -0.2 |N|, b ~ N, seed 0).  For each
shape it gives the bytes bound (each input read once, h written once, at
3.35 TB/s), the time of ``torch.add`` over the same bytes (two f32 reads,
one write: what the card's memory gives such a stream), the largest error
against the plain version and a SHA-256 of the output's bytes: two versions
that compute every step the same way give the same digest.  Each ROOT runs
in its own process, so two versions can be compared on one card in one
call: give them in turns (A B B A).  Prints the card's name and power limit,
then one JSON line per ROOT.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1, 4096, 4096), (4, 1024, 4096), (1, 16384, 4096), (1, 1000, 4096))
HBM_BYTES_PER_S = 3.35e12


def _inputs(torch, shape):
    gen = torch.Generator(device="cuda").manual_seed(0)
    log_a = -(torch.randn(shape, generator=gen, device="cuda").abs() * 0.2)
    b = torch.randn(shape, generator=gen, device="cuda")
    return log_a, b


def measure(root: str) -> dict:
    """Build and time ``root``'s kernel in this process."""
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch

    import chip_smoke
    from repro_torch import kernels

    res = {}
    for shape in SHAPES:
        log_a, b = _inputs(torch, shape)
        got = kernels.rglru_scan(log_a, b)
        want = kernels.ref.rglru_scan_ref(log_a, b)
        again = kernels.rglru_scan(log_a, b)
        err = (got - want).abs().max().item()
        res["x".join(map(str, shape))] = {
            "ms": chip_smoke.time_ms(lambda i: kernels.rglru_scan(log_a, b), iters=10),
            "bound_ms": 3 * log_a.numel() * 4 / HBM_BYTES_PER_S * 1e3,
            # the same bytes moved by PyTorch's elementwise add: two reads,
            # one write, what the card's memory gives such a stream
            "same_bytes_add_ms": chip_smoke.time_ms(
                lambda i: torch.add(log_a, b, out=want), iters=10),
            "max_abs_err": err,
            "sha256": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest(),
            "repeat_equal": bool(torch.equal(got, again))}
        del log_a, b, got, want, again
    return res


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps({"root": sys.argv[2], **measure(sys.argv[2])}), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_rglru: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for root in sys.argv[1:] or [HERE]:
        subprocess.run([sys.executable, __file__, "--one", os.path.abspath(root)],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
