"""Phase 17's tensor-parallel sub-phase of ``chip_smoke.py`` alone, then
phase 18's check of its jobs' card counts against their fake counts: the
kernels built from the checkout, a (1, 1, 2) world of two processes on one
card over gloo running the jobs of ``chip_smoke.TP_JOBS`` and
``TP_SERVE_JOBS`` (every one, or those named), each held to the one-device
f32 steps.

    python3 scripts/chip_tp_phase.py [--seed 0]
    python3 scripts/chip_tp_phase.py --train gemma-2b+sp,deepseek-moe-16b+sp \
        --serve gemma-2b+sp,qwen3-14b+cache-seq   # the reference's mesh options alone

Needs one CUDA card; prints the phase's log and its wall, and exits
non-zero if a check fails."""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train", default=",".join(chip_smoke.TP_JOBS),
                    help="train jobs of chip_smoke.TP_JOBS, comma-separated ('' for none)")
    ap.add_argument("--serve", default=",".join(chip_smoke.TP_SERVE_JOBS),
                    help="serving jobs of chip_smoke.TP_SERVE_JOBS, comma-separated")
    args = ap.parse_args()
    train, serve = (tuple(j for j in a.split(",") if j) for a in (args.train, args.serve))
    unknown = set(train) - set(chip_smoke.TP_JOBS) | set(serve) - set(chip_smoke.TP_SERVE_JOBS)
    if unknown:
        ap.error(f"unknown jobs {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_tp_phase: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.smi_line()
    chip_smoke.log(f"== build: {chip_smoke._build.build()} ({smi})")
    tp = chip_smoke.tp_phase(args.seed, smi, train, serve)
    chip_smoke.tp_counts_phase(tp)
    chip_smoke.log(f"== wall: {time.perf_counter() - t0:.1f} s")
    chip_smoke.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
