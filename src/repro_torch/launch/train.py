"""Training launcher: run a training job directly on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --steps 8 --batch 2 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --smoke \\
      --steps 2 --device cpu

Ported from the direct mode of ``repro/launch/train.py``: f32 parameters
and AdamW moments, the lcg token stream from seed 0, remat unless
``--smoke``; a config with a frontend (musicgen-large, internvl2-26b)
also draws its ``frontend_embeds`` from the stream, which the reference's
direct mode leaves out.  It runs on CUDA in bf16; ``--device cpu`` runs
the plain path in f32 on the CPU.  As in the reference, the direct mode builds its
``TrainConfig`` without ``--lr``, so the optimizer keeps its default rate.
``--mesh`` (sharded training) comes with the port's multi-GPU slice and
``--platform`` (a job on the control plane) with its launcher slice; the
trainer PE that such a job runs is ``repro_torch.platform.run_trainer``.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> list:
    """Run the steps; print and return one record per step: ``step``,
    ``loss``, ``grad_norm``, ``wall_s`` (host clock around the step, which
    ends in reading the loss)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3,
                    help="taken but not used in direct mode, as in the reference")
    ap.add_argument("--mesh", default=None, help="e.g. 2,2,2 for pod,data,model")
    ap.add_argument("--platform", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.platform:
        raise NotImplementedError(
            "--platform (a training job on the control plane) comes with the "
            "port's launcher slice; the trainer PE it runs is "
            "repro_torch.platform.run_trainer")
    if args.mesh:
        raise NotImplementedError(
            "--mesh (sharded training) comes with the port's multi-GPU slice")

    from ..configs import get_config, reduced_config
    from ..data import StreamSource
    from ..device import resolve_device
    from ..models import ModelOptions
    from ..train import TrainConfig, init_train_state, make_train_step

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.smoke else get_config(args.arch)
    opts = ModelOptions(compute_dtype="float32" if device.type == "cpu"
                        else "bfloat16")
    tcfg = TrainConfig(accum_steps=args.accum, remat=not args.smoke)
    src = StreamSource(vocab_size=cfg.vocab_size, batch=args.batch,
                       seq_len=args.seq, seed=0, frontend_len=cfg.frontend_len,
                       frontend_dim=cfg.frontend_dim)
    state = init_train_state(cfg, tcfg, seed=0, device=device)
    step = make_train_step(cfg, tcfg, opts)
    print(f"training {cfg.name}: {cfg.param_count() / 1e6:.0f}M params on "
          f"{device}, batch {args.batch} x {args.seq} tokens, "
          f"{opts.compute_dtype} compute, remat {tcfg.remat}")

    records = []
    for i in range(args.steps):
        batch = src.batch_at(i)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        wall = time.perf_counter() - t0
        print(f"step {i:4d} loss {loss:9.4f} gnorm {gnorm:8.3f} ({wall:.2f}s)")
        records.append({"step": i, "loss": loss, "grad_norm": gnorm,
                        "wall_s": wall})
    return records


if __name__ == "__main__":
    main()
