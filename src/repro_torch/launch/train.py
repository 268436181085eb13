"""Training launcher: run a training job directly, on one device or on a
mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --steps 8 --batch 2 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --smoke \\
      --steps 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b --smoke \\
      --mesh 2,2,2 --steps 2 --batch 8 --seq 32 --device cpu

Ported from the direct mode of ``repro/launch/train.py``: f32 parameters
and AdamW moments, the lcg token stream from seed 0, remat unless
``--smoke``; a config with a frontend (musicgen-large, internvl2-26b)
also draws its ``frontend_embeds`` from the stream, which the reference's
direct mode leaves out.  It runs on CUDA in bf16; ``--device cpu`` runs
the plain path in f32 on the CPU.  As in the reference, the direct mode builds its
``TrainConfig`` without ``--lr``, so the optimizer keeps its default rate.

``--mesh`` takes the mesh's shape over the last of the axes ``(pod, data,
model)`` (``repro_torch.launch.mesh``) and runs the sharded train step
with the reference's activation rules; every rank draws the same seeded
state and keeps its shard.  Under torchrun (``RANK``, ``WORLD_SIZE`` set)
each process joins that world; otherwise the launcher starts the world
itself, one process per rank on a local port (gloo on the CPU, NCCL on
CUDA, one card per rank), or runs a world of one rank in its own process.
Rank 0 prints the per-step lines.  ``--platform`` (a job on the control
plane) is not ported: the control plane is ``repro.platform``, which imports
JAX, and the card's machine has none.  The trainer PE that such a job runs
is ``repro_torch.platform.run_trainer``;
``examples/torch_fault_tolerant_training.py`` wires it into that platform
on a machine that has both.
"""

from __future__ import annotations

import argparse
import math
import os
import time


def main(argv=None) -> list:
    """Run the steps; print and return one record per step: ``step``,
    ``loss``, ``grad_norm``, ``wall_s`` (host clock around the step, which
    ends in reading the loss).  A world that the launcher starts returns
    rank 0's records."""
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
            "--platform (a training job on the control plane) is not ported: the "
            "control plane is repro.platform, which imports JAX, and the card's "
            "machine has none; the trainer PE it runs is "
            "repro_torch.platform.run_trainer, which "
            "examples/torch_fault_tolerant_training.py wires into that platform")
    from ..device import resolve_device

    device = resolve_device(args.device)
    if not args.mesh:
        return _train(args, None, device)
    from .mesh import make_mesh

    shape = tuple(int(x) for x in args.mesh.split(","))
    if math.prod(shape) > 1 and "RANK" not in os.environ:
        return _start_world(argv, math.prod(shape), device)
    mesh = make_mesh(shape, device=device)
    try:
        return _train(args, mesh, mesh.device)
    finally:
        mesh.close()


def _start_world(argv, world: int, device) -> list:
    """Run ``main(argv)`` in one process per rank of a new local world and
    return rank 0's records; a rank that fails ends the others."""
    import torch.multiprocessing as mp

    from .mesh import free_port

    results = mp.get_context("spawn").SimpleQueue()
    ranks = mp.start_processes(_rank_main, args=(argv, world, free_port(), results),
                               nprocs=world, join=False, start_method="spawn")
    records = None
    # rank 0 cannot exit before its records leave the pipe: read while joining
    while not ranks.join(timeout=1):
        if records is None and not results.empty():
            records = results.get()
    return records if records is not None else results.get()


def _rank_main(rank: int, argv, world: int, port: int, results) -> None:
    import torch

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    records = main(argv)
    if rank == 0:
        results.put(records)


def _train(args, mesh, device) -> list:
    from ..configs import get_config, reduced_config
    from ..data import StreamSource
    from ..models import ModelOptions
    from ..sharding.ctx import activation_rules
    from ..train import TrainConfig, init_train_state, make_train_step

    cfg = reduced_config(args.arch) if args.smoke else get_config(args.arch)
    opts = ModelOptions(compute_dtype="float32" if device.type == "cpu"
                        else "bfloat16")
    tcfg = TrainConfig(accum_steps=args.accum, remat=not args.smoke)
    src = StreamSource(vocab_size=cfg.vocab_size, batch=args.batch,
                       seq_len=args.seq, seed=0, frontend_len=cfg.frontend_len,
                       frontend_dim=cfg.frontend_dim)
    state = init_train_state(cfg, tcfg, seed=0, device=device, mesh=mesh)
    step = make_train_step(cfg, tcfg, opts, mesh=mesh,
                           act_rules=None if mesh is None else activation_rules())
    say = print if mesh is None or mesh.rank == 0 else (lambda *_a: None)
    say(f"training {cfg.name}: {cfg.param_count() / 1e6:.0f}M params on "
        f"{device}" + ("" if mesh is None else f", mesh {mesh.shape}") +
        f", batch {args.batch} x {args.seq} tokens, "
        f"{opts.compute_dtype} compute, remat {tcfg.remat}")

    records = []
    for i in range(args.steps):
        batch = src.batch_at(i)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        wall = time.perf_counter() - t0
        say(f"step {i:4d} loss {loss:9.4f} gnorm {gnorm:8.3f} ({wall:.2f}s)")
        records.append({"step": i, "loss": loss, "grad_norm": gnorm,
                        "wall_s": wall})
    return records


if __name__ == "__main__":
    main()
