"""Data-parallel training under the platform with the PyTorch port's
trainer PE, consistent-region checkpointing and a mid-run pod kill.

The port's counterpart of ``examples/fault_tolerant_training.py``.  The
platform is the JAX package's ``repro.platform`` (the control plane, which
runs no model); the wiring, as ``tests/test_torch_platform.py`` makes it,
stays here: a ``PERuntime`` whose trainer PEs run
``repro_torch.platform.run_trainer`` is set over
``repro.platform.cluster.PERuntime``, and the port's ``CheckpointStore``
over the one the ``Platform`` builds.  A killed trainer reloads the last
committed checkpoint and replays from its step.  The trainers compute on
the CPU unless ``--device cuda`` is given.

Run:  PYTHONPATH=src python examples/torch_fault_tolerant_training.py --small
      PYTHONPATH=src python examples/torch_fault_tolerant_training.py --steps 200
"""

import argparse
import time


def wire_port() -> None:
    """Make the platform's trainer PEs and checkpoints the port's."""
    import repro.platform
    from repro.platform import cluster
    from repro_torch.ckpt import CheckpointStore
    from repro_torch.platform import run_trainer

    class TorchTrainerRuntime(cluster.PERuntime):
        def _run_trainer(self) -> None:
            run_trainer(self)

    cluster.PERuntime = TorchTrainerRuntime
    repro.platform.CheckpointStore = CheckpointStore


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch-per-shard", type=int, default=2)
    ap.add_argument("--width", type=int, default=2)
    ap.add_argument("--interval", type=int, default=25)
    ap.add_argument("--device", default="cpu", help="cpu (the default) or cuda")
    ap.add_argument("--small", action="store_true",
                    help="reduced same-family config, a short demo")
    ap.add_argument("--kill-at", type=int, default=0,
                    help="kill a trainer once this step commits (0=midpoint)")
    args = ap.parse_args()

    wire_port()
    from repro.platform import Platform, crds

    arch: object = args.arch  # a name: the trainer PE takes its reduced config
    if args.small:
        args.steps = min(args.steps, 40)
        args.interval = min(args.interval, 10)
    else:
        from repro_torch.configs import get_config

        arch = get_config(args.arch)
        print(f"training {args.arch}: {arch.param_count() / 1e6:.0f}M params, "
              f"{args.steps} steps, seq {args.seq}, dp={args.width}")

    kill_at = args.kill_at or (args.interval * max(1, args.steps // args.interval // 2))
    spec = {
        "app": {"type": "train", "arch": arch, "data_parallel": args.width,
                "steps": args.steps, "batch_per_shard": args.batch_per_shard,
                "seq_len": args.seq, "lr": 3e-3, "device": args.device},
        "consistentRegion": {"name": "dp", "interval": args.interval},
    }

    p = Platform(num_nodes=4)
    try:
        t0 = time.time()
        p.submit("train", spec)
        assert p.wait_submitted("train", 60)
        assert p.wait_full_health("train", 120)
        print(f"[{time.time() - t0:6.1f}s] full health; training...")

        killed = False
        last_step = -1
        losses = []
        while True:
            st = p.rest.get_cr_state("train", "dp") or {}
            committed = st.get("lastCommitted", -1)
            ms = p.metrics("train")
            steps = [m.get("step", 0) for m in ms.values()]
            loss = [m.get("loss") for m in ms.values() if "loss" in m]
            if steps and max(steps) != last_step:
                last_step = max(steps)
                if loss:
                    losses.append((last_step, min(loss)))
                print(f"[{time.time() - t0:6.1f}s] step {last_step:4d} "
                      f"loss {min(loss) if loss else float('nan'):8.4f} "
                      f"committed@{committed}")
            if not killed and committed >= kill_at:
                trainer = [x.spec["peId"] for x in p.store.list(crds.PE, "default")
                           if "trainer" in str(x.spec.get("operators"))][0]
                print(f"[{time.time() - t0:6.1f}s] !! killing trainer pe-{trainer} "
                      f"(committed checkpoint @ {committed})")
                p.kill_pod("train", trainer)
                killed = True
            if committed >= args.steps or (steps and max(steps) >= args.steps
                                           and committed >= args.steps - args.interval):
                break
            time.sleep(0.5)
        print(f"[{time.time() - t0:6.1f}s] done: committed@"
              f"{p.rest.get_cr_state('train', 'dp')['lastCommitted']}")
        if len(losses) >= 2:
            print(f"loss: first={losses[0][1]:.4f} last={losses[-1][1]:.4f} "
                  f"({'decreased' if losses[-1][1] < losses[0][1] else 'FLAT'})")
    finally:
        p.delete_job("train")
        p.wait_terminated("train", 30)
        p.shutdown()


if __name__ == "__main__":
    main()
