"""Serving launcher: batched-request serving of an assigned arch through
the fixed-slot engine (prefill-by-decode admission, greedy sampling).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --smoke \\
      --requests 8 --slots 4 --max-new 16

Ported from ``repro/launch/serve.py``; it takes any of the ten archs (the
frontend families serve tokens only, as the reference's engines do).  It
runs on CUDA in bf16;
``--device cpu`` runs the plain path in f32 on the CPU.  Weights are random,
drawn from a torch generator, so the tokens differ from the JAX launcher's.
``--platform`` (serving inside the control plane) is not ported: the control
plane is ``repro.platform``, which imports JAX, and the card's machine has
none; ``examples/torch_serving_engine.py`` runs the port's two engines, and
``examples/torch_fault_tolerant_training.py`` wires the port's trainer PE
into that platform on a machine that has both.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="a reduced same-family config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--platform", action="store_true")
    args = ap.parse_args(argv)

    if args.platform:
        raise NotImplementedError(
            "--platform (serving inside the control plane) is not ported: the "
            "control plane is repro.platform, which imports JAX, and the card's "
            "machine has none; see examples/torch_serving_engine.py for the "
            "port's engines and examples/torch_fault_tolerant_training.py for "
            "its trainer PE under that platform")

    from ..configs import get_config, reduced_config
    from ..device import resolve_device
    from ..models import ModelOptions, init_params
    from ..serve import Request, ServeEngine

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.smoke else get_config(args.arch)
    opts = ModelOptions(compute_dtype="float32" if device.type == "cpu"
                        else "bfloat16")
    print(f"loading {cfg.name}: {cfg.param_count() / 1e6:.0f}M params on {device}")
    engine = ServeEngine(cfg, init_params(cfg, seed=0, device=device),
                         num_slots=args.slots, max_len=args.max_len,
                         opts=opts, device=device)
    for rid in range(args.requests):
        prompt = [1 + rid % 13, 7, (rid * 31) % cfg.vocab_size]
        engine.submit(Request(rid=rid, prompt=prompt,
                              max_new_tokens=args.max_new))
    t0 = time.time()
    done = engine.run_until_drained()
    dt = time.time() - t0
    toks = sum(len(r.generated) for r in done)
    print(f"{len(done)} requests, {toks} tokens, {dt:.1f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s)")


if __name__ == "__main__":
    main()
