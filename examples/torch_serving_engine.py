"""Continuous-batching serving with the PyTorch port's two engines.

The port's counterpart of ``examples/serving_engine.py``: a reduced
recurrentgemma-9b (RG-LRU + local attention) through the fixed-slot
``ServeEngine``, then a reduced gemma-2b through the ``PagedServeEngine``
(block-pool KV cache, chunked prefill inside the decode tick, prefix reuse
with copy-on-write on divergence).  Weights are random, drawn from a torch
generator.  On the CPU the wrappers run their plain versions in f32; with
``--device cuda`` the same engines run the CUDA kernels in bf16.

Run:  PYTHONPATH=src python examples/torch_serving_engine.py
      PYTHONPATH=src python examples/torch_serving_engine.py --device cuda
"""

import argparse
import time


def run(engine, requests, label: str) -> None:
    from repro_torch.serve import Request

    for rid, prompt in enumerate(requests):
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=12))
    t0 = time.time()
    done = engine.run_until_drained(max_ticks=500)
    dt = time.time() - t0
    total_tokens = sum(len(r.generated) for r in done)
    print(f"[{label}] {len(done)} requests, {total_tokens} tokens in "
          f"{dt:.1f}s ({total_tokens / dt:.1f} tok/s batched greedy decode)")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"  request {r.rid}: {r.generated}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu", help="cpu (the default) or cuda")
    args = ap.parse_args()

    from repro_torch.configs import reduced_config
    from repro_torch.device import resolve_device
    from repro_torch.models import ModelOptions, init_params
    from repro_torch.serve import PagedServeEngine, ServeEngine

    device = resolve_device(args.device)
    opts = ModelOptions(compute_dtype="float32" if device.type == "cpu" else "bfloat16")

    # hybrid (recurrent + local attn) model through the fixed-slot engine
    cfg = reduced_config("recurrentgemma-9b")
    print(f"serving {cfg.name} on {device}: {cfg.param_count() / 1e6:.1f}M params, "
          f"pattern {cfg.block_pattern}")
    engine = ServeEngine(cfg, init_params(cfg, seed=0, device=device), num_slots=4,
                         max_len=128, opts=opts, device=device)
    run(engine, [[1 + rid, 7, 42, (rid * 13) % cfg.vocab_size] for rid in range(8)],
        "fixed-slot")

    # pure-attention model through the paged engine: shared prompt prefixes
    # hit the block-granular prefix cache, divergence is copy-on-write
    cfg = reduced_config("gemma-2b")
    print(f"\nserving {cfg.name} paged on {device}: {cfg.param_count() / 1e6:.1f}M params")
    # max_active=2: later requests admit after earlier prompts committed
    # their blocks, so the shared prefix is served from the cache
    engine = PagedServeEngine(cfg, init_params(cfg, seed=0, device=device), num_blocks=48,
                              block_size=8, max_active=2, prefill_chunk=8, opts=opts,
                              device=device)
    shared = [7, 7, 42, 42, 11, 11, 3, 3]  # common prefix across requests
    run(engine, [shared + [100 + rid] for rid in range(8)], "paged")
    m = engine.metrics()
    print(f"  pool: {m['blocksFree']}/{m['blocksTotal']} blocks free, "
          f"{m['blocksCached']} cached; prefix hit rate "
          f"{m['prefixHitRate']:.0%}; {m['cowCopies']} CoW copies")


if __name__ == "__main__":
    main()
