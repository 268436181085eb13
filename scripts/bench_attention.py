#!/usr/bin/env python3
"""Time the port's flash-attention forward and dense decode kernels on one
NVIDIA GPU.

    python3 scripts/bench_attention.py [--f32] [ROOT ...]

For each ROOT (a checkout of this repository; by default the one holding
this script), in the order given, builds that checkout's kernels and times,
in bf16:

- ``repro_torch.kernels.flash_attention`` with its LSE, causal at gemma-2b's
  (1, 1024, 8, 1, 256) and qwen3-14b's (1, 2048, 40, 8, 128), and windowed
  at recurrentgemma-9b's (1, 4096, 16, 1, 256), window 2048;
- ``repro_torch.kernels.decode_attention`` at (B 8, Smax 1024) of gemma-2b
  and qwen3-14b, and at the serving paths' shapes: the fixed-slot serve
  (B 4, Smax 256), decode after a 1024-token prefill (B 1, Smax 1024) and
  recurrentgemma-9b's local ring (B 1, Smax 2048, 16 heads), each from as
  many copies of the cache as exceed the L2 cache together;
- ``repro_torch.kernels.paged_decode_attention`` at its two shapes (it shares
  the combine pass with the dense kernel), from as many copies of the pools;

with the largest error against the plain version, and SDPA on the same
inputs (causal, band mask or length mask) as the yardstick.  Every decode
row also carries a SHA-256 of its output (``sha256``, the first 16 hex
digits) and the device time of each of its kernels in one call
(``device_ms``, split pass and combine, from ``torch.profiler``).  Each ROOT
runs in its own process, so two versions can be compared on one card in
one call: give them in turns (A B B A).  Prints the card's name and power
limit, then one JSON line per ROOT.  With ``--f32`` it times f32 inputs
instead: the flash forward at gemma-2b's, qwen3-14b's, the trainer PE's
(2, 512, 8, 1, 256) and recurrentgemma-9b's windowed shapes, naming the
variant that ran (``route``, where the checkout has it), and the dense and
paged decode at the shapes above; and it adds, untimed, the digests of the
bf16 decode outputs at the same shapes (``bf16 ...`` rows), so that one
``--f32 A B B A`` call shows both the f32 times and whether the bf16
outputs kept their bits.

    python3 scripts/bench_attention.py --gates [ROOT ...]

runs instead, for each ROOT, the per-layer precision gates of the flash
forward at full width with random weights (seed 0): gemma-2b at 2 layers
over 1024 tokens and recurrentgemma-9b's windowed layer at 3 layers over
4096, each layer's bf16 kernel output on the q, k, v its forward hands it
held to the correctly rounded f64 result, with no more elements off it
than the plain version leaves (``chip_smoke.check_forward_flash``'s gate).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLASH = ((1, 1024, 8, 1, 256, 0), (1, 2048, 40, 8, 128, 0), (1, 4096, 16, 1, 256, 2048))
F32_FLASH = ((1, 1024, 8, 1, 256, 0), (1, 2048, 40, 8, 128, 0), (2, 512, 8, 1, 256, 0),
             (1, 4096, 16, 1, 256, 2048))
DECODE = ((8, 8, 1, 256, 1024), (8, 40, 8, 128, 1024), (4, 8, 1, 256, 256),
          (1, 8, 1, 256, 1024), (1, 16, 1, 256, 2048))
PAGED = ((8, 8, 1, 256), (8, 40, 8, 128))  # 16-token pages, lengths up to 1024


def measure(root: str, f32: bool = False) -> dict:
    """Build and time ``root``'s kernels in this process."""
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.float32 if f32 else torch.bfloat16
    res = {}
    for B, S, H, KV, D, window in F32_FLASH if f32 else FLASH:
        q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(bf)
        k, v = (torch.randn(B, S, KV, D, generator=gen, device="cuda").to(bf)
                for _ in range(2))
        pick = getattr(kernels, "flash_route", None)  # older checkouts have none
        route = pick(q, k, v) if pick else "no route query"
        got, lse = kernels.flash_attention(q, k, v, return_lse=True, window=window)
        want = kernels.ref.causal_attention_ref(q, k, v, window=window)
        want_lse = kernels.ref.attention_lse_ref(q, k, window=window)
        err = max((got.float() - want.float()).abs().max().item(),
                  (lse - want_lse).abs().max().item())
        del got, lse, want, want_lse
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        i = torch.arange(S, device="cuda")
        band = ((i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
                if window else None)
        res[f"flash {B}x{S}x{H}x{KV}x{D} w{window}"] = {
            "ms": chip_smoke.time_ms(lambda i: kernels.flash_attention(
                q, k, v, return_lse=True, window=window), iters=5),
            "sdpa_ms": chip_smoke.time_ms(lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band, is_causal=not window, enable_gqa=True),
                iters=5),
            "max_abs_err": err, "route": route}
        del q, k, v, qt, kt, vt
    res.update(decode_rows(gen, bf, timed=True))
    if f32:  # the bf16 outputs' digests, from inputs of their own
        res.update({f"bf16 {k}": v for k, v in decode_rows(
            torch.Generator(device="cuda").manual_seed(1), torch.bfloat16,
            timed=False).items()})
    return res


def digest(x) -> str:
    """The first 16 hex digits of a SHA-256 of a tensor's bytes."""
    import torch

    raw = x.contiguous().view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)
    return hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()[:16]


def device_ms(fn, calls: int = 10) -> dict:
    """Device ms a call of each kernel that ``fn`` launches, by kernel name
    (``torch.profiler``; names cut at their argument list)."""
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
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            name = name.split("::")[-1]
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def decode_rows(gen, dtype, timed: bool) -> dict:
    """The dense decode at ``DECODE`` and the paged decode at ``PAGED``
    (16-token pages, lengths up to 1024) in ``dtype``: each output's
    digest and largest error against the plain version; with ``timed``, the
    kernel's and SDPA's times from as many copies of the cache as exceed the
    L2 cache together, and the device time of each kernel of one call."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch import kernels

    res = {}
    es = torch.tensor([], dtype=dtype).element_size()
    for B, H, KV, D, Smax in DECODE:
        lens = [Smax + 1] + [max(1, Smax - (Smax * i) // B) for i in range(1, B)]
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
        kc, vc = (torch.randn(B, Smax, KV, D, generator=gen, device="cuda").to(dtype)
                  for _ in range(2))
        out = kernels.decode_attention(q, kc, vc, lengths)
        row = {"sha256": digest(out), "max_abs_err": (
            out.float() - kernels.ref.decode_attention_ref(q, kc, vc, lengths).float()
        ).abs().max().item()}
        if timed:
            copies = max(1, min(64, math.ceil(2 * chip_smoke.L2_BYTES / (2 * kc.numel() * es))))
            iters = max(20, copies)
            caches = [(kc.clone(), vc.clone()) for _ in range(copies)]
            transposed = [tuple(c.transpose(1, 2).contiguous() for c in pair)
                          for pair in caches]
            mask = (torch.arange(Smax, device="cuda")[None, :]
                    < lengths[:, None])[:, None, None, :]
            row["ms"] = chip_smoke.time_ms(lambda i: kernels.decode_attention(
                q, *caches[i % copies], lengths), iters=iters)
            row["sdpa_ms"] = chip_smoke.time_ms(lambda i: F.scaled_dot_product_attention(
                q[:, :, None, :], *transposed[i % copies], attn_mask=mask, enable_gqa=True),
                iters=iters)
            row["device_ms"] = device_ms(lambda: kernels.decode_attention(q, kc, vc, lengths))
            del caches, transposed
        res[f"decode B{B} H{H} KV{KV} D{D} Smax{Smax}"] = row
    for B, H, KV, D in PAGED:
        q, kp, vp, tables, lengths, lens = chip_smoke.paged_inputs(
            gen, B, H, KV, D, 16, 1024, dtype)
        out = kernels.paged_decode_attention(q, kp, vp, tables, lengths)
        row = {"sha256": digest(out), "max_abs_err": (
            out.float() - kernels.ref.paged_decode_attention_ref(
                q, kp, vp, tables, lengths).float()).abs().max().item()}
        if timed:
            copies = max(1, min(16, math.ceil(2 * chip_smoke.L2_BYTES / (2 * kp.numel() * es))))
            pools = [(kp.clone(), vp.clone()) for _ in range(copies)]
            S = tables.shape[1] * 16
            tab = tables.long()
            gathered = [tuple(p[tab].reshape(B, S, KV, D).transpose(1, 2).contiguous()
                              for p in pool) for pool in pools]
            mask = (torch.arange(S, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
            row["ms"] = chip_smoke.time_ms(lambda i: kernels.paged_decode_attention(
                q, *pools[i % copies], tables, lengths))
            row["sdpa_ms"] = chip_smoke.time_ms(lambda i: F.scaled_dot_product_attention(
                q[:, :, None, :], *gathered[i % copies], attn_mask=mask, enable_gqa=True))
            row["device_ms"] = device_ms(lambda: kernels.paged_decode_attention(
                q, kp, vp, tables, lengths))
            del pools, gathered
        res[f"paged B{B} H{H} KV{KV} D{D}"] = row
    return res


def gates(root: str) -> dict:
    """Elements off the rounded f64 result, kernel and plain, per layer."""
    sys.path[:0] = [os.path.join(root, "src"), root]
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.convert import cast_params
    from repro_torch.models import ModelOptions, forward, init_params, layers

    torch.backends.cuda.matmul.allow_tf32 = False
    opts = ModelOptions(compute_dtype="bfloat16")
    res = {}
    for arch, n, S, seed in (("gemma-2b", 2, 1024, 2), ("recurrentgemma-9b", 3, 4096, 4)):
        cfg = get_config(arch).with_(num_layers=n)
        params = cast_params(init_params(cfg, seed=0, device="cuda"), torch.bfloat16)
        tokens = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (1, S))).to("cuda")
        seen = []
        undo = chip_smoke.capture(layers, "flash_attention_train", seen)
        try:
            with torch.no_grad():
                forward(params, cfg, tokens, opts=opts)
        finally:
            undo()
        del params
        rows = []
        for (q, k, v), kw in seen:
            window = kw.get("window", 0)
            got = kernels.flash_attention(q, k, v, window=window)
            want = kernels.ref.causal_attention_ref(q, k, v, window=window)
            G, D = q.shape[2] // k.shape[2], q.shape[3]
            sc = torch.einsum("bqhd,bkhd->bhqk", q.double(),
                              k.repeat_interleave(G, 2).double()) / math.sqrt(D)
            i = torch.arange(S, device="cuda")
            mask = i[None, :] <= i[:, None]
            if window:
                mask = mask & (i[None, :] > i[:, None] - window)
            p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
            del sc
            exact = torch.einsum("bhqk,bkhd->bqhd", p, v.repeat_interleave(G, 2).double())
            del p
            off = {name: (x != exact.to(q.dtype)).sum().item()
                   for name, x in (("kernel", got), ("plain", want))}
            rows.append({"window": window, "of": got.numel(), **off,
                         "held": bool(torch.isfinite(got).all()) and off["kernel"] <= off["plain"]})
            del exact, got, want
        res[f"{arch} {n} layers"] = rows
        del seen
        torch.cuda.empty_cache()
    return res


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] in ("--one", "--one-gates", "--one-f32"):
        run = {"--one": measure, "--one-gates": gates,
               "--one-f32": lambda root: measure(root, f32=True)}[sys.argv[1]]
        print(json.dumps({"root": sys.argv[2], **run(sys.argv[2])}), flush=True)
        return 0
    mode, roots = "--one", sys.argv[1:]
    if roots[:1] == ["--gates"]:
        mode, roots = "--one-gates", roots[1:]
    elif roots[:1] == ["--f32"]:
        mode, roots = "--one-f32", roots[1:]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_attention: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for root in roots or [HERE]:
        subprocess.run([sys.executable, __file__, mode, os.path.abspath(root)],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
