"""Deterministic, checkpointable streaming data source, ported from
``repro/data/stream.py``.

The source's whole durable state is one integer offset: every batch is a
pure function of ``(seed, offset)``, drawn from a ``torch.Generator``
seeded from both, so a checkpoint records the offset and a replay
recomputes the same batches.  torch's generator cannot give
``jax.random``'s bits: the tokens differ from the reference's for the same
seed, and parity tests feed the reference's batches to both packages.

Two token generators:
- ``random``: iid tokens (throughput runs);
- ``lcg``: a noisy affine next-token process, ``x' = (a*x + c) mod V``
  with iid corruption at rate ``noise``: learnable, so training runs show
  a falling loss.

``batch_specs`` gives a batch's shapes and dtypes as fake tensors, the
dry-run's stand-ins (``repro_torch.launch.cells``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_MIX = 0x9E3779B97F4A7C15  # odd 64-bit constant: distinct offsets, distinct seeds


@dataclass(frozen=True)
class StreamSource:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    mode: str = "lcg"  # "lcg" | "random"
    noise: float = 0.05
    frontend_len: int = 0
    frontend_dim: int = 0

    def batch_at(self, offset: int) -> dict:
        """Pure function of (seed, offset) -> training batch: ``tokens`` and
        ``labels`` (batch, seq_len) int32 on the CPU, labels the next
        tokens (+ ``frontend_embeds`` f32 when the source has a frontend)."""
        gen = torch.Generator().manual_seed((self.seed * _MIX + offset) % 2 ** 63)
        n = self.seq_len + 1
        V = self.vocab_size
        if self.mode == "random":
            toks = torch.randint(0, V, (self.batch, n), generator=gen)
        elif self.mode == "lcg":
            a = 8121 % V or 13
            c = 28411 % V
            x = torch.randint(0, V, (self.batch,), generator=gen)
            chain = [x]
            for _ in range(n - 1):
                x = (a * x + c) % V
                chain.append(x)
            toks = torch.stack(chain, dim=1)
            flip = torch.rand(toks.shape, generator=gen) < self.noise
            rand = torch.randint(0, V, toks.shape, generator=gen)
            toks = torch.where(flip, rand, toks)
        else:
            raise ValueError(f"unknown stream mode {self.mode!r}")
        batch = {"tokens": toks[:, :-1].to(torch.int32),
                 "labels": toks[:, 1:].to(torch.int32)}
        if self.frontend_len:
            batch["frontend_embeds"] = torch.randn(
                (self.batch, self.frontend_len, self.frontend_dim), generator=gen)
        return batch


def batch_specs(vocab_size: int, batch: int, seq_len: int,
                frontend_len: int = 0, frontend_dim: int = 0, *, mode=None) -> dict:
    """A training batch of shapes and dtypes only (fake CPU tensors: nothing
    is drawn or allocated), as ``batch_at`` would return it: ``tokens`` and
    ``labels`` (batch, seq_len) int32, ``frontend_embeds`` (batch,
    frontend_len, frontend_dim) f32 when ``frontend_len``.  ``mode`` is the
    ``FakeTensorMode`` to make them in (that of the state they meet; a new
    one by default).  ``vocab_size`` is taken for the reference's
    signature: a fake tensor holds no ids."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with mode or FakeTensorMode():
        specs = {"tokens": torch.empty((batch, seq_len), dtype=torch.int32),
                 "labels": torch.empty((batch, seq_len), dtype=torch.int32)}
        if frontend_len:
            specs["frontend_embeds"] = torch.empty(
                (batch, frontend_len, frontend_dim), dtype=torch.float32)
    return specs
