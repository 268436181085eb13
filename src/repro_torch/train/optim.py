"""AdamW over parameter trees, with global-norm clipping, ported from
``repro/train/optim.py``.

Written out by hand rather than ``torch.optim.AdamW``, whose order of
operations differs: decoupled weight decay sits inside the step direction,
after bias correction, and ``eps`` is added to ``sqrt(vhat)``.  Where the
reference returns new trees, the port updates the tensors in place under
``torch.no_grad()`` (the moments and parameters of a full-size model are
tens of GB) and returns the same trees.  Plain torch ops, one leaf at a
time, so temporaries stay the size of one leaf.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..convert import map_params


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


def leaves(tree) -> list:
    """The tensors of a nested dict/list tree, in a fixed order."""
    out = []
    map_params(lambda _k, t: out.append(t), tree)
    return out


def init_opt_state(params) -> dict:
    """Zero f32 moments shaped like the parameters."""
    def zeros():
        return map_params(lambda _k, p: torch.zeros_like(p, dtype=torch.float32,
                                                         requires_grad=False),
                          params)
    return {"m": zeros(), "v": zeros()}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in f32."""
    return torch.sqrt(sum(torch.linalg.vector_norm(x.float()).square()
                          for x in leaves(tree)))


def clip_by_global_norm(grads, clip: float, norm=None):
    """Scale ``grads`` in place so their global norm (``norm``, by default
    ``global_norm(grads)``) is at most ``clip``.  Returns (grads, the norm
    before clipping)."""
    if norm is None:
        norm = global_norm(grads)
    factor = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
    with torch.no_grad():
        for g in leaves(grads):
            g.mul_(factor.to(g.dtype))
    return grads, norm


def lr_schedule(cfg: OptimizerConfig, step) -> float:
    """Linear warmup to ``cfg.lr`` over ``warmup_steps``; ``step`` counts
    from 0."""
    return cfg.lr * min(1.0, (int(step) + 1) / max(cfg.warmup_steps, 1))


def adamw_update(cfg: OptimizerConfig, params, grads, opt_state, step):
    """One AdamW step at ``step`` (counting from 0), in place.  Returns
    (params, opt_state)."""
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = float(int(step) + 1)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    with torch.no_grad():
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(opt_state["m"]), leaves(opt_state["v"])):
            g = g.float()
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = torch.div(v, bc2).sqrt_().add_(cfg.eps)
            step_dir = torch.div(m, bc1).div_(denom)
            del denom
            step_dir.add_(p.float(), alpha=cfg.weight_decay)
            p.sub_(step_dir.to(p.dtype), alpha=lr)
    return params, opt_state
