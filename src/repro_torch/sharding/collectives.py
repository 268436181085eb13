"""Collectives of the mesh train step over ``torch.distributed`` groups.

Every sum over ranks is taken in rank order from gathered copies, as the
platform's collective (``allreduce_mean``) sums its contributions, so a
rerun gives the same bits whatever the transport's reduction order.  A
group is ``None`` where one rank makes it up: then nothing is sent and
nothing is copied.  A group of an abstract mesh (``launch.mesh.
AbstractGroup``) sends nothing either: a gather over it returns a fake
tensor of the gathered shape and records the bytes this rank would receive
with the op counters (``launch.op_analysis``).
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..launch.mesh import AbstractGroup
from ..launch.op_analysis import record_collective
from .specs import spec_axes

# torch renamed all_gather_into_tensor; both names take (out, in, group)
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def group_size(group) -> int:
    """The ranks of ``group``: 1 for None, an abstract group's size, or the
    process group's."""
    if group is None:
        return 1
    return group.size if isinstance(group, AbstractGroup) else dist.get_world_size(group)


def gather_stack(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x``, in rank order."""
    if group is None:
        return x[None]
    if isinstance(group, AbstractGroup):  # the n - 1 other ranks' copies arrive
        record_collective("all_gather", group.axes, n, (n - 1) * x.numel() * x.element_size())
        return x.detach().new_empty((n, *x.shape))
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    with torch.no_grad():
        _all_gather(out, x.detach().reshape(-1), group=group)
    return out.view(n, *x.shape)


def ordered_sum(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The sum of every rank's ``x``, added in rank order."""
    if group is None:
        return x
    return functools.reduce(torch.add, gather_stack(x, group, n).unbind(0))


class _OrderedSum(torch.autograd.Function):
    """``ordered_sum`` whose gradient for each rank's ``x`` is the sum of
    every rank's output gradient (each rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return ordered_sum(x.detach(), group, n)

    @staticmethod
    def backward(ctx, grad):
        return ordered_sum(grad.contiguous(), ctx.group, ctx.n), None, None


def sum_over(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """``ordered_sum`` through which gradients flow."""
    return x if group is None else _OrderedSum.apply(x, group, n)


def gather_leaf(shard: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf from every rank's ``shard`` of it (``spec`` as
    ``sharding.specs.param_specs`` gives it); the shard itself where no dim
    is split."""
    x = shard
    for dim, part in enumerate(spec):
        # a dim split over (a, b) holds block idx_a * n_b + idx_b: gather
        # over the minor axis first
        for axis in reversed(spec_axes(part)):
            n = mesh.shape[axis]
            if n > 1:
                x = torch.cat(gather_stack(x, mesh.group((axis,)), n).unbind(0), dim)
    return x


def local_block(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of a whole leaf (a view; ``full`` itself where no
    dim is split)."""
    x = full
    for dim, part in enumerate(spec):
        axes = spec_axes(part)
        n = mesh.size(axes)
        if n > 1:
            size = x.shape[dim] // n
            x = x.narrow(dim, mesh.index(axes) * size, size)
    return x
