"""Collectives of the mesh train step over ``torch.distributed`` groups.

Every sum over ranks adds the ranks' contributions in rank order, as the
platform's collective (``allreduce_mean``) sums them, so a rerun gives the
same bits whatever the transport's reduction order.  ``ordered_sum`` does
it in two steps that move 2 (n - 1) / n of the tensor to each rank: an
all-to-all of n blocks, after which each rank adds its block of every
rank's copy in rank order (``ordered_reduce_scatter``, the half the
gradient mean keeps), and an all-gather of the summed blocks.  Each element
is added in the same order as a gather of the n copies followed by their
sum in rank order, so the bits are those.  ``ordered_max`` takes the
elementwise max of the gathered copies.

``copy_to_model`` and ``sum_over_model`` are the two conjugate operators of
tensor-parallel blocks (Megatron-LM's f and g): the identity forward with
a rank-ordered sum backward at a block's input, and a rank-ordered sum
forward with the identity backward after its row-parallel product.

A group is ``None`` where one rank makes it up: then nothing is sent and
nothing is copied.  A group of an abstract mesh (``launch.mesh.
AbstractGroup``) sends nothing either: a collective over it returns a fake
tensor of the result's shape.  Over either kind of group each collective
reports the bytes this rank receives to the op counters that are counting
(``launch.op_analysis.record_collective``), under its own kind and the
group's mesh axes: ``all_gather``, ``ordered_sum``,
``ordered_reduce_scatter``, ``ordered_max``, and ``merge_partials`` for the
exchange of a sequence-split decode's partial outputs (``gather_stack``
or ``all_to_all`` under that kind).
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F

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


def _record(kind: str, group, n: int, nbytes: int) -> None:
    """Report ``nbytes`` received by this rank over ``group``: its mesh axes
    are an abstract group's own, or the process group's description, which
    ``launch.mesh.Mesh`` sets to them."""
    axes = group.axes if isinstance(group, AbstractGroup) else tuple(
        group.group_desc.split(","))
    record_collective(kind, axes, n, nbytes)


def _gather(x: torch.Tensor, group, n: int, kind: str) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x``, in rank order (group not None)."""
    _record(kind, group, n, (n - 1) * x.numel() * x.element_size())
    if isinstance(group, AbstractGroup):  # the n - 1 other ranks' copies arrive
        return x.detach().new_empty((n, *x.shape))
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    with torch.no_grad():
        _all_gather(out, x.detach().reshape(-1), group=group)
    return out.view(n, *x.shape)


def gather_stack(x: torch.Tensor, group, n: int, kind: str = "all_gather") -> torch.Tensor:
    """(n, *x.shape): every rank's ``x``, in rank order (its bytes counted
    under ``kind``)."""
    if group is None:
        return x[None]
    return _gather(x, group, n, kind)


def _blocks(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` flattened and zero-padded to n equal blocks: (n, m)."""
    flat = x.detach().reshape(-1)
    m = -(-flat.numel() // n)
    if m * n != flat.numel():
        flat = F.pad(flat, (0, m * n - flat.numel()))
    return flat.view(n, m)


def _all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    """(n, m) -> (n, m): row j of the result is row ``index`` of rank j's
    ``send``."""
    recv = torch.empty_like(send)
    with torch.no_grad():
        dist.all_to_all_single(recv, send.contiguous(), group=group)
    return recv


def all_to_all(x: torch.Tensor, group, n: int, kind: str) -> torch.Tensor:
    """(n, ...) -> (n, ...): block j of the result is block ``index`` of
    rank j's ``x`` (its bytes counted under ``kind``)."""
    if group is None:
        return x
    _record(kind, group, n, (n - 1) * (x.numel() // n) * x.element_size())
    if isinstance(group, AbstractGroup):
        return x.detach().new_empty(x.shape)
    return _all_to_all(x.reshape(n, -1), group).view(x.shape)


def _reduce_scatter_rows(rows: torch.Tensor, group, n: int, kind: str) -> torch.Tensor:
    """Row ``index`` of the rank-ordered sum of every rank's ``rows`` (n, m),
    added in rank order: (m,)."""
    m = rows.shape[1]
    _record(kind, group, n, (n - 1) * m * rows.element_size())
    if isinstance(group, AbstractGroup):
        return rows.new_empty((m,))
    return functools.reduce(torch.add, _all_to_all(rows, group).unbind(0))


def ordered_reduce_scatter(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """This rank's block of the rank-ordered sum of every rank's ``x``:
    ``x`` flattened and zero-padded to n equal blocks, block ``index`` of
    the sum, (ceil(numel / n),).  A rank receives (n - 1) / n of ``x``."""
    if group is None:
        return x.reshape(-1)
    return _reduce_scatter_rows(_blocks(x, n), group, n, "ordered_reduce_scatter")


def ordered_sum(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The sum of every rank's ``x``, added in rank order: a reduce-scatter
    of n blocks and an all-gather of the sums, 2 (n - 1) / n of ``x`` to
    each rank."""
    if group is None:
        return x
    rows = _blocks(x, n)
    m = rows.shape[1]
    part = _reduce_scatter_rows(rows, group, n, "ordered_sum")
    _record("ordered_sum", group, n, (n - 1) * m * rows.element_size())
    if isinstance(group, AbstractGroup):
        return x.detach().new_empty(x.shape)
    out = torch.empty(n * m, dtype=x.dtype, device=x.device)
    with torch.no_grad():
        _all_gather(out, part, group=group)
    return out[:x.numel()].view(x.shape)


def ordered_max(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The elementwise max of every rank's ``x``, taken in rank order."""
    if group is None:
        return x
    return functools.reduce(torch.maximum, _gather(x, group, n, "ordered_max").unbind(0))


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


class _CopyToModel(torch.autograd.Function):
    """The identity; backward, the rank-ordered sum of the ranks'
    gradients (each rank's columns of a block read the same input)."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ordered_sum(grad.contiguous(), ctx.group, ctx.n), None, None


class _SumOverModel(torch.autograd.Function):
    """The rank-ordered sum of the ranks' partial results; backward, the
    identity (every rank's loss is the whole loss, computed alike)."""

    @staticmethod
    def forward(ctx, x, group, n):
        return ordered_sum(x.detach(), group, n)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def copy_to_model(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """A tensor-parallel block's input (or a replicated leaf it reads): the
    identity, whose gradient is summed over the model group in rank
    order."""
    return x if group is None else _CopyToModel.apply(x, group, n)


def sum_over_model(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The model group's partial results summed in rank order, with the
    identity for gradient."""
    return x if group is None else _SumOverModel.apply(x, group, n)


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
