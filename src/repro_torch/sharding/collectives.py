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
``gather_over_model`` and ``scatter_sum_over_model`` are the other pair,
for a block split along one dim: the ranks' blocks gathered in rank order
(backward, the rank's block of the rank-ordered sum of the ranks'
gradients), and the rank's block of the rank-ordered sum of the ranks'
partials (backward, the ranks' gradient blocks gathered).
``gather_whole_over_model`` and ``split_over_model`` bound a region that
every rank computes alike on the whole (under sequence parallelism, a
block whose leaves are whole): the ranks' blocks gathered (backward, this
rank's block of the gradient, alike on every rank), and this rank's block
of a tensor every rank holds alike (backward, the ranks' gradient blocks
gathered).
``pair_columns`` moves blocks of columns between the ranks
(``_move_blocks``, an all-to-all of uneven parts), the mLSTM's ``w_up``
from the reference's partition to the blocks a rank computes on.

A group is ``None`` where one rank makes it up: then nothing is sent and
nothing is copied.  A group of an abstract mesh (``launch.mesh.
AbstractGroup``) sends nothing either: a collective over it returns a fake
tensor of the result's shape.  Over either kind of group each collective
reports the bytes this rank receives to the op counters that are counting
(``launch.op_analysis.record_collective``), under its own kind and the
group's mesh axes: ``all_gather``, ``ordered_sum``,
``ordered_reduce_scatter``, ``ordered_max``, ``merge_partials`` for the
exchange of a sequence-split decode's partial outputs (``gather_stack``
or ``all_to_all`` under that kind), ``gather_activations`` for
``gather_over_model``, ``gather_whole_over_model`` and the backwards of
``scatter_sum_over_model`` and ``split_over_model``, ``pair_columns``, and
``all_to_all`` for a prefill's K/V moved from KV heads to positions
(``models.lm._heads_to_positions``).
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
    send = send.contiguous()
    recv = torch.empty_like(send)  # contiguous too, as the transport fills it
    with torch.no_grad():
        dist.all_to_all_single(recv, send, group=group)
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


def _gather_dim(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` in rank order."""
    return torch.cat(gather_stack(x.contiguous(), group, n, "gather_activations").unbind(0), dim)


def _scatter_sum_dim(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` (n equal blocks) of the sum of every
    rank's ``x``, added in rank order."""
    y = x.unflatten(dim, (n, -1)).movedim(dim, 0)  # (n, ..., block, ...)
    part = _reduce_scatter_rows(y.reshape(n, -1), group, n, "ordered_reduce_scatter")
    return part.view(y.shape[1:])


class _GatherOverModel(torch.autograd.Function):
    """The ranks' blocks joined along ``dim`` in rank order; backward, this
    rank's block of the rank-ordered sum of the ranks' gradients (each
    rank's own compute reads the whole)."""

    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _gather_dim(x.detach(), group, n, dim)

    @staticmethod
    def backward(ctx, grad):
        return _scatter_sum_dim(grad, ctx.group, ctx.n, ctx.dim), None, None, None


class _ScatterSumOverModel(torch.autograd.Function):
    """This rank's block along ``dim`` of the rank-ordered sum of the
    ranks' partials; backward, the ranks' gradient blocks joined in rank
    order (each rank's partial reaches every block)."""

    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _scatter_sum_dim(x.detach(), group, n, dim)

    @staticmethod
    def backward(ctx, grad):
        return _gather_dim(grad, ctx.group, ctx.n, ctx.dim), None, None, None


def gather_over_model(x: torch.Tensor, group, n: int, dim: int = -1) -> torch.Tensor:
    """The model group's blocks of a tensor split along ``dim``, joined in
    rank order, whose gradient is this rank's block of the ranks'
    gradients summed in rank order."""
    return x if group is None else _GatherOverModel.apply(x, group, n, dim % x.dim())


def scatter_sum_over_model(x: torch.Tensor, group, n: int, dim: int = -1) -> torch.Tensor:
    """This rank's block along ``dim`` of the model group's partials summed
    in rank order, whose gradient is the ranks' gradient blocks joined."""
    return x if group is None else _ScatterSumOverModel.apply(x, group, n, dim % x.dim())


class _GatherWholeOverModel(torch.autograd.Function):
    """The ranks' blocks joined along ``dim`` in rank order, for compute
    that every rank repeats alike on the whole; backward, this rank's block
    of the gradient (every rank's is the same)."""

    @staticmethod
    def forward(ctx, x, group, n, idx, dim):
        ctx.n, ctx.idx, ctx.dim = n, idx, dim
        return _gather_dim(x.detach(), group, n, dim)

    @staticmethod
    def backward(ctx, grad):
        return _own_block(grad, ctx.n, ctx.idx, ctx.dim), None, None, None, None


class _SplitOverModel(torch.autograd.Function):
    """This rank's block along ``dim`` of a tensor every rank holds alike;
    backward, the ranks' gradient blocks joined in rank order."""

    @staticmethod
    def forward(ctx, x, group, n, idx, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _own_block(x.detach(), n, idx, dim)

    @staticmethod
    def backward(ctx, grad):
        return _gather_dim(grad, ctx.group, ctx.n, ctx.dim), None, None, None, None


def _own_block(x: torch.Tensor, n: int, idx: int, dim: int) -> torch.Tensor:
    """Block ``idx`` of n equal blocks of ``x`` along ``dim``."""
    size = x.shape[dim] // n
    return x.narrow(dim, idx * size, size).contiguous()


def gather_whole_over_model(x: torch.Tensor, group, n: int, idx: int,
                            dim: int = -1) -> torch.Tensor:
    """The model group's blocks of a tensor split along ``dim``, joined in
    rank order, for a region every rank computes alike; its gradient is
    this rank's (``idx``) block of the (alike) whole gradient."""
    if group is None:
        return x
    return _GatherWholeOverModel.apply(x, group, n, idx, dim % x.dim())


def split_over_model(x: torch.Tensor, group, n: int, idx: int, dim: int = -1) -> torch.Tensor:
    """This rank's (``idx``) block along ``dim`` of a tensor every rank of
    the model group holds alike, whose gradient is the ranks' gradient
    blocks joined."""
    return x if group is None else _SplitOverModel.apply(x, group, n, idx, dim % x.dim())


def _all_to_all_v(send: torch.Tensor, in_splits: list, out_splits: list,
                  group) -> torch.Tensor:
    """Rows ``in_splits[j]`` of ``send`` (in order) to rank j; the rows from
    each rank j (``out_splits[j]``) joined in rank order."""
    recv = send.new_empty((sum(out_splits), *send.shape[1:]))
    with torch.no_grad():
        dist.all_to_all_single(recv, send.contiguous(), out_splits, in_splits, group=group)
    return recv


def _move_blocks(x: torch.Tensor, group, n: int, idx: int, have_of, want_of,
                kind: str) -> torch.Tensor:
    """Blocks of rows between the ranks: ``x`` holds, in order, the equal
    blocks ``have_of(idx)`` (their ids); the result the blocks
    ``want_of(idx)``, in order, each from the rank that has it."""
    have, want = list(have_of(idx)), list(want_of(idx))
    m = x.shape[0] // len(have)
    blocks = dict(zip(have, x.split(m)))
    send = [b for j in range(n) for b in want_of(j) if b in blocks]
    from_rank = [[b for b in want if b in set(have_of(j))] for j in range(n)]
    received = [b for ids in from_rank for b in ids]
    others = sum(len(ids) for j, ids in enumerate(from_rank) if j != idx)
    _record(kind, group, n, others * blocks[have[0]].numel() * x.element_size())
    if isinstance(group, AbstractGroup):
        return x.detach().new_empty((m * len(want), *x.shape[1:]))
    recv = _all_to_all_v(torch.cat([blocks[b] for b in send]),
                         [m * sum(b in blocks for b in want_of(j)) for j in range(n)],
                         [m * len(ids) for ids in from_rank], group)
    parts = dict(zip(received, recv.split(m)))
    return torch.cat([parts[b] for b in want])


def _pairing(n: int) -> tuple:
    """(held, paired): the column blocks rank j holds at rest of a leaf of
    2n blocks split over n ranks as one dim, and the blocks it computes on."""
    return (lambda j: (2 * j, 2 * j + 1)), (lambda j: (j, n + j))


class _PairColumns(torch.autograd.Function):
    """``pair_columns``; backward, the gradient's blocks sent back to the
    ranks that hold them at rest."""

    @staticmethod
    def forward(ctx, w, group, n, idx):
        ctx.group, ctx.n, ctx.idx = group, n, idx
        held, paired = _pairing(n)
        return _move_blocks(w.detach().movedim(-1, 0), group, n, idx, held, paired,
                           "pair_columns").movedim(0, -1)

    @staticmethod
    def backward(ctx, grad):
        held, paired = _pairing(ctx.n)
        return _move_blocks(grad.movedim(-1, 0), ctx.group, ctx.n, ctx.idx, paired, held,
                           "pair_columns").movedim(0, -1), None, None, None


def pair_columns(w: torch.Tensor, group, n: int, idx: int) -> torch.Tensor:
    """Rank ``idx``'s columns of a leaf ``[a | b]`` whose 2n equal column
    blocks split over the n ranks as one dim (rank j holds blocks 2j and
    2j + 1): block ``idx`` of ``a`` and block ``idx`` of ``b``, side by
    side, each from the rank that holds it (the mLSTM's ``w_up``, ``[x_inner
    | z]``, whose rank computes on its block of the inner width)."""
    if group is None:
        return w
    return _PairColumns.apply(w, group, n, idx)
