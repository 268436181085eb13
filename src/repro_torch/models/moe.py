"""Mixture-of-Experts layer: shared + fine-grained routed experts, ported
from ``repro/models/moe.py``.

Covers deepseek-moe-16b (2 shared + 64 routed experts, top-6) and
qwen2-moe-a2.7b (4 shared + 60 routed, top-4, a sigmoid-gated shared
expert).  Tokens are routed in groups of ``min(group_size, T)``; each
expert takes at most ``C`` (the capacity) of a group's assignments, filled
choice-major (every token's first choice, then every token's second, ...)
and in token order, and the rest are dropped.  Two dispatch paths with the
same drops, selected by ``MoECfg.impl``:

- ``einsum``: the GShard dense dispatch and combine, as batched products
  over the (E * C) slots of a group;
- ``sort``: a stable argsort by expert gives each assignment its slot; the
  tokens are scattered into an (E, C, d) buffer and the outputs gathered
  back, each token's contributions summed in f32 in ascending expert order
  (a fixed order: no atomics, the same bits on every call).

Both run every slot of every expert through the experts' gated MLPs
(``bmm`` over the expert axis).  No TPU kernel lies behind this layer: its
products are plain einsums in the reference.

Expert-parallel (a bound model group of n ranks, and ``w_gate`` holding
E / n of the experts): where the reference's ``shard`` constraints put the
slot buffers on ``("dp", "expert", ...)`` while a group's tokens stay whole
on every rank, each rank routes its groups as one device does (the router
is whole: the same logits, softmax and top k on every rank), takes the
slots over all E experts with the global capacity, keeps its own experts'
block of them and runs only those experts.  Its combine, and its terms of
the aux loss, are partials summed over the group in rank order (f32,
rounded once): the reference's "cross-shard psum" of the combine.  The
tokens and the router reach the routed part through ``copy_to_model``, so
their gradients are the sums of every rank's terms.  The shared experts are
column- then row-parallel where their width is split (``mlp_apply``);
qwen2's gate reads the block input whole and scales the summed output.

Under sequence parallelism the layer takes this rank's positions of the
normed stream and gathers them over the sequence before routing
(``layers.block_in``), so the routing groups and the capacity are the
whole sequence's, as the reference's global semantics give; the routed and
shared partials come back as this rank's positions of their rank-ordered
sums (``layers.block_out``).  A part whose leaves are whole runs alike on
every rank over the gathered sequence and keeps its rank's positions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import MoECfg
from ..sharding.collectives import (
    copy_to_model,
    gather_stack,
    ordered_sum,
    sum_over,
    sum_over_model,
)
from ..sharding.ctx import loss_group, loss_index, model_group, stream_group, whole_batch
from .layers import (
    act_fn,
    block_in,
    block_out,
    bmm_f32,
    dense_init,
    matmul_f32,
    mlp_apply,
    mlp_partial,
    stream_leaf,
)

IMPLS = ("einsum", "sort")


def init_moe(gen: torch.Generator, d: int, m: MoECfg) -> dict:
    """The reference's leaves and shapes: ``router`` (d,E), ``w_gate`` and
    ``w_up`` (E,d,de), ``w_down`` (E,de,d), the shared experts' gated MLP
    of width ``num_shared * de`` and qwen2's ``shared_gate`` (d,1)."""
    E, de = m.num_experts, m.d_expert
    p = {
        "router": dense_init(gen, (d, E)),
        "w_gate": dense_init(gen, (E, d, de)),
        "w_up": dense_init(gen, (E, d, de)),
        "w_down": dense_init(gen, (E, de, d)),
    }
    if m.num_shared:
        ds = m.num_shared * de
        p["shared"] = {
            "w_gate": dense_init(gen, (d, ds)),
            "w_up": dense_init(gen, (d, ds)),
            "w_down": dense_init(gen, (ds, d)),
        }
        if m.shared_gate:
            p["shared_gate"] = dense_init(gen, (d, 1))
    return p


def _capacity(m: MoECfg, g: int) -> int:
    return max(4, int(math.ceil(g * m.top_k * m.capacity_factor / m.num_experts)))


def _route(params, xg, m: MoECfg):
    """xg (n,g,d) -> (gate_vals (n,g,k) f32, idx (n,g,k), probs (n,g,E) f32).

    The router is rounded to the compute dtype and its product accumulated
    in f32; the softmax is f32.  The top k come from a stable descending
    sort, so equal probabilities go to the lower expert index first, as
    ``jax.lax.top_k`` breaks ties (``torch.topk`` promises no order)."""
    logits = matmul_f32(xg, params["router"].to(xg.dtype))
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :m.top_k], idx[..., :m.top_k], probs


def _aux_loss(probs, idx, m: MoECfg, lo: int = 0, El: int = 0) -> torch.Tensor:
    """Load-balance loss: E * sum_e f_e * P_e (Switch/GShard form), over
    the experts ``[lo, lo + El)`` where ``El`` is given (an expert-parallel
    rank's terms).  Under a mesh binding f and P are the means over the
    bound loss's global batch (every rank holds as many groups), taken
    before the product, with P's gradient flowing back to each rank's own
    probabilities."""
    E = m.num_experts
    f = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
    P = probs.mean(dim=(0, 1))
    group, n = loss_group()
    if group is not None:
        f = ordered_sum(f, group, n) / n
        P = sum_over(P, group, n) / n
    if El:
        f, P = f[lo:lo + El], P[lo:lo + El]
    return E * torch.sum(f * P)


def _slots(idx, C: int, E: int):
    """Each assignment's slot in its expert's buffer, choice-major.

    idx (n,g,k) -> (pos (n,g,k), keep (n,g,k) bool): ``pos`` counts the
    assignments to the same expert before this one in the order (choice 0
    of every token, then choice 1, ...; tokens in order), and ``keep`` is
    ``pos < C``.  The reference's running count of one-hot masks."""
    n, g, k = idx.shape
    seq = idx.transpose(1, 2).reshape(n, k * g)  # choice-major sequence
    counts = torch.cumsum(F.one_hot(seq, E), dim=1)  # (n, k*g, E)
    pos = counts.gather(2, seq[..., None])[..., 0] - 1
    pos = pos.view(n, k, g).transpose(1, 2)
    return pos, pos < C


def _local_slots(idx, pos, keep, C: int, lo: int, El: int):
    """The slots of the experts ``[lo, lo + El)``: (slot (n,g,k), local
    (n,g,k) bool).  ``local`` marks the kept assignments to those experts,
    ``slot`` their place in the block's (El * C) slots, El * C (a spare
    slot, cut off) for every other assignment."""
    local = keep & (idx >= lo) & (idx < lo + El)
    return torch.where(local, (idx - lo) * C + pos, El * C), local


def _experts_gemm(params, xe, act: str) -> torch.Tensor:
    """xe (E, M, d) -> (E, M, d) through the experts' gated MLPs: gate and
    up accumulated in f32, the activation product rounded to the compute
    dtype, the down projection accumulated in f32 and rounded."""
    dt = xe.dtype
    g = bmm_f32(xe, params["w_gate"].to(dt))
    u = bmm_f32(xe, params["w_up"].to(dt))
    return bmm_f32((act_fn(act)(g) * u).to(dt),
                   params["w_down"].to(dt)).to(dt)


def _run_experts(params, xs, act: str) -> torch.Tensor:
    """xs (n, E*C, d) slot buffers -> (n, E*C, d) expert outputs.  The
    groups' slots of one expert form one product (E, n*C, d)."""
    n, EC, d = xs.shape
    E = params["w_gate"].shape[0]
    xe = xs.view(n, E, EC // E, d).transpose(0, 1).reshape(E, -1, d)
    ye = _experts_gemm(params, xe, act)
    return ye.view(E, n, EC // E, d).transpose(0, 1).reshape(n, EC, d)


def _moe_einsum(params, xg, m: MoECfg, act: str, lo: int = 0):
    """The GShard dense dispatch.  xg (n,g,d) -> (out (n,g,d), aux).

    ``combine`` (n, g, E*C) holds each kept assignment's gate at its slot.
    The reference sums a one-hot (n,g,k,E,C) tensor over k to build it;
    every token's k experts differ, so each of its slots gets one gate and
    a scatter gives the same numbers without that tensor.  Dropped
    assignments go to a spare column that is cut off.

    Where ``params`` hold El < E experts (``lo`` the first), ``combine``
    and ``dispatch`` span their El * C slots only, every other assignment
    going to the spare column, and ``out`` and ``aux`` are this block's
    f32 partials."""
    n, g, d = xg.shape
    E, El = m.num_experts, params["w_gate"].shape[0]
    C = _capacity(m, g)
    gate_vals, idx, probs = _route(params, xg, m)
    pos, keep = _slots(idx, C, E)
    slot, _ = _local_slots(idx, pos, keep, C, lo, El)
    combine = gate_vals.new_zeros((n, g, El * C + 1)).scatter(
        2, slot, gate_vals)[..., :El * C]
    dispatch = (combine > 0).to(xg.dtype)
    # each slot receives one token at most: the product is exact in any dtype
    xs = torch.bmm(dispatch.transpose(1, 2), xg)  # (n, El*C, d)
    ys = _run_experts(params, xs, act)
    if El < E:
        return bmm_f32(combine.to(xg.dtype), ys), _aux_loss(probs, idx, m, lo, El)
    out = torch.bmm(combine.to(xg.dtype), ys)
    return out, _aux_loss(probs, idx, m)


def _moe_sort(params, xg, m: MoECfg, act: str, lo: int = 0):
    """The argsort dispatch.  xg (n,g,d) -> (out (n,g,d), aux).

    The same slots as the einsum path: a stable sort of the choice-major
    sequence by expert gives each assignment its place in its expert's
    run.  Tokens move by scatter and gather; a dropped assignment's index
    points at a spare row (written and never read on scatter, zero on
    gather), since torch faults where JAX drops or fills out of range.

    Where ``params`` hold El < E experts (``lo`` the first), the buffer
    holds their El * C slots, an assignment to any other expert points at
    the spare row too, and ``out`` and ``aux`` are this block's f32
    partials."""
    n, g, d = xg.shape
    E, k, El = m.num_experts, m.top_k, params["w_gate"].shape[0]
    C = _capacity(m, g)
    gate_vals, idx, probs = _route(params, xg, m)
    a = g * k
    seq = idx.transpose(1, 2).reshape(n, a)  # j = choice * g + token
    order = torch.argsort(seq, dim=1, stable=True)
    e_sorted = seq.gather(1, order)
    counts = F.one_hot(seq, E).sum(dim=1)  # (n, E)
    starts = torch.cumsum(counts, dim=1) - counts
    ar = torch.arange(a, device=xg.device)
    pos_sorted = ar - starts.gather(1, e_sorted)
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    pos = pos.view(n, k, g).transpose(1, 2)  # (n, g, k)
    slot, local = _local_slots(idx, pos, pos < C, C, lo, El)  # (n, g, k)

    rows = torch.arange(n, device=xg.device)[:, None]
    tok = ar % g  # the token of sequence entry j
    buf = xg.new_zeros((n, El * C + 1, d))
    buf = buf.index_put((rows, slot.transpose(1, 2).reshape(n, a)),
                        xg[:, tok])
    ys = _run_experts(params, buf[:, :El * C], act)
    ys = torch.cat([ys, ys.new_zeros((n, 1, d))], dim=1)

    # each token's k contributions, summed in f32 in ascending expert order
    # (the order of the reference's scatter-add over the sorted sequence)
    by_expert = torch.argsort(idx, dim=2)
    slot = slot.gather(2, by_expert)
    gates = (gate_vals * local).gather(2, by_expert)
    out = None
    for c in range(k):
        vals = ys[rows, slot[..., c]] * gates[..., c:c + 1]
        out = vals if out is None else out + vals
    if El < E:
        return out, _aux_loss(probs, idx, m, lo, El)
    return out.to(xg.dtype), _aux_loss(probs, idx, m)


def moe_apply(params: dict, x: torch.Tensor, m: MoECfg, act: str):
    """x (B,S,d) -> (out (B,S,d), aux_loss f32 scalar).

    Tokens are routed in groups of ``min(group_size, B*S)``, which must
    divide B*S (the reference asserts it).  Under a mesh binding x is this
    rank's rows of the bound loss's batch, and the groups are those of the
    global batch: capacity couples a group's tokens, so where this rank's
    tokens are not whole groups of their own, a group spans the ranks (a
    serving step's few rows a rank): outside autograd, every rank gathers
    the global batch's tokens, routes them as one device would, and keeps
    its own rows' outputs; a step that differentiates raises rather than
    route otherwise.  The shared experts run as a gated MLP on every token;
    qwen2's sigmoid gate on them is f32.

    Under a bound model group (``sharding.ctx.model_group``) of n ranks:
    where ``params`` hold this rank's E / n routed experts, the layer is
    expert-parallel, and where they hold its columns of the shared experts,
    those are column- then row-parallel; a part whose leaves are whole runs
    whole.  Where the stream holds this rank's positions
    (``sharding.ctx.stream_group``), x and the output are them, and the
    tokens are routed over the whole sequence."""
    B, S, d = x.shape
    T = B * S * stream_group()[1]  # the whole sequence's tokens
    lgroup, n_loss = loss_group()
    g = min(m.group_size, T * n_loss)
    if T % g and not g % T and not (torch.is_grad_enabled() and x.requires_grad):
        i = loss_index()
        xs = gather_stack(x, lgroup, n_loss).reshape(n_loss * B, S, d)
        with whole_batch():  # the gathered rows are the global batch's
            out, aux = moe_apply(params, xs, m, act)
        return out[i * B:(i + 1) * B], aux
    if T % g:
        raise ValueError(
            f"MoE: {T} tokens do not split into groups of {g}" + (
                f" (the routing groups of the global batch of {T * n_loss} tokens "
                f"over {n_loss} ranks)" if n_loss > 1 else ""))
    if m.impl not in IMPLS:
        raise ValueError(f"MoE impl must be one of {IMPLS}, got {m.impl!r}")
    dispatch = _moe_sort if m.impl == "sort" else _moe_einsum
    group, n, index = model_group()
    El = params["w_gate"].shape[0]
    ep = El < m.num_experts  # expert-parallel: this rank's block of experts
    routed = (group, n) if ep else (None, 1)
    xr = block_in(x, *routed)  # the whole sequence under sequence parallelism
    xg = xr.reshape(T // g, g, d)
    if ep:
        if El * n != m.num_experts:
            raise ValueError(f"MoE: {El} of {m.num_experts} experts a rank over "
                             f"{n} ranks")
        rp = {**params, "router": copy_to_model(params["router"], group, n)}
        out, aux = dispatch(rp, xg, m, act, index * El)
        aux = sum_over_model(aux, group, n)
    else:
        out, aux = dispatch(params, xg, m, act)
    out = block_out(out.reshape(xr.shape), *routed).to(x.dtype)
    if "shared" in params:
        split = params["shared"]["w_up"].shape[-1] != m.num_shared * m.d_expert
        shared = (group, n) if split else (None, 1)
        if stream_group()[0] is not None and split == ep:  # one gather serves both
            y = block_out(mlp_partial(params["shared"], xr, act, True, split), *shared).to(x.dtype)
        else:
            y = mlp_apply(params["shared"], x, act, gated=True, group=shared[0], n=shared[1])
        if "shared_gate" in params:  # read on this rank's positions of the stream
            gate = torch.sigmoid(x.float() @ stream_leaf(params["shared_gate"]).float())
            y = (y.float() * gate).to(x.dtype)
        out = out + y
    return out, aux
