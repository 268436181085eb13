"""Recurrent sequence-mixing blocks: RG-LRU (Griffin), mLSTM and sLSTM
(xLSTM), ported from ``repro/models/recurrent.py``.

Each block provides ``init_*`` (parameters), ``*_seq`` (a full sequence:
prefill), ``*_step`` (one token with carried state: decode) and
``*_init_state``.  ``rglru_seq`` runs its linear recurrence through the
``rglru_scan`` kernel and ``mlstm_seq`` its chunkwise recurrence through the
``mlstm_chunk`` kernel (``impl="kernel"``; their wrappers run the plain
versions for CPU tensors), or through those plain versions (``"plain"``).
The plain RG-LRU scan is sequential where the reference uses an associative
scan: only the order of summation differs.  sLSTM has recurrent weights and
runs its cell as a loop over time, with the values of the reference's
custom-VJP forward, and trains through ``_SlstmScan``, the port of that
hand-written VJP.  Under autograd the two kernels run their backward
kernels (``rglru_scan_bwd``, ``mlstm_chunk_bwd``).

The reference's dtype choices are kept, each of which an f32 comparison
cannot see:

- the sequence conv multiplies in the compute dtype (``conv_w`` and
  ``conv_b`` rounded to it at use), but the step conv sums in f32 against
  the f32 ``conv_w`` and adds the f32 ``conv_b``;
- the RG-LRU gates (``w_a``, ``w_i``, ``b_a``, ``b_i``, ``lam``), the mLSTM
  gate pre-activations (``w_i``, ``w_f``, ``b_i``, ``b_f``) and every sLSTM
  input, recurrent and bias weight are read in f32, from f32 inputs;
- ``rglru_seq``'s state ``h`` is f32 and is rounded to the compute dtype
  just before the gate product; the mLSTM recurrence and its carry are f32
  and its output is rounded before the group norm; the sLSTM cell and its
  state are f32.

``repro_torch.convert.cast_params`` keeps all of those leaves in f32.

Under a bound model group (``sharding.ctx.model_group``) whose ranks hold
blocks of a layer's width, as the reference's partition places them
(``sharding.specs``), each layer computes on its rank's block; every sum
over the ranks adds in rank order and is rounded once:

- RG-LRU over ``rnn``: ``w_x`` and ``w_g`` column-parallel, the conv, the
  gates' biases, ``lam`` and the scan on the rank's channels; the gate
  products read every channel of the conv output (``w_a``/``w_i`` split
  only their outputs), so the ranks' blocks are gathered in the compute
  dtype before the f32 cast; ``w_o`` row-parallel.  The decode state
  ``h``/``conv`` is the rank's channels;
- mLSTM over its inner width ``di`` (``ff``): ``w_up`` at rest splits
  ``[x_inner | z]`` as one dim, so its columns are re-paired first
  (``collectives.pair_columns``: the rank's blocks of ``x_inner`` and of
  ``z``); the conv on the rank's channels; q, k, v and the gate
  pre-activations are row-parallel f32 partials, summed, and where the
  model axis divides the heads (as the decode cache then splits them)
  each rank keeps its heads' block of the sum and runs the recurrence on
  them, its output gathered for the group norm over the whole ``di``;
  else every rank runs every head.  The output gate and ``w_down``
  row-parallel on the rank's ``di`` block;
- sLSTM: its gates and cell whole on every rank, as the reference's
  partition leaves them; its FFN column- then row-parallel.  Its decode
  state ``h``/``c``/``n``/``m`` rests split by channel: the step gathers
  it, runs the cell and keeps its block; the prefill returns its block.

Under sequence parallelism (``sharding.ctx.stream_group``) each block
takes this rank's positions of the normed stream and gives back its
positions of the output: the split blocks gather the sequence in and
scatter their row-parallel sums out (``layers.block_in`` /
``block_out``), and a block whose leaves are whole runs alike on every
rank over the gathered sequence and keeps its positions.  The sLSTM's cell
is such a part: its output ``out`` is cut to the rank's positions, not
summed, and added to the rank's positions of its FFN's sum.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import kernels
from ..kernels import _build
from ..kernels.ref import mlstm_chunk_ref, rglru_scan_ref
from ..sharding.collectives import (
    copy_to_model,
    gather_over_model,
    pair_columns,
    scatter_sum_over_model,
    sum_over_model,
)
from ..sharding.ctx import model_group
from .layers import (
    act_fn,
    block_in,
    block_out,
    dense_init,
    init_rmsnorm,
    matmul_f32,
    rmsnorm,
)

RGLRU_C = 8.0  # Griffin's fixed gate sharpness constant
SLSTM_GATES = ("z", "i", "f", "o")

# the reference's name for the plain chunkwise recurrence
mlstm_chunk_recurrence = mlstm_chunk_ref


# ---------------------------------------------------------------- temporal conv


def causal_conv_seq(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, in x's dtype.  x (B,S,C), w (W,C)."""
    W, S = w.shape[0], x.shape[1]
    out = x * w[W - 1].to(x.dtype)
    for j in range(1, W):
        shifted = F.pad(x, (0, 0, j, 0))[:, :S]
        out = out + shifted * w[W - 1 - j].to(x.dtype)
    return out + b.to(x.dtype)


def causal_conv_step(x: torch.Tensor, state: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor):
    """x (B,C); state (B,W-1,C) holds the previous W-1 inputs, oldest first.
    Sums in f32 against ``w`` as stored.  Returns (out in x's dtype, the new
    state)."""
    window = torch.cat([state, x[:, None]], dim=1)  # (B,W,C)
    out = torch.einsum("bwc,wc->bc", window.float(), w) + b
    return out.to(x.dtype), window[:, 1:]


def _conv_tail(x_pre: torch.Tensor, W: int) -> torch.Tensor:
    """The last W-1 pre-conv inputs (zero-padded at the front), oldest
    first: the step conv's state after a prefill."""
    B, S, C = x_pre.shape
    n = W - 1
    if S >= n:
        return x_pre[:, S - n:]
    return torch.cat([x_pre.new_zeros((B, n - S, C)), x_pre], dim=1)


# ----------------------------------------------------------------------- rg-lru


def init_rglru(gen: torch.Generator, d: int, d_rnn: int,
               conv_width: int) -> dict:
    dev = gen.device
    # lam so that a = exp(-c * softplus(lam)) is spread in [0.9, 0.999]
    # (Griffin, section 2.4)
    u = 0.9 + 0.099 * torch.rand(d_rnn, generator=gen, dtype=torch.float32,
                                 device=dev)
    lam = torch.log(torch.expm1(-torch.log(u) / RGLRU_C))
    return {
        "w_x": dense_init(gen, (d, d_rnn)),
        "w_g": dense_init(gen, (d, d_rnn)),
        "conv_w": dense_init(gen, (conv_width, d_rnn)),
        "conv_b": torch.zeros(d_rnn, device=dev),
        "w_a": dense_init(gen, (d_rnn, d_rnn)),
        "b_a": torch.zeros(d_rnn, device=dev),
        "w_i": dense_init(gen, (d_rnn, d_rnn)),
        "b_i": torch.zeros(d_rnn, device=dev),
        "lam": lam,
        "w_o": dense_init(gen, (d_rnn, d)),
    }


def _split(local: int, whole: int) -> tuple:
    """(group, n, this rank's index) of the bound model group where a
    leaf's dim holds ``local`` of ``whole``; (None, 1, 0) where it is
    whole."""
    group, n, idx = model_group()
    if group is None or local == whole:
        return None, 1, 0
    if local * n != whole:
        raise ValueError(f"a block of {local} of {whole} over {n} ranks")
    return group, n, idx


def _rglru_gates(params: dict, xr: torch.Tensor, group=None, n: int = 1):
    """xr (..., d_rnn) post-conv input -> (log_a, b), both f32.  With a
    model ``group``, xr is this rank's channels: the gate products read
    the ranks' channels joined."""
    x32 = xr.float()
    xa = x32 if group is None else gather_over_model(xr, group, n).float()
    r = torch.sigmoid(xa @ params["w_a"].float() + params["b_a"])
    i = torch.sigmoid(xa @ params["w_i"].float() + params["b_i"])
    log_a = -RGLRU_C * F.softplus(params["lam"]) * r  # <= 0
    a2 = torch.exp(2.0 * log_a)
    b = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * x32)
    return log_a, b


def _rglru_out(params: dict, h: torch.Tensor, gate: torch.Tensor, dt, group,
               n: int) -> torch.Tensor:
    """The gated state through ``w_o`` (row-parallel with a model group),
    to the stream (``block_out``)."""
    y = h.to(dt) * gate
    if group is None:
        return block_out((y @ params["w_o"].to(dt)).to(dt))
    return block_out(matmul_f32(y, params["w_o"].to(dt)), group, n).to(dt)


def rglru_seq(params: dict, x: torch.Tensor, return_state: bool = False,
              impl: str = "kernel"):
    """The RG-LRU mix over a sequence.  x (B,S,d), already normed ->
    (B,S,d) [, state {h (B,d_rnn) f32, conv (B,W-1,d_rnn)}, this rank's
    channels under a model group]; x and the output this rank's positions
    under sequence parallelism."""
    dt = x.dtype
    group, n, _ = _split(params["w_a"].shape[1], params["w_a"].shape[0])
    x = block_in(x, group, n)
    gate = act_fn("gelu")(x @ params["w_g"].to(dt))
    xr_pre = x @ params["w_x"].to(dt)
    xr = causal_conv_seq(xr_pre, params["conv_w"], params["conv_b"])
    log_a, b = _rglru_gates(params, xr, group, n)
    scan = kernels.rglru_scan if impl == "kernel" else rglru_scan_ref
    h = scan(log_a.contiguous(), b.contiguous())  # (B,S,d_rnn) f32
    out = _rglru_out(params, h, gate, dt, group, n)
    if return_state:
        state = {"h": h[:, -1].float(),
                 "conv": _conv_tail(xr_pre, params["conv_w"].shape[0])}
        return out, state
    return out


def rglru_step(params: dict, x: torch.Tensor, state: dict):
    """One decode step.  x (B,d); state {h (B,d_rnn) f32, conv
    (B,W-1,d_rnn)}, this rank's channels under a model group -> (out
    (B,d), the new state)."""
    dt = x.dtype
    group, n, _ = _split(params["w_a"].shape[1], params["w_a"].shape[0])
    x = copy_to_model(x, group, n)
    gate = act_fn("gelu")(x @ params["w_g"].to(dt))
    xr = x @ params["w_x"].to(dt)
    xr, conv_state = causal_conv_step(xr, state["conv"], params["conv_w"],
                                      params["conv_b"])
    log_a, b = _rglru_gates(params, xr, group, n)
    h = state["h"] * torch.exp(log_a) + b
    return _rglru_out(params, h, gate, dt, group, n), {"h": h, "conv": conv_state}


def rglru_init_state(batch: int, d_rnn: int, conv_width: int,
                     dtype=torch.bfloat16, device=None, groups=()) -> dict:
    return {
        "h": torch.zeros((*groups, batch, d_rnn), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((*groups, batch, conv_width - 1, d_rnn),
                            dtype=dtype, device=device),
    }


# ------------------------------------------------------------------------ mlstm


def init_mlstm(gen: torch.Generator, d: int, num_heads: int,
               conv_width: int) -> dict:
    dev = gen.device
    di = 2 * d  # up-projection factor 2
    dk = di // num_heads
    return {
        "w_up": dense_init(gen, (d, 2 * di)),  # (x_inner, z-gate)
        "conv_w": dense_init(gen, (conv_width, di)),
        "conv_b": torch.zeros(di, device=dev),
        "wq": dense_init(gen, (di, num_heads, dk)),
        "wk": dense_init(gen, (di, num_heads, dk)),
        "wv": dense_init(gen, (di, num_heads, dk)),
        "w_i": dense_init(gen, (di, num_heads)),
        "b_i": torch.full((num_heads,), -3.0, device=dev),
        "w_f": dense_init(gen, (di, num_heads)),
        "b_f": torch.linspace(3.0, 6.0, num_heads, device=dev),
        "gn": init_rmsnorm(di, dev),
        "w_down": dense_init(gen, (di, d)),
    }


def _mlstm_split(params: dict, num_heads: int) -> tuple:
    """(group, n, this rank's index, whether the ranks split the heads) of
    an mLSTM layer whose leaves hold a block of the inner width under a
    bound model group; (None, 1, 0, False) where they hold all of it."""
    di, local = params["gn"]["scale"].shape[-1], params["conv_b"].shape[-1]
    group, n, idx = _split(local, di)
    if group is not None and params["w_up"].shape[-1] != 2 * local:
        raise ValueError(f"w_up holds {params['w_up'].shape[-1]} columns of the "
                         f"{2 * di} and the conv {local} channels of {di}")
    return group, n, idx, group is not None and num_heads % n == 0


_WHOLE = (None, 1, 0, False)


def _mlstm_qkvif(params: dict, xc: torch.Tensor, x_inner: torch.Tensor,
                 num_heads: int, tp: tuple = _WHOLE):
    """Per-head q, k, v in the compute dtype and the f32 gate
    pre-activations, from the conv output and the inner stream.  Under a
    model group (``tp``, from ``_mlstm_split``) the inputs are the rank's
    channels, whose products are f32 partials summed over the ranks: all
    of it, or the rank's heads where they split."""
    dt = xc.dtype
    lead = xc.shape[:-1]
    group, n, idx, heads_split = tp
    if group is None:
        def heads(x, w):
            return (x @ w.flatten(1).to(dt)).view(*lead, num_heads, -1)

        q = heads(xc, params["wq"])
        k = heads(xc, params["wk"])
        v = heads(x_inner, params["wv"])
        x32 = xc.float()
        i_pre = x32 @ params["w_i"] + params["b_i"]
        f_pre = x32 @ params["w_f"] + params["b_f"]
        return q, k, v, i_pre, f_pre
    reduce = scatter_sum_over_model if heads_split else sum_over_model
    H = num_heads // n if heads_split else num_heads

    def heads(x, w):
        return reduce(matmul_f32(x, w.flatten(1).to(dt)), group, n).to(dt).view(*lead, H, -1)

    def bias(b):  # every rank reads the whole leaf, or its heads' block
        return copy_to_model(b, group, n)[idx * H:(idx + 1) * H] if heads_split else b

    q = heads(xc, params["wq"])
    k = heads(xc, params["wk"])
    v = heads(x_inner, params["wv"])
    x32 = xc.float()
    i_pre = reduce(x32 @ params["w_i"], group, n) + bias(params["b_i"])
    f_pre = reduce(x32 @ params["w_f"], group, n) + bias(params["b_f"])
    return q, k, v, i_pre, f_pre


def _mlstm_up(params: dict, x: torch.Tensor, tp: tuple = _WHOLE):
    """The up projection split into the inner stream and the z gate (the
    rank's blocks of both under a model group), from the stream
    (``block_in``)."""
    group, n, idx, _ = tp
    w = params["w_up"].to(x.dtype)
    x = block_in(x, group, n)
    if group is not None:
        w = pair_columns(w, group, n, idx)
    up = x @ w
    c = w.shape[-1] // 2
    return up[..., :c], up[..., c:]


def _mlstm_out(params: dict, h: torch.Tensor, z: torch.Tensor,
               dt, tp: tuple = _WHOLE) -> torch.Tensor:
    """Group norm of the f32 recurrence output rounded to ``dt``, the z gate,
    the down projection.  Under a model group the norm reads the whole
    width (the ranks' heads joined, where they split them), and the rank
    gates its block and takes its rows of ``w_down``; the result goes to
    the stream (``block_out``)."""
    group, n, idx, heads_split = tp
    scale = params["gn"]["scale"]
    h = h.to(dt)
    if group is None:
        h = rmsnorm(h, scale) * F.silu(z)
        return block_out((h @ params["w_down"].to(dt)).to(dt))
    if heads_split:
        h = rmsnorm(gather_over_model(h, group, n), copy_to_model(scale, group, n))
    else:
        h = copy_to_model(rmsnorm(h, scale), group, n)
    c = z.shape[-1]
    h = h[..., idx * c:(idx + 1) * c] * F.silu(z)
    return block_out(matmul_f32(h, params["w_down"].to(dt)), group, n).to(dt)


def mlstm_seq(params: dict, x: torch.Tensor, num_heads: int, *,
              chunk: int = 128, return_state: bool = False,
              impl: str = "kernel"):
    """The mLSTM mix over a sequence.  x (B,S,d), normed -> (B,S,d) [, state
    {C, n, m (f32), conv}, the rank's heads and channels under a model
    group]; x and the output this rank's positions under sequence
    parallelism.  The prefill takes the final carry from the same kernel."""
    dt = x.dtype
    tp = _mlstm_split(params, num_heads)
    x_inner, z = _mlstm_up(params, x, tp)
    B, S = x_inner.shape[:2]
    xc = F.silu(causal_conv_seq(x_inner, params["conv_w"], params["conv_b"]))
    q, k, v, i_pre, f_pre = _mlstm_qkvif(params, xc, x_inner, num_heads, tp)
    rec = kernels.mlstm_chunk if impl == "kernel" else mlstm_chunk_ref
    out = rec(q.contiguous(), k.contiguous(), v.contiguous(),
              i_pre.contiguous(), f_pre.contiguous(), chunk=chunk,
              return_final=return_state)
    h, final = out if return_state else (out, None)
    out = _mlstm_out(params, h.reshape(B, S, -1), z, dt, tp)
    if return_state:
        C, n, m = final
        return out, {"C": C, "n": n, "m": m,
                     "conv": _conv_tail(x_inner, params["conv_w"].shape[0])}
    return out


def mlstm_step(params: dict, x: torch.Tensor, state: dict, num_heads: int):
    """One decode step.  x (B,d); state {C (B,H,dk,dk), n (B,H,dk), m (B,H)
    f32, conv (B,W-1,di)}, the rank's heads and channels under a model
    group -> (out (B,d), the new state)."""
    dt = x.dtype
    B = x.shape[0]
    tp = _mlstm_split(params, num_heads)
    x_inner, z = _mlstm_up(params, x, tp)
    xc, conv_state = causal_conv_step(x_inner, state["conv"],
                                      params["conv_w"], params["conv_b"])
    xc = F.silu(xc)
    q, k, v, i_pre, f_pre = _mlstm_qkvif(params, xc, x_inner, num_heads, tp)
    q, k, v = q.float(), k.float(), v.float()
    log_f = F.logsigmoid(f_pre)
    q = q / math.sqrt(q.shape[-1])
    C, n, m = state["C"], state["n"], state["m"]
    m_next = torch.maximum(log_f + m, i_pre)
    f_sc = torch.exp(log_f + m - m_next)
    i_sc = torch.exp(i_pre - m_next)
    C_next = f_sc[..., None, None] * C + i_sc[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", k, v)
    n_next = f_sc[..., None] * n + i_sc[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C_next)
    den = torch.einsum("bhd,bhd->bh", q, n_next)
    h = num / torch.maximum(den.abs(), torch.exp(-m_next))[..., None]
    out = _mlstm_out(params, h.reshape(B, -1), z, dt, tp)
    return out, {"C": C_next, "n": n_next, "m": m_next, "conv": conv_state}


def mlstm_init_state(batch: int, d: int, num_heads: int, conv_width: int,
                     dtype=torch.bfloat16, device=None, groups=()) -> dict:
    di = 2 * d
    dk = di // num_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((*groups, batch, num_heads, dk, dk), **f32),
        "n": torch.zeros((*groups, batch, num_heads, dk), **f32),
        "m": torch.zeros((*groups, batch, num_heads), **f32),
        "conv": torch.zeros((*groups, batch, conv_width - 1, di), dtype=dtype,
                            device=device),
    }


# ------------------------------------------------------------------------ slstm


def slstm_ff(d: int) -> int:
    """The width of the sLSTM's FFN: 4/3 of ``d``, rounded to 64."""
    return max(int(round(d * 4 / 3 / 64) * 64), 64)


def init_slstm(gen: torch.Generator, d: int, num_heads: int) -> dict:
    dev = gen.device
    dh = d // num_heads
    p: dict = {}
    for gate in SLSTM_GATES:
        p[f"w_{gate}"] = dense_init(gen, (d, d))
        p[f"r_{gate}"] = dense_init(gen, (num_heads, dh, dh))
        p[f"b_{gate}"] = (torch.linspace(3.0, 6.0, d, device=dev) if gate == "f"
                          else torch.zeros(d, device=dev))
    p["gn"] = init_rmsnorm(d, dev)
    p["w_o_proj"] = dense_init(gen, (d, d))
    d_ff = slstm_ff(d)
    p["ffn"] = {
        "norm": init_rmsnorm(d, dev),
        "w_gate": dense_init(gen, (d, d_ff)),
        "w_up": dense_init(gen, (d, d_ff)),
        "w_down": dense_init(gen, (d_ff, d)),
    }
    return p


def _slstm_pre(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The input contributions W_g x + b_g of the four gates, in f32 from
    the f32 weights: (4, ..., d)."""
    x32 = x.float()
    return torch.stack([x32 @ params[f"w_{g}"] + params[f"b_{g}"]
                        for g in SLSTM_GATES])


def _slstm_cell(R: torch.Tensor, pre: torch.Tensor, state: dict) -> dict:
    """One sLSTM step.  R (4,H,dh,dh) the stacked recurrent weights; pre
    (4,B,d) the gates' input contributions; state {h, c, n, m} (B,d) f32."""
    B, d = state["h"].shape
    H = R.shape[1]
    rec = torch.einsum("bhx,ghxy->gbhy", state["h"].view(B, H, d // H), R)
    a = pre + rec.reshape(4, B, d)  # z, i, f, o
    z = torch.tanh(a[0])
    o = torch.sigmoid(a[3])
    log_f = F.logsigmoid(a[2])
    m_next = torch.maximum(log_f + state["m"], a[1])
    i_sc = torch.exp(a[1] - m_next)
    f_sc = torch.exp(log_f + state["m"] - m_next)
    c_next = f_sc * state["c"] + i_sc * z
    n_next = torch.clamp(f_sc * state["n"] + i_sc, min=1e-6)
    h_next = o * (c_next / n_next)
    return {"h": h_next, "c": c_next, "n": n_next, "m": m_next}


def _slstm_out(params: dict, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Group norm, output projection and the gated FFN sub-layer (its
    residual inside; the caller adds the block-input residual).  The FFN
    is column- then row-parallel where the leaves hold a block of its
    width under a bound model group.  Under sequence parallelism h and x
    are the whole sequence, which every rank's cell ran alike: ``out`` is
    cut to this rank's positions, the FFN's partials scattered over them
    (``block_out``)."""
    dt = x.dtype
    h = rmsnorm(h.to(dt), params["gn"]["scale"])
    out = (h @ params["w_o_proj"].to(dt)).to(dt)
    ffn = params["ffn"]
    group, n, _ = _split(ffn["w_up"].shape[-1], slstm_ff(x.shape[-1]))
    y = copy_to_model(rmsnorm(out + x, ffn["norm"]["scale"]), group, n)
    g = act_fn("gelu")((y @ ffn["w_gate"].to(dt)).float())
    u = (y @ ffn["w_up"].to(dt)).float()
    gu = (g * u).to(dt)
    if group is None:
        return block_out(out + (gu @ ffn["w_down"].to(dt)).to(dt))
    return block_out(out) + block_out(matmul_f32(gu, ffn["w_down"].to(dt)), group,
                                      n).to(dt)


def _state_group(d: int) -> tuple:
    """(group, n, this rank's index) of the bound model group where it
    splits an sLSTM state of width ``d`` by channel, as the decode cache
    places it; (None, 1, 0) otherwise."""
    group, n, idx = model_group()
    if group is None or d % n:
        return None, 1, 0
    return group, n, idx


def _state_block(state: dict, d: int) -> dict:
    """This rank's channels of a whole sLSTM state, where the model group
    splits it."""
    group, n, idx = _state_group(d)
    if group is None:
        return state
    c = d // n
    return {k: v[..., idx * c:(idx + 1) * c].contiguous() for k, v in state.items()}


def _slstm_R(params: dict) -> torch.Tensor:
    return torch.stack([params[f"r_{g}"] for g in SLSTM_GATES])


class _SlstmScan(torch.autograd.Function):
    """The sLSTM cell over a sequence with the reference's hand-written VJP
    (``repro/models/recurrent.py::_slstm_scan``): the forward keeps only
    the four state sequences; the backward recomputes the gate quantities
    vectorized over time, runs the reverse loop (elementwise work and the
    constant-R products of each step) and takes the batch-contracted
    ``dR = sum_t outer(h_{t-1}, dgate_t)`` as one product after the loop.
    Plain PyTorch: the reference has no Pallas kernel here."""

    @staticmethod
    def forward(ctx, R, pre):
        """R (4,H,dh,dh); pre (4,B,S,d) f32 -> h (B,S,d) f32."""
        B, S, d = pre.shape[1:]
        state = {k: v.to(pre.dtype)
                 for k, v in slstm_init_state(B, d, device=pre.device).items()}
        # the other state sequences only when a backward will read them
        kept = ("h", "c", "n", "m") if any(ctx.needs_input_grad) else ("h",)
        if _build.shapes_only():  # a dry-run: one step counted as S
            with _build.repeated(S):
                state = _slstm_cell(R, pre[:, :, 0], state)
            seqs = {name: state[name].new_empty((S, B, d)) for name in kept}
        else:
            seqs = {name: [] for name in kept}
            for t in range(S):
                state = _slstm_cell(R, pre[:, :, t], state)
                for name in kept:
                    seqs[name].append(state[name])
            seqs = {name: torch.stack(vals) for name, vals in seqs.items()}
        if len(kept) > 1:
            ctx.save_for_backward(R, pre, *(seqs[name] for name in kept))
        return seqs["h"].transpose(0, 1)

    @staticmethod
    def backward(ctx, dh):
        R, pre, h_seq, c_seq, n_seq, m_seq = ctx.saved_tensors  # (S,B,d)
        S, B, d = h_seq.shape
        H = R.shape[1]
        dh_ = d // H
        init = {k: v.to(pre.dtype)
                for k, v in slstm_init_state(B, d, device=pre.device).items()}

        def shift(seq, first):
            return torch.cat([first[None], seq[:-1]], dim=0)

        h_prev, c_prev = shift(h_seq, init["h"]), shift(c_seq, init["c"])
        n_prev, m_prev = shift(n_seq, init["n"]), shift(m_seq, init["m"])
        pre_t = pre.transpose(1, 2)  # (4,S,B,d)
        rec = torch.einsum("sbhx,ghxy->gsbhy", h_prev.view(S, B, H, dh_), R)
        a = pre_t + rec.reshape(4, S, B, d)
        z = torch.tanh(a[0])
        o = torch.sigmoid(a[3])
        lf = F.logsigmoid(a[2])
        sg_naf = torch.sigmoid(-a[2])  # d log_sigmoid(a_f) / d a_f
        i_sc = torch.exp(a[1] - m_seq)
        f_sc = torch.exp(lf + m_prev - m_seq)
        uncl = (f_sc * n_prev + i_sc > 1e-6).float()  # n_t = max(n_pre, 1e-6)
        mxl = (lf + m_prev >= a[1]).float()  # m's max takes its left branch
        u = c_seq / n_seq
        dhs = dh.transpose(0, 1)
        Dc_c = torch.zeros((B, d), dtype=pre.dtype, device=pre.device)
        Dn_c, Dm_c, Dh_c = (torch.zeros_like(Dc_c) for _ in range(3))
        Das = torch.empty((S, 4, B, d), dtype=pre.dtype, device=pre.device)
        dry = _build.shapes_only()  # a dry-run: the last step, counted as S
        with _build.repeated(S if dry else 1):
            for t in [S - 1] if dry else range(S - 1, -1, -1):
                Dh = dhs[t] + Dh_c
                Da_o = Dh * u[t] * o[t] * (1.0 - o[t])
                Dc = Dc_c + Dh * o[t] / n_seq[t]
                Dn_pre = (Dn_c - Dh * o[t] * u[t] / n_seq[t]) * uncl[t]
                Df = Dc * c_prev[t] + Dn_pre * n_prev[t]  # onto f_sc
                Di = Dc * z[t] + Dn_pre  # onto i_sc
                Dz = Dc * i_sc[t]
                Dc_c = Dc * f_sc[t]
                Dn_c = Dn_pre * f_sc[t]
                # i_sc = exp(a_i - m_t); f_sc = exp(lf + m_prev - m_t)
                Da_i = Di * i_sc[t]
                Dm_t = Dm_c - Di * i_sc[t] - Df * f_sc[t]
                Dlf = Df * f_sc[t] + Dm_t * mxl[t]
                Dm_c = Df * f_sc[t] + Dm_t * mxl[t]
                Da_i = Da_i + Dm_t * (1.0 - mxl[t])
                Das[t, 0] = Dz * (1.0 - z[t] * z[t])
                Das[t, 1] = Da_i
                Das[t, 2] = Dlf * sg_naf[t]
                Das[t, 3] = Da_o
                # h_{t-1} through the recurrent products (R constant here)
                Dh_c = torch.einsum("gbhy,ghxy->bhx", Das[t].view(4, B, H, dh_),
                                    R).reshape(B, d)
        # the weight gradient: one batch and time contraction
        DR = torch.einsum("sbhx,sgbhy->ghxy", h_prev.view(S, B, H, dh_),
                          Das.view(S, 4, B, H, dh_))
        return DR, Das.permute(1, 2, 0, 3)


def slstm_seq(params: dict, x: torch.Tensor, num_heads: int,
              return_state: bool = False):
    """The sLSTM block over a sequence: its cell as a loop over time from
    ``slstm_init_state`` (through ``_SlstmScan``, whose backward is the
    reference's hand-written VJP, unless the final state is asked for, as
    in the reference), then ``_slstm_out``.  x (B,S,d) normed -> (B,S,d)
    [, the final state]; under sequence parallelism x and the output are
    this rank's positions, and the cell runs whole on every rank over the
    gathered sequence (``block_in``)."""
    x = block_in(x)
    B, S, d = x.shape
    pre = _slstm_pre(params, x)  # (4,B,S,d)
    R = _slstm_R(params)
    if not return_state:
        return _slstm_out(params, _SlstmScan.apply(R, pre), x)
    state = {k: v.to(pre.dtype) for k, v in slstm_init_state(B, d, device=x.device).items()}
    if _build.shapes_only():  # a dry-run: one step counted as S
        with _build.repeated(S):
            state = _slstm_cell(R, pre[:, :, 0], state)
        return _slstm_out(params, state["h"].new_empty((B, S, d)), x), _state_block(state, d)
    hs = []
    for t in range(S):
        state = _slstm_cell(R, pre[:, :, t], state)
        hs.append(state["h"])
    return _slstm_out(params, torch.stack(hs, dim=1), x), _state_block(state, d)


def slstm_step(params: dict, x: torch.Tensor, state: dict, num_heads: int):
    """One decode step.  x (B,d); state {h, c, n, m} (B,d) f32, or this
    rank's channels of it (B,d/n) where the model group splits it: the
    ranks' blocks are gathered, the cell runs whole, the rank keeps its
    block."""
    d = x.shape[-1]
    split = state["h"].shape[-1] != d
    if split:
        group, n, _ = _state_group(d)
        state = {k: gather_over_model(v, group, n) for k, v in state.items()}
    new_state = _slstm_cell(_slstm_R(params), _slstm_pre(params, x), state)
    return _slstm_out(params, new_state["h"], x), (_state_block(new_state, d) if split
                                                  else new_state)


def slstm_init_state(batch: int, d: int, device=None, groups=()) -> dict:
    shape = (*groups, batch, d)
    z = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros(shape, **z), "c": torch.zeros(shape, **z),
            "n": torch.full(shape, 1e-6, **z), "m": torch.zeros(shape, **z)}
