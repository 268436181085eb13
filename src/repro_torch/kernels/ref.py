"""Plain PyTorch versions of the port's kernels.

Deliberately the simplest correct statements (quadratic attention with
explicit masks, no blocking, no online softmax), so a kernel bug cannot
hide in shared structure.  Ported from ``repro/kernels/ref.py``.  The
kernel wrappers run these for tensors on the CPU; the tests and
``chip_smoke.py`` hold the CUDA kernels against them.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30  # the decode kernels' mask value


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """x (..., d); scale (d,) stored as a delta from 1.  f32 statistics,
    output in x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-6):
    """The gradients of ``rmsnorm_ref`` given the output's gradient ``dy``:
    (dx in x's dtype, dscale f32), in f32 statistics.  The reference's
    training path differentiates its plain RMSNorm and has no backward
    kernel; this is that derivative written out."""
    d = x.shape[-1]
    x32, g32 = x.float(), dy.float()
    r = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    xhat = x32 * r
    dscale = (g32 * xhat).reshape(-1, d).sum(dim=0)
    gw = g32 * (1.0 + scale.float())
    dx = r * (gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), dscale


def _attention_scores(q, k, causal: bool, window: int = 0):
    """q (B,S,H,D); k (B,S,KV,D) -> f32 scores (B,H,S,S), scaled by
    1/sqrt(D), with the masked entries at -inf.  ``window`` > 0 also masks
    the keys ``window`` or more positions before the query."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kf = k.repeat_interleave(G, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(D)
    i = torch.arange(S, device=q.device)
    mask = (i[None, :] <= i[:, None]) if causal else torch.ones(
        S, S, dtype=torch.bool, device=q.device)
    if window:
        mask = mask & (i[None, :] > i[:, None] - window)
    return s.masked_fill(~mask, float("-inf"))


def causal_attention_ref(q, k, v, causal: bool = True, window: int = 0):
    """q (B,S,H,D); k,v (B,S,KV,D) -> (B,S,H,D).  Plain masked softmax
    attention with KV head h // G for query head h; ``window`` > 0 is the
    reference's sliding-window (local) mode: query i sees keys j with
    i - window < j <= i."""
    s = _attention_scores(q, k, causal, window)
    G = q.shape[2] // k.shape[2]
    vf = v.repeat_interleave(G, dim=2).float()
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def attention_lse_ref(q, k, causal: bool = True, window: int = 0):
    """The log-sum-exp of each query row's scaled, masked scores: (B,S,H)
    f32, what ``flash_attention(..., return_lse=True)`` returns beside its
    output."""
    s = _attention_scores(q, k, causal, window)
    return torch.logsumexp(s, dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_ref(q, k, v, out, lse, do, causal: bool = True,
                            window: int = 0):
    """The gradients of causal GQA attention (windowed when ``window`` > 0,
    the local attention of ``causal_attention_ref``) from the forward's ``out`` and
    ``lse`` (B,S,H) and the output's gradient ``do``: (dq (B,S,H,D) in q's
    dtype, dk, dv (B,S,KV,D) in k's and v's).  Quadratic, in f32: with
    ``p = exp(s - lse)`` and ``delta = rowsum(do * out)``, ``ds = p * (do
    v^T - delta) * scale``, ``dq = ds k`` and dk, dv summed over each KV
    head's G query heads.  What the reference's two backward passes
    compute (``repro/kernels/flash_attention.py::flash_attention_bwd``)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    kf = k.repeat_interleave(G, dim=2).float()
    vf = v.repeat_interleave(G, dim=2).float()
    qf, dof = q.float(), do.float()
    delta = (dof * out.float()).sum(dim=-1).transpose(1, 2)  # (B,H,S)
    s = _attention_scores(q, k, causal, window)  # masked entries -inf: p = 0 there
    p = torch.exp(s - lse.transpose(1, 2)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(B, S, KV, G, D).sum(3)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(B, S, KV, G, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(q, k_cache, v_cache, lengths, return_lse: bool = False):
    """q (B,H,D); caches (B,Smax,KV,D); lengths (B,) -> (B,H,D).

    A row with length 0 gives 0, as the decode kernels do
    (``acc / max(l, 1e-30)`` with ``acc == 0``); a plain softmax over an
    all-masked row would give NaN there.  ``return_lse`` also returns each
    row's log-sum-exp of its scaled scores, (B,H) f32: -1e30 (the kernels'
    mask value) for a row with no valid position."""
    B, H, D = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    kf = k_cache.repeat_interleave(G, dim=2).float()
    vf = v_cache.repeat_interleave(G, dim=2).float()
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kf) / math.sqrt(D)
    valid = (torch.arange(Smax, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])[:, None, :]
    masked = s.masked_fill(~valid, float("-inf"))
    p = torch.softmax(masked, dim=-1)
    p = torch.where(valid, p, torch.zeros((), device=q.device))
    out = torch.einsum("bhk,bkhd->bhd", p, vf).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(valid.any(-1), torch.logsumexp(masked, dim=-1),
                      torch.full((), NEG_INF, dtype=s.dtype, device=q.device))
    return out, lse


def merge_partials_ref(o, lse):
    """The rank-ordered merge of n partial decode outputs, each over a slice
    of the cache: o (n,B,H,D), lse (n,B,H) as ``decode_attention_ref`` gives
    them -> (B,H,D) in o's dtype, ``sum_r o_r e^(lse_r - M) / sum_r
    e^(lse_r - M)`` with M the largest lse, each sum added in rank order; a
    rank with no valid position (lse -1e30) weighs 0, and a row where no
    rank has one gives 0 (the combine pass's ``max(den, 1e-30)``)."""
    w = torch.where(lse > NEG_INF, torch.exp(lse - lse.amax(0)), 0.0)
    of = o.to(w.dtype)
    acc, den = of[0] * w[0, ..., None], w[0]
    for r in range(1, o.shape[0]):
        acc = acc + of[r] * w[r, ..., None]
        den = den + w[r]
    return (acc / torch.clamp(den, min=1e-30)[..., None]).to(o.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths):
    """q (B,H,D); pools (N,bs,KV,D); block_tables (B,T); lengths (B,).

    Gathers each sequence's blocks into a contiguous cache and defers to
    the dense version: the simplest statement of what paging must equal.
    """
    B = q.shape[0]
    _, _, KV, D = k_pool.shape
    tab = block_tables.long()
    kc = k_pool[tab].reshape(B, -1, KV, D)
    vc = v_pool[tab].reshape(B, -1, KV, D)
    return decode_attention_ref(q, kc, vc, lengths)


def rglru_scan_ref(log_a, b):
    """h_t = exp(log_a_t) * h_{t-1} + b_t from h_{-1} = 0, sequential over
    time.  log_a, b (B,S,C) f32 -> h (B,S,C) f32."""
    h = torch.zeros_like(b[:, 0])
    out = torch.empty_like(b)
    for t in range(b.shape[1]):
        h = torch.exp(log_a[:, t]) * h + b[:, t]
        out[:, t] = h
    return out


def rglru_scan_bwd_ref(log_a, h, dh):
    """The gradients of ``rglru_scan_ref`` from its output ``h`` and the
    output's gradient ``dh`` (B,S,C) f32: the reverse scan ``g_t = dh_t +
    a_{t+1} g_{t+1}`` (g past the end 0) as an explicit loop, then ``db =
    g`` and ``dlog_a_t = g_t * a_t * h_{t-1}`` (h_{-1} = 0).  Returns
    (dlog_a, db)."""
    a = torch.exp(log_a)
    db = torch.empty_like(dh)
    g = torch.zeros_like(dh[:, 0])
    a_next = torch.zeros_like(g)
    for t in range(dh.shape[1] - 1, -1, -1):
        g = dh[:, t] + a_next * g
        db[:, t] = g
        a_next = a[:, t]
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return db * a * h_prev, db


def _mlstm_inputs(q, k, v, i_pre, f_pre):
    """The recurrences' common start: q scaled by 1/sqrt(dk), everything in
    f32 (in f64 when q is f64: an exact reference), the forget gate as log
    sigmoid."""
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = 1.0 / math.sqrt(q.shape[-1])
    return (q.to(dt) * scale, k.to(dt), v.to(dt), i_pre.to(dt),
            torch.nn.functional.logsigmoid(f_pre.to(dt)))


def mlstm_ref(q, k, v, i_pre, f_pre):
    """Fully sequential stabilized mLSTM, the oracle.  q,k,v (B,S,H,dk);
    gates (B,S,H) -> h (B,S,H,dk) f32.

    C_t = f C_{t-1} + i k v^T;  h_t = (q C_t) / max(|q n_t|, exp(-m_t))."""
    B, S, H, dk = q.shape
    qf, kf, vf, log_i, log_f = _mlstm_inputs(q, k, v, i_pre, f_pre)
    C = qf.new_zeros((B, H, dk, dk))
    n = qf.new_zeros((B, H, dk))
    m = qf.new_zeros((B, H))
    hs = []
    for t in range(S):
        qt, kt, vt, li, lf = qf[:, t], kf[:, t], vf[:, t], log_i[:, t], log_f[:, t]
        m_next = torch.maximum(lf + m, li)
        f_sc = torch.exp(lf + m - m_next)
        i_sc = torch.exp(li - m_next)
        C = f_sc[..., None, None] * C + i_sc[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = f_sc[..., None] * n + i_sc[..., None] * kt
        num = torch.einsum("bhd,bhde->bhe", qt, C)
        den = torch.einsum("bhd,bhd->bh", qt, n)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_next))[..., None])
        m = m_next
    return torch.stack(hs, dim=1)


def mlstm_chunk_ref(q, k, v, i_pre, f_pre, *, chunk: int = 128,
                    return_final: bool = False):
    """The chunkwise-parallel stabilized mLSTM recurrence: the plain version
    of ``mlstm_chunk``, ported from the reference's
    ``models/recurrent.py::mlstm_chunk_recurrence``.

    q,k,v (B,S,H,dk); i_pre, f_pre (B,S,H) preactivations -> h (B,S,H,dk)
    f32 [, the final (C (B,H,dk,dk), n (B,H,dk), m (B,H)) f32]; f64 inputs
    give the same in f64.  The chunk
    is ``min(chunk, S)`` and must divide S.  Within a chunk: D[i,j] =
    csum_i - csum_j + li_j (j <= i), m_i = max(max_j D[i,j], csum_i + m),
    h = num / max(|den|, exp(-m_i)); the carry (C, n, m) moves to the
    chunk's end."""
    return _mlstm_chunks(*_mlstm_inputs(q, k, v, i_pre, f_pre), chunk,
                         return_final)


def mlstm_chunk_bwd_ref(q, k, v, log_i, log_f, dh, *, chunk: int = 128):
    """The plain version of the mLSTM backward kernel: autograd through
    the chunk recurrence from the log gates as the kernels take them (q, k,
    v (B,S,H,dk); log_i, log_f (B,S,H) f32, log_f a log sigmoid) given the
    output's gradient ``dh`` -> (dq, dk, dv in q's dtype, dlog_i, dlog_f)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v, log_i, log_f)]
        dt = torch.float64 if q.dtype == torch.float64 else torch.float32
        scale = 1.0 / math.sqrt(q.shape[-1])
        h = _mlstm_chunks(leaves[0].to(dt) * scale, leaves[1].to(dt),
                          leaves[2].to(dt), leaves[3].to(dt), leaves[4].to(dt),
                          chunk, False)
        return torch.autograd.grad(h, leaves, dh.to(h.dtype))


def _mlstm_chunks(qs, kf, vf, log_i, log_f, chunk: int, return_final: bool):
    """The chunk recurrence of ``mlstm_chunk_ref`` from its prepared inputs:
    q already scaled, the forget gate as log sigmoid."""
    B, S, H, dk = qs.shape
    c = min(chunk, S)
    if c <= 0 or S % c:
        raise ValueError(f"mlstm chunk {c} does not divide the sequence {S}")
    nc = S // c

    def chunks(x):  # (B,S,H,...) -> (nc, B,H,c,...)
        x = x.transpose(1, 2).reshape(B, H, nc, c, *x.shape[3:])
        return x.movedim(2, 0)

    qf, kf, vf, log_i, log_f = (chunks(x) for x in (qs, kf, vf, log_i, log_f))
    tri = torch.ones((c, c), dtype=torch.bool, device=qs.device).tril()
    C = qf.new_zeros((B, H, dk, dk))
    n = qf.new_zeros((B, H, dk))
    m = qf.new_zeros((B, H))
    hs = []
    for qt, kt, vt, li, lf in zip(qf, kf, vf, log_i, log_f):
        csum = torch.cumsum(lf, dim=-1)  # decay from the chunk start to i
        total = csum[..., -1:]
        D = csum[..., :, None] - csum[..., None, :] + li[..., None, :]
        D = D.masked_fill(~tri, float("-inf"))
        g = csum + m[..., None]  # the carry's magnitude at each position
        m_i = torch.maximum(D.amax(dim=-1), g)
        W = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * torch.exp(D - m_i[..., None])
        inter = torch.exp(g - m_i)
        num = torch.einsum("bhqk,bhkd->bhqd", W, vt) + inter[..., None] * torch.einsum(
            "bhqd,bhde->bhqe", qt, C)
        den = W.sum(dim=-1) + inter * torch.einsum("bhqd,bhd->bhq", qt, n)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None])
        dec = total - csum + li  # weight of k_j v_j at the chunk's end
        m_next = torch.maximum(m + total[..., 0], dec.amax(dim=-1))
        w_new = torch.exp(dec - m_next[..., None])
        decay = torch.exp(m + total[..., 0] - m_next)
        C = decay[..., None, None] * C + torch.einsum(
            "bhk,bhkd,bhke->bhde", w_new, kt, vt)
        n = decay[..., None] * n + torch.einsum("bhk,bhkd->bhd", w_new, kt)
        m = m_next
    h = torch.stack(hs, dim=2).reshape(B, H, S, dk).transpose(1, 2)
    return (h, (C, n, m)) if return_final else h


def _by_chunk(x, c: int):
    """(B, S, H, ...) -> (S / c, B, H, c, ...)."""
    B, S, H = x.shape[:3]
    return x.transpose(1, 2).reshape(B, H, S // c, c, *x.shape[3:]).movedim(2, 0)


def _unchunk(xs: list):
    """S / c tensors (B, H, c, ...) -> (B, S, H, ...)."""
    B, H, c = xs[0].shape[:3]
    return torch.stack(xs, 2).reshape(B, H, len(xs) * c, *xs[0].shape[3:]).transpose(1, 2)


def mlstm_chunk_bwd_state_ref(q, k, v, log_i, log_f, h, den, carries, dh, *,
                              chunk: int = 128, mm=None) -> list:
    """The plain version of the backward kernel's own equations (the header
    of ``csrc/mlstm_chunk_bwd.cu``) from the forward's saved state, rather
    than autograd through a forward run again: q, k, v (B,S,H,dk) unscaled;
    log_i, log_f (B,S,H); the forward's h (B,S,H,dk) and den (B,S,H); the
    carries ``(C (B,H,dk,dk), n (B,H,dk), m (B,H))`` entering each chunk;
    dh -> [dq, dk, dv, dlog_i, dlog_f], in the inputs' dtype (f64 inputs
    give an exact evaluation).  ``mm(a, b, a_kind, b_kind)`` forms each
    matrix product, the kinds "in" (q, k, v) or "f32" (an f32 operand), so
    a test can substitute the kernel's split products; a @ b by default."""
    if mm is None:
        def mm(a, b, _ka, _kb):
            return a @ b
    B, S, H, dk = q.shape
    c = min(chunk, S)
    scale = 1.0 / math.sqrt(dk)
    nc = S // c
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    Q, K, V, LI, LF, Hh, DEN, DH = (_by_chunk(x, c) for x in (q, k, v, log_i, log_f, h, den, dh))
    rows = []
    for t in range(nc):
        cs, m = torch.cumsum(LF[t], -1), carries[t][2]
        D = (cs[..., :, None] - cs[..., None, :] + LI[t][..., None, :]).masked_fill(~tri, -math.inf)
        mi = torch.maximum(D.amax(-1), cs + m[..., None])
        floor = torch.exp(-mi)
        lim = torch.maximum(DEN[t].abs(), floor)
        dden = torch.where((DEN[t].abs() >= floor) & (DEN[t] != 0),
                           -(DH[t] * Hh[t]).sum(-1) / DEN[t], zero)
        if t + 1 < nc:  # the move to the m' of the carry entering the next chunk
            mn = carries[t + 1][2]
            w = torch.exp(cs[..., -1:] - cs + LI[t] - mn[..., None])
            decay = torch.exp(m + cs[..., -1] - mn)
        else:  # past the last chunk G and dn are 0
            w, decay = torch.zeros_like(cs), torch.zeros_like(m)
        rows.append(dict(
            inter=torch.exp(cs + m[..., None] - mi), dden=dden, dnum=DH[t] / lim[..., None],
            w=w, decay=decay, E=torch.where(tri, torch.exp(D - mi[..., None]), zero)))
    Gs, G, dn = [None] * nc, q.new_zeros((B, H, dk, dk)), q.new_zeros((B, H, dk))
    for t in range(nc - 1, -1, -1):  # the carry gradient's reverse walk
        Gs[t] = (G, dn)
        if t == 0:
            break
        r = rows[t]
        u = r["dnum"] * (scale * r["inter"])[..., None]
        G = r["decay"][..., None, None] * G + mm(
            u.transpose(-1, -2), Q[t], "f32", "in").transpose(-1, -2)
        dn = r["decay"][..., None] * dn + ((r["dden"] * r["inter"])[..., None]
                                           * (Q[t] * scale)).sum(-2)
    out = [[] for _ in range(5)]
    for t in range(nc):
        r, (C, n, _m), (G, dnv) = rows[t], carries[t], Gs[t]
        W = (mm(Q[t], K[t].transpose(-1, -2), "in", "in") * scale) * r["E"]
        dW = torch.where(tri, mm(r["dnum"], V[t].transpose(-1, -2), "f32", "in")
                         + r["dden"][..., None], zero)
        dS, dD = dW * r["E"], dW * W
        CD = mm(r["dnum"], C.transpose(-1, -2), "f32", "f32")
        GV = mm(V[t], G.transpose(-1, -2), "in", "f32") + dnv[..., None, :]
        di = r["dden"][..., None] * n[..., None, :]
        out[0].append(scale * (mm(dS, K[t], "f32", "in") + r["inter"][..., None] * (CD + di)))
        out[1].append(scale * mm(dS.transpose(-1, -2), Q[t], "f32", "in")
                      + r["w"][..., None] * GV)
        out[2].append(mm(W.transpose(-1, -2), r["dnum"], "f32", "f32")
                      + r["w"][..., None] * mm(K[t], G, "in", "f32"))
        ww = (K[t] * GV).sum(-1) * r["w"]
        colD = dD.sum(-2)
        dcs = ((Q[t] * scale) * (CD + di)).sum(-1) * r["inter"] + dD.sum(-1) - colD - ww
        dcs[..., -1] += ((G * C).sum((-1, -2)) + (dnv * n).sum(-1)) * r["decay"] + ww.sum(-1)
        out[3].append(colD + ww)
        out[4].append(dcs.flip(-1).cumsum(-1).flip(-1))
    return [_unchunk(x) for x in out]
