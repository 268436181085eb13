"""The port's dry-run and roofline tools (``repro_torch.launch``: ``cells``,
``dryrun``, ``op_analysis``, ``roofline``, the abstract mesh) against the
reference's, on the CPU.

The shapes and the batch stand-ins equal the reference's; the op counter's
plain-mode FLOPs of a reduced forward equal ``repro.launch.hlo_analysis``
on the reference's compiled forward, and its kernel-mode count differs
from them by the attention's products and the kernels' own costs, in
closed form; each kernel's ``cost`` gives its PERF.md section 6 row's
bound; an abstract mesh's collective bytes follow the specs; every
applicable cell counts.  Everything runs on fake tensors: nothing is
drawn or allocated.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.configs import shape_applicable as jax_shape_applicable
from repro.data.stream import batch_specs as jax_batch_specs
from repro.launch.hlo_analysis import analyze
from repro.models import ModelOptions as JaxModelOptions
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, reduced_config, shape_applicable
from repro_torch.data import batch_specs
from repro_torch.kernels import (decode_attention, flash_attention, flash_attention_bwd,
                                 mlstm_chunk, mlstm_chunk_bwd, paged_decode_attention,
                                 rglru_scan, rglru_scan_bwd, rmsnorm)
from repro_torch.launch import cells, dryrun
from repro_torch.launch.mesh import HW, abstract_mesh
from repro_torch.launch.op_analysis import count
from repro_torch.launch.roofline import roofline_terms
from repro_torch.models import ModelOptions, forward, init_params
from repro_torch.models.moe import _capacity as moe_capacity
from repro_torch.sharding import activation_rules
from repro_torch.sharding.specs import PARAM_RULES, map_specs, spec_axes, tensor_parallel
from repro_torch.train import TrainConfig, abstract_train_state, init_train_state, make_train_step
from repro_torch.train.optim import leaves
from repro_torch.train import step as step_mod
from repro_torch.train.step import _leaf_plans, mesh_rules
from repro_torch.models.recurrent import slstm_ff

ROOT = Path(__file__).resolve().parents[1]
FLOPS_RTOL = 1e-6  # the counter against the reference's HLO walk
BOUND_RTOL = 0.01  # a cost's bound against PERF.md section 6's row


def test_shapes_and_applicability_equal_the_reference():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert {k: tuple(v.__dict__.values()) for k, v in SHAPES.items()} == \
        {k: tuple(v.__dict__.values()) for k, v in JAX_SHAPES.items()}
    for arch in ARCH_IDS:
        for name in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[name]) == \
                jax_shape_applicable(jax_get_config(arch), JAX_SHAPES[name]), (arch, name)


@pytest.mark.parametrize("frontend", [(0, 0), (8, 64)])
def test_batch_specs_match_the_reference(frontend):
    got = batch_specs(512, 4, 16, *frontend)
    want = jax_batch_specs(512, 4, 16, *frontend)
    assert set(got) == set(want)
    for k, spec in want.items():
        assert tuple(got[k].shape) == spec.shape, k
        assert str(got[k].dtype).replace("torch.", "") == str(spec.dtype), k


def _reference_flops(arch: str, B: int, S: int) -> float:
    """FLOPs of the reference's jitted f32 forward, by its HLO walk."""
    cfg = jax_reduced_config(arch)
    params = jax.eval_shape(lambda: jax_init_params(jax.random.key(0), cfg))
    fn = jax.jit(lambda p, t: jax_forward(p, cfg, t,
                                          opts=JaxModelOptions(compute_dtype="float32")))
    text = fn.lower(params, jax.ShapeDtypeStruct((B, S), jnp.int32)).compile().as_text()
    return analyze(text).flops


def _forward_count(cfg, B: int, S: int, attn_impl: str, mode: str):
    with FakeTensorMode():
        params = init_params(cfg, seed=0, device="cpu")
        tokens = torch.empty((B, S), dtype=torch.int32)
        with torch.no_grad():
            _, totals = count(forward, params, cfg, tokens, mode=mode,
                              shapes_only=mode == "kernel",
                              opts=ModelOptions(compute_dtype="float32",
                                                attn_impl=attn_impl))
    return totals


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-14b"])
def test_forward_flops_equal_the_reference_hlo(arch):
    """Plain mode on the plain path counts what the reference's XLA
    forward computes; kernel mode on the kernel path trades each layer's
    full score and P V products (2 x 2 B H S^2 D) for the flash kernel's
    cost (the causal pairs, with its LSE) and adds the norms' costs."""
    B, S = 2, 64
    cfg = reduced_config(arch)
    plain = _forward_count(cfg, B, S, "plain", "plain")
    ref = _reference_flops(arch, B, S)
    assert plain.flops == pytest.approx(ref, rel=FLOPS_RTOL)

    kernel = _forward_count(cfg, B, S, "kernel", "kernel")
    L, H, KV, D, d = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    flash = flash_attention.cost(B, S, H, KV, D, torch.float32, lse=True).flops
    norms = (2 * L + 1) * 4 * B * S * d
    if cfg.qk_norm:
        norms += L * 4 * B * S * (H + KV) * D
    want = plain.flops - L * 4 * B * H * S * S * D + L * flash + norms
    assert kernel.flops == pytest.approx(want, rel=FLOPS_RTOL)
    assert kernel.by_kernel["flash_attention"]["calls"] == L


def _paged_lengths(B: int, max_len: int) -> list:
    return [max(1, max_len - (max_len * i) // (B + 1)) for i in range(B)]


def _dense_lengths(B: int, Smax: int) -> list:
    return [Smax + 1] + [max(1, Smax - (Smax * i) // B) for i in range(1, B)]


BF16, F32 = torch.bfloat16, torch.float32
# PERF.md section 6, rows 1-7: (row, the cost, its dtype, the row's bound ms)
BOUND_ROWS = [
    ("1", lambda: rmsnorm.cost(8, 2048, BF16), BF16, 0.0000220),
    ("2", lambda: paged_decode_attention.cost(8, 8, 1, 256, 16, 64, BF16,
                                              lengths=_paged_lengths(8, 1024)), BF16, 0.001565),
    ("3", lambda: decode_attention.cost(8, 8, 1, 256, 1024, BF16,
                                        lengths=_dense_lengths(8, 1024)), BF16, 0.001428),
    ("4", lambda: flash_attention.cost(1, 1024, 8, 1, 256, BF16, lse=True), BF16, 0.004347),
    ("5", lambda: flash_attention_bwd.cost(1, 1024, 8, 1, 256, BF16), BF16, 0.010857),
    ("6", lambda: rglru_scan.cost(1 * 4096 * 4096), F32, 0.060097),
    ("6b", lambda: rglru_scan_bwd.cost(1 * 4096 * 4096), F32, 0.1002),
    ("7", lambda: mlstm_chunk.cost(1, 2048, 4, 384, BF16, chunk=128, final=True), BF16,
     0.010116),
    ("7b", lambda: mlstm_chunk_bwd.cost(2, 1024, 4, 384, BF16, chunk=128), BF16, 0.0301),
]


@pytest.mark.parametrize("row", BOUND_ROWS, ids=[r[0] for r in BOUND_ROWS])
def test_kernel_costs_give_the_perf_table_bounds(row):
    _name, cost, dtype, want_ms = row
    c = cost()
    peak = HW["peak_flops_bf16"] if dtype == BF16 else HW["peak_flops_f32"]
    ms = max(c.bytes / HW["hbm_bw"], c.flops / peak) * 1e3
    assert ms == pytest.approx(want_ms, rel=BOUND_RTOL)


def test_roofline_terms_and_dominant():
    terms = roofline_terms(HW["peak_flops_bf16"], 0.0, 0.0, 256)  # 1 s of pure compute
    assert terms["compute_s"] == pytest.approx(1.0)
    assert terms["dominant"] == "compute"
    assert terms["roofline_fraction_compute"] == pytest.approx(1.0)
    terms = roofline_terms(HW["peak_flops_bf16"] / 100, HW["hbm_bw"] * 4, 0.0, 256)
    assert terms["dominant"] == "memory"
    assert terms["roofline_fraction_compute"] == pytest.approx(0.01 / 4.0)
    terms = roofline_terms(0.0, 0.0, HW["internode_bw"], 256, torch.float32)
    assert terms["dominant"] == "collective" and terms["collective_s"] == pytest.approx(1.0)
    assert roofline_terms(HW["peak_flops_f32"], 0, 0, 1, torch.float32)["compute_s"] == \
        pytest.approx(1.0)


def _gather_bytes(nbytes: int, spec: tuple, mesh) -> dict:
    """Bytes this rank receives gathering a leaf from its shard of
    ``nbytes`` over ``spec``'s axes, by key: a dim split over (a, b)
    gathers over b, then a."""
    got, size = {}, nbytes
    for part in spec:
        for axis in reversed(spec_axes(part)):
            n = mesh.shape[axis]
            if n > 1:
                key = f"all_gather/{axis}/g{n}"
                got[key] = got.get(key, 0) + (n - 1) * size
                size *= n
    return got


def _sum_bytes(numel: int, n: int, es: int = 4) -> int:
    """Bytes a rank receives in ``ordered_sum`` of ``numel`` elements over n
    ranks: the all-to-all's and the all-gather's n - 1 blocks each."""
    return 2 * (n - 1) * -(-numel // n) * es


def _add(d: dict, key: str, v) -> None:
    d[key] = d.get(key, 0) + v


def _step_count(cfg, shape):
    """Rank 0's kernel-mode count of one mesh train step (f32, no remat) of
    8 x 32 tokens on an abstract mesh of ``shape``: (the step's metrics,
    Totals, the whole parameters, the mesh)."""
    mesh = abstract_mesh(shape)
    tcfg = TrainConfig(remat=False)
    fake = FakeTensorMode()
    with fake:
        state = init_train_state(cfg, tcfg, device="cpu", mesh=mesh)
        whole = init_params(cfg, device="cpu")
    state["step"] = 0
    batch = batch_specs(cfg.vocab_size, 8, 32, mode=fake)
    step = make_train_step(cfg, tcfg, ModelOptions(compute_dtype="float32"), mesh=mesh,
                           act_rules=activation_rules())
    with fake:
        (_, metrics), totals = count(step, state, batch)
    return metrics, totals, whole, mesh


def test_abstract_mesh_train_step_collectives_follow_the_specs():
    """Rank 0 of an abstract (2, 2, 2) mesh, reduced qwen3-14b (heads, KV
    heads, ff and vocab all split over model), byte for byte by key:

    - ``all_gather/data``: each leaf gathered over ``data`` only (its
      ``model`` block is what the tensor-parallel compute reads);
    - ``ordered_reduce_scatter/pod,data`` and ``all_gather/pod``: each
      gradient split over ``data`` reduce-scattered over the 4 batch ranks
      into this rank's (pod's share of its) data block, then gathered
      across the 2 pods; ``ordered_sum/pod,data`` the leaves not split over
      ``data`` summed whole, and the step's scalars (the global token
      count, the loss and each metric);
    - ``ordered_sum/data`` and ``ordered_sum/model``: the global norm's
      squares of the leaves split over each axis, one vector a split;
    - ``ordered_sum/model``: the activations: the embedding's lookup
      (forward), each attention and MLP block's input (backward) and output
      (forward), the head's input (backward), the qk-norm scales' gradients
      (backward), and the cross-entropy's sums of exponentials and label
      logits; ``ordered_max/model`` its row maxima."""
    cfg = reduced_config("qwen3-14b")
    metrics, totals, whole, mesh = _step_count(cfg, (2, 2, 2))
    want, split = {}, {}
    n_model, n_data, n_pod = mesh.shape["model"], mesh.shape["data"], mesh.shape["pod"]

    def add(names, p, s):
        tp = tensor_parallel(names)
        gspec = tuple(None if tp and part == "model" else part for part in s)
        at_rest = p.numel() // math.prod(mesh.size(spec_axes(part)) for part in s)
        for k, v in _gather_bytes(at_rest * 4, gspec, mesh).items():
            _add(want, k, v)
        numel = p.numel() // (n_model if "model" in s and tp else 1)  # the computed leaf
        if "data" in gspec:
            m = -(-numel // n_data // n_pod)
            _add(want, "ordered_reduce_scatter/pod,data/g4", 3 * m * 4)
            _add(want, "all_gather/pod/g2", (n_pod - 1) * m * 4)
        else:
            _add(want, "ordered_sum/pod,data/g4", _sum_bytes(numel, 4))
        axes = tuple(a for a in ("data", "model") if a in s)
        split[axes] = split.get(axes, 0) + 1

    named = []
    map_specs(lambda names, s: named.append((names, s)), whole, mesh, mesh_rules(mesh))
    for (names, s), p in zip(named, leaves(whole)):
        add(names, p, s)
    for axes, k in split.items():
        for a in axes:
            _add(want, f"ordered_sum/{a}/g2", _sum_bytes(k, 2))
    # scalars: the global token count (loss_fn), the loss and each metric
    scalars = 2 + len([k for k in metrics if k not in ("loss", "grad_norm")])
    _add(want, "ordered_sum/pod,data/g4", scalars * _sum_bytes(1, 4))
    # activations over the model group: 8 x 32 rows over 4 batch ranks
    T = 8 * 32 // 4
    act = _sum_bytes(T * cfg.d_model, n_model)
    L = cfg.num_layers
    _add(want, "ordered_sum/model/g2", (1 + 4 * L + 1) * act
         + 2 * L * _sum_bytes(cfg.head_dim, n_model) + 2 * _sum_bytes(T, n_model))
    _add(want, "ordered_max/model/g2", (n_model - 1) * T * 4)
    assert totals.coll_by_key == pytest.approx(want)
    assert totals.coll_bytes == pytest.approx(sum(want.values()))


def test_tensor_parallel_flops_drop_by_the_split_products():
    """Rank 0's counted FLOPs of reduced qwen3-14b's step (8 x 32 tokens,
    f32, no remat) on an abstract (1, 1, 4) mesh against (1, 1, 1): lower
    by 3/4 of the MLP's and the head's products and of the query and
    output projections, half the K/V projections (the 2 KV heads stay
    whole, and a rank reads the one its query head maps to), each forward
    product counted with its two backward ones; and by the flash kernels'
    and the qk-norms' costs at 4 heads against 1."""
    cfg = reduced_config("qwen3-14b")
    _, one, _, _ = _step_count(cfg, (1, 1, 1))
    _, tp, _, _ = _step_count(cfg, (1, 1, 4))
    T, d, hd, L = 8 * 32, cfg.d_model, cfg.head_dim, cfg.num_layers
    H, KV, ff, V = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.padded_vocab
    mm = 2 * T * d  # flops of a product of the tokens by one output column
    saved = 3 * L * mm * (0.75 * (2 * H * hd + 3 * ff) + 0.5 * 2 * KV * hd) + 3 * mm * 0.75 * V
    for h, kv, sign in ((H, KV, 1), (H // 4, 1, -1)):
        saved += sign * L * (flash_attention.cost(8, 32, h, kv, hd, torch.float32,
                                                  lse=True).flops
                             + flash_attention_bwd.cost(8, 32, h, kv, hd, torch.float32).flops
                             + rmsnorm.cost(T * h, hd, torch.float32).flops
                             + rmsnorm.cost(T * kv, hd, torch.float32).flops)
    assert one.flops - tp.flops == pytest.approx(saved, rel=FLOPS_RTOL)
    assert tp.flops < one.flops


def test_expert_parallel_flops_drop_by_the_expert_products():
    """Rank 0's counted FLOPs of reduced deepseek-moe-16b's step (8 x 32
    tokens in 4 routing groups of 64, capacity 20; f32, no remat) on an
    abstract (1, 1, 4) mesh against (1, 1, 1): lower by 3/4 of the routed
    experts' products (2 of the 8 experts a rank), of the dispatch and
    combine products (over a rank's 2 x 20 slots a group), and of the
    shared experts' products (a quarter of their width), each forward
    product with its backward ones (two, and one for the dispatch, whose
    0/1 operand has no gradient); and by the tensor-parallel products
    and flash costs of the attention, the dense MLP and the head.  The
    router is whole on every rank."""
    cfg = reduced_config("deepseek-moe-16b")
    _, one, _, _ = _step_count(cfg, (1, 1, 1))
    _, tp, _, _ = _step_count(cfg, (1, 1, 4))
    T, d, hd, L = 8 * 32, cfg.d_model, cfg.head_dim, cfg.num_layers
    H, KV, ff, V = cfg.num_heads, cfg.num_kv_heads, cfg.first_dense_ff, cfg.padded_vocab
    m = cfg.moe
    E, de, ds, g = m.num_experts, m.d_expert, m.num_shared * m.d_expert, m.group_size
    groups, C = T // g, moe_capacity(m, g)
    mm = 2 * T * d  # flops of a product of the tokens by one output column
    saved = 3 * mm * 0.75 * (L * 2 * (H + KV) * hd + 3 * ff + V)
    for h, kv, sign in ((H, KV, 1), (H // 4, KV // 4, -1)):
        saved += sign * L * (flash_attention.cost(8, 32, h, kv, hd, torch.float32,
                                                  lse=True).flops
                             + flash_attention_bwd.cost(8, 32, h, kv, hd, torch.float32).flops)
    slots = 2 * groups * E * C  # 2 x the rows of a product over every group's slots
    saved += 0.75 * (3 * 3 * slots * d * de + (2 + 3) * slots * g * d + 3 * 3 * mm * ds)
    assert one.flops - tp.flops == pytest.approx(saved, rel=FLOPS_RTOL)
    assert tp.flops < one.flops / 3


def test_whole_experts_where_the_model_axis_does_not_divide_them():
    """Full width on the (16, 16) mesh: qwen2-moe-a2.7b's 60 routed experts
    do not split over 16 ranks, so ``fit_spec`` keeps them whole (as the
    reference's does) and every rank computes on them whole, while its
    shared experts (width 5632) are model-local; deepseek-moe-16b's 64
    routed experts are model-local too.  The router is gathered whole."""
    mesh = abstract_mesh((16, 16), ("data", "model"))
    for arch, routed_split in (("qwen2-moe-a2.7b", False), ("deepseek-moe-16b", True)):
        cfg = get_config(arch).with_(num_layers=2)
        at_rest = []
        map_specs(lambda names, s: at_rest.append((names, s)),
                  abstract_train_state(cfg)["params"], mesh, mesh_rules(mesh))
        plans = leaves(_leaf_plans(cfg, mesh, PARAM_RULES, "model"))
        local = {}  # the MoE leaves' model-local dims
        for (names, spec), plan in zip(at_rest, plans):
            if "moe" in names:
                local["/".join(names[-2:])] = [i for i, (a, b) in enumerate(
                    zip(spec, plan.gather)) if a != b]
        assert local["moe/router"] == []
        for name in ("w_gate", "w_up", "w_down"):
            assert bool(local[f"moe/{name}"]) == routed_split, (arch, name, local)
            assert local[f"shared/{name}"], (arch, name, local)
        said = cells.train_model_axis(cfg, 16)
        assert ("whole on every rank: experts" in said) != routed_split, said


def _whole_recurrent(names: list) -> bool:
    """``specs.tensor_parallel`` with the RG-LRU and mLSTM layers and the
    sLSTM's FFN gathered whole for compute, as before they split."""
    return tensor_parallel(names) and not any(k in names for k in ("rglru", "mlstm", "slstm"))


def _recurrent_weights(cfg) -> int:
    """The weight elements of the products that split over the model axis
    in one pattern group's recurrent layers: the RG-LRU's five, the mLSTM's
    (its up projection, q, k, v, the gates' and the down projection), the
    sLSTM's FFN."""
    d, rnn, di, H = cfg.d_model, cfg.d_rnn or cfg.d_model, 2 * cfg.d_model, cfg.num_heads
    per = {"rglru": 3 * d * rnn + 2 * rnn * rnn,
           "mlstm": 2 * d * di + 3 * di * di + 2 * di * H + di * d,
           "slstm": 3 * d * slstm_ff(d)}
    return sum(per.get(k, 0) for k in cfg.block_pattern)


def _states_whole(local_cache):
    """``local_cache`` keeping the recurrent states whole over the model
    axis (only their rows split), as before they split."""
    def place(cache, specs, mesh):
        specs = {seg: ([{k: s if set(e) == {"k", "v"} else tuple(
            None if p == "model" else p for p in s) for k, s in e.items()} for e in specs[seg]]
            if seg in ("prefix", "main", "tail") else specs[seg]) for seg in specs}
        return local_cache(cache, specs, mesh)
    return place


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-125m"])
def test_recurrent_widths_split_over_the_model_axis(arch, shape_name, monkeypatch):
    """The dry-run's cell on (16, 16) at full width, one pattern group:
    rank 0's FLOPs drop, against the same cell with the recurrent layers
    gathered whole (their leaves over ``model``, and a decode cache's
    states), by 15/16 of the split products (the RG-LRU's channels, the
    mLSTM's inner width, the sLSTM's FFN; a train step's two backward
    products each, without remat, whose recompute skips a main group's
    last product where nothing saved reads it; a decode step's depthwise
    conv too) and of the RG-LRU scan kernels' work; ``all_gather/model``
    carries no recurrent weight (a
    decode step's is its queries' gather, less than one RG-LRU leaf); the
    model axis names the parts split, the mLSTM's recurrence over 4 heads
    and the sLSTM's cell whole."""
    cut = _one_group(arch)
    monkeypatch.setattr(cells, "get_config", lambda _a: cut)
    mesh = abstract_mesh((16, 16), ("data", "model"))
    shape = SHAPES[shape_name]
    opts = cells.CellOptions(train=TrainConfig(remat=False))
    cell = cells.build_cell(arch, shape_name, mesh, opts)
    _, split = cells.run_step(cell)
    with monkeypatch.context() as m:
        m.setattr(step_mod, "tensor_parallel", _whole_recurrent)
        m.setattr(cells, "local_cache", _states_whole(cells.local_cache))
        _, whole = cells.run_step(cells.build_cell(arch, shape_name, mesh, opts))
    rows = shape.global_batch // 16
    if shape.kind == "train":
        T = rows * shape.seq_len
        saved = 15 / 16 * 2 * T * _recurrent_weights(cut) * 3
        if "rglru" in cut.block_pattern:
            n = cut.block_pattern.count("rglru") * T * cut.d_rnn
            saved += 15 / 16 * (rglru_scan.cost(n).flops + rglru_scan_bwd.cost(n).flops)
    else:  # the products and each recurrent layer's step conv (W taps a channel)
        conv = sum({"rglru": cut.d_rnn, "mlstm": 2 * cut.d_model}.get(k, 0)
                   for k in cut.block_pattern)
        saved = 15 / 16 * 2 * rows * (_recurrent_weights(cut) + cut.conv_width * conv)
    assert whole.flops - split.flops == pytest.approx(saved, rel=FLOPS_RTOL)
    d_rnn = cut.d_rnn or cut.d_model
    assert split.coll_by_key.get("all_gather/model/g16", 0) < 15 / 16 * d_rnn * d_rnn * 2
    said = cell.meta["model_axis"]
    assert ("RG-LRU" in said.split(";")[0]) == ("rglru" in cut.block_pattern), said
    assert "whole on every rank: RG-LRU" not in said, said
    if arch == "xlstm-125m":
        assert "mLSTM, sLSTM FFN; whole on every rank: mLSTM recurrence, sLSTM cell" in said, said
        if shape.kind == "decode":
            assert "mLSTM state over conv channels, sLSTM state over channels" in said, said
    elif shape.kind == "decode":
        assert said.endswith("RG-LRU state over channels"), said


def _one_group(arch: str):
    """The arch at one pattern group (past its first dense layers): the
    cut that keeps every cell within the test's time."""
    cfg = get_config(arch)
    return cfg.with_(num_layers=cfg.first_dense + len(cfg.block_pattern))


RECORD_KEYS = {"status", "kind", "tokens", "batch_axes", "rows", "model_axis", "memory",
               "collectives", "roofline", "by_kernel", "count_s"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_applicable_cell_counts(arch, monkeypatch):
    """Every shape of every arch at full width, on the (16, 16) mesh,
    depth cut to one pattern group: ``ok``, or ``skipped`` for the
    reference's reason."""
    cut = _one_group(arch)
    monkeypatch.setattr(cells, "get_config", lambda _a: cut)
    monkeypatch.setattr(dryrun, "get_config", lambda _a: cut)
    for name in SHAPES:
        rec = dryrun.run_cell(arch, name, multi_pod=False, verbose=False)
        ok, why = jax_shape_applicable(jax_get_config(arch), JAX_SHAPES[name])
        if not ok:
            assert rec["status"] == "skipped" and rec["reason"] == why
            continue
        assert rec["status"] == "ok", rec.get("trace")
        assert RECORD_KEYS <= set(rec), set(rec)
        r = rec["roofline"]
        assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
        assert 0 < r["model_vs_counted_flops"] and rec["memory"]["peak_bytes"] > 0
        # every kind's compute is tensor-parallel over model (serving since
        # the sharded serve steps): its sums over model are collectives
        assert rec["collectives"], rec["collectives"]


def test_tree_attention_counts_the_reference_docstring_score_flops():
    """Plain mode counts the tree's products: its scores number S chunk
    (the diagonal blocks, masked) + S^2 / 2 - S chunk / 2 (the levels), its
    P V products as many, 2 B H D FLOPs each; at most the reference
    docstring's S chunk + S^2 / 2, at least the causal S^2 / 2, and under
    the plain masked softmax's S^2."""
    from repro_torch.models.layers import tree_causal_attention

    B, S, H, KV, D, c = 2, 256, 4, 2, 32, 32
    with FakeTensorMode():
        q = torch.empty((B, S, H, D))
        k, v = torch.empty((B, S, KV, D)), torch.empty((B, S, KV, D))
        _, tree = count(tree_causal_attention, q, k, v, c, mode="plain")
        _, full = count(_plain_attention, q, k, v, mode="plain")
    scores = S * c + S * S / 2 - S * c / 2
    assert tree.flops == 2 * (2 * B * H * D) * scores
    assert 2 * B * H * D * S * S / 2 < tree.flops / 2 <= 2 * B * H * D * (S * c + S * S / 2)
    assert tree.flops < full.flops == 2 * (2 * B * H * D) * S * S


def _plain_attention(q, k, v):
    from repro_torch.kernels.ref import causal_attention_ref

    return causal_attention_ref(q, k, v)


@pytest.mark.parametrize("arch,shape_name,flag", [
    ("gemma-2b", "train_4k", "--sequence-parallel"),
    ("deepseek-moe-16b", "decode_32k", "--shard-cache-seq"),
    ("gemma-2b", "train_4k", "--tree-attention")])
def test_dryrun_takes_the_reference_options(arch, shape_name, flag, tmp_path, monkeypatch):
    """The reference's three flags, on a cell cut to one pattern group,
    against the same cell without them: ``--sequence-parallel`` moves the
    activation sums over ``model`` to gathers and reduce-scatters (the
    stream over the sequence) and lowers the peak; ``--shard-cache-seq``
    puts deepseek-moe-16b's cache, whose 16 KV heads 16 ranks divide, over
    the sequence, merged by log-sum-exp; ``--tree-attention`` leaves the
    kernel path's count as it is."""
    cut = _one_group(arch)
    monkeypatch.setattr(cells, "get_config", lambda _a: cut)
    monkeypatch.setattr(dryrun, "get_config", lambda _a: cut)
    base, opt = (dryrun.main(["--arch", arch, "--shape", shape_name, "--out",
                              str(tmp_path / f"{i}.json"), *flags])[0]
                 for i, flags in enumerate(((), (flag,))))
    assert base["status"] == opt["status"] == "ok", opt.get("trace")
    coll, was = opt["collectives"], base["collectives"]
    if flag == "--sequence-parallel":
        assert opt["model_axis"].endswith("residual stream over the sequence"), opt["model_axis"]
        assert coll["ordered_sum/model/g16"] < 1e-3 * was["ordered_sum/model/g16"], coll
        assert coll["ordered_reduce_scatter/model/g16"] > 0, coll
        assert coll["gather_activations/model/g16"] > 0, coll
        assert opt["memory"]["peak_bytes"] < base["memory"]["peak_bytes"]
        assert opt["roofline"]["flops_per_device"] < base["roofline"]["flops_per_device"]
    elif flag == "--shard-cache-seq":
        assert base["model_axis"].endswith("cache: attention over KV heads"), base["model_axis"]
        assert opt["model_axis"].endswith("cache: attention over sequence"), opt["model_axis"]
        assert "merge_partials/model/g16" not in was and coll["merge_partials/model/g16"] > 0
        assert opt["memory"]["peak_bytes"] == base["memory"]["peak_bytes"]
    else:
        assert coll == was and opt["by_kernel"] == base["by_kernel"]
        assert opt["roofline"]["flops_per_device"] == base["roofline"]["flops_per_device"]


def test_dryrun_module_writes_a_record(tmp_path):
    out = tmp_path / "dry.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "gemma-2b",
         "--shape", "decode_32k", "--out", str(out)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    records = json.loads(out.read_text())
    assert len(records) == 1
    rec = records[0]
    assert rec["status"] == "ok" and RECORD_KEYS <= set(rec)
    # the sharded decode step: gemma-2b's 8 query heads whole over 16 ranks,
    # its MQA cache split over the sequence and the partials merged
    assert rec["memory"]["fits"] is True
    assert rec["model_axis"].endswith("cache: attention over sequence"), rec["model_axis"]
    assert rec["collectives"]["merge_partials/model/g16"] > 0, rec["collectives"]
    assert {"model_flops", "model_vs_counted_flops", "dominant"} <= set(rec["roofline"])


def test_one_shared_memory_opt_in():
    """Every opt-in to more dynamic shared memory goes through
    ``set_max_dynamic_smem``, which clears a failure."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    sites = [p.name for p in sorted(csrc.iterdir())
             if "cudaFuncSetAttribute" in p.read_text()]
    assert sites == ["common.cuh"]
