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
from repro_torch.convert import zip_params
from repro_torch.data import batch_specs
from repro_torch.kernels import (decode_attention, flash_attention, flash_attention_bwd,
                                 mlstm_chunk, mlstm_chunk_bwd, paged_decode_attention,
                                 rglru_scan, rglru_scan_bwd, rmsnorm)
from repro_torch.launch import cells, dryrun
from repro_torch.launch.mesh import HW, abstract_mesh
from repro_torch.launch.op_analysis import count
from repro_torch.launch.roofline import roofline_terms
from repro_torch.models import ModelOptions, forward, init_params
from repro_torch.sharding import activation_rules
from repro_torch.sharding.specs import param_specs, spec_axes
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.train.step import mesh_rules

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
    """Bytes this rank receives gathering a leaf of ``nbytes`` whole from
    its shard, by key: a dim split over (a, b) gathers over b, then a."""
    got = {}
    size = nbytes // math.prod(mesh.size(spec_axes(part)) for part in spec)
    for part in spec:
        for axis in reversed(spec_axes(part)):
            n = mesh.shape[axis]
            if n > 1:
                key = f"all_gather/{axis}/g{n}"
                got[key] = got.get(key, 0) + (n - 1) * size
                size *= n
    return got


def test_abstract_mesh_train_step_collectives_follow_the_specs():
    """Rank 0 of an abstract (2, 2, 2) mesh: each leaf gathered whole over
    its spec's axes, then every gradient and the step's scalars gathered
    from the 4 batch ranks for their sums in rank order."""
    cfg = reduced_config("qwen3-14b")
    mesh = abstract_mesh((2, 2, 2))
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
    specs = param_specs(whole, mesh, mesh_rules(mesh))
    want, leaves = {}, []

    def add(p, s):
        leaves.append(p)
        for k, v in _gather_bytes(p.numel() * 4, s, mesh).items():
            want[k] = want.get(k, 0) + v
        return p

    zip_params(add, whole, specs)
    # scalars: the global token count (loss_fn), the loss and each metric
    scalars = 2 + len([k for k in metrics if k not in ("loss", "grad_norm")])
    batch_key = "all_gather/pod,data/g4"
    want[batch_key] = want.get(batch_key, 0) + 3 * (sum(p.numel() for p in leaves) + scalars) * 4
    assert totals.coll_by_key == pytest.approx(want)
    assert totals.coll_bytes == pytest.approx(sum(want.values()))


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
        if rec["kind"] == "train":
            assert rec["collectives"], rec["collectives"]


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
    assert rec["memory"]["fits"] is True and rec["model_axis"] == "replicated"
    assert {"model_flops", "model_vs_counted_flops", "dominant"} <= set(rec["roofline"])


def test_one_shared_memory_opt_in():
    """Every opt-in to more dynamic shared memory goes through
    ``set_max_dynamic_smem``, which clears a failure."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    sites = [p.name for p in sorted(csrc.iterdir())
             if "cudaFuncSetAttribute" in p.read_text()]
    assert sites == ["common.cuh"]
