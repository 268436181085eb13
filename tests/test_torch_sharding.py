"""The port's sharded training against the JAX package's, on the CPU.

Pure data first: every leaf's logical axes and partition spec, and the
int8 error-feedback quantizer, against the reference on the same inputs.
Then real worlds of gloo ranks, one process per rank (``WORKER`` below,
one thread each), driving the port's mesh train step on the reference's
converted weights and batches:

- reduced qwen3-14b on (pod, data, model) = (2, 2, 2), two steps, held to
  JAX's single-device step and the port's with the bounds of
  ``tests/test_sharding_multi.py:75-78`` (the reference's own sharded step
  cannot run on this JAX: ROADMAP.md, item G), twice with equal bits, each
  rank's shards shaped as the reference's ``fit_spec`` partitions them;
- reduced gemma-2b on (2, 2, 2) with ``compress_pod_grads`` against the
  uncompressed mesh step (``:120-124``) and against a JAX composition of
  the reference's ``loss_fn`` per pod half, ``ef_quantize_mean``,
  ``clip_by_global_norm`` and ``adamw_update``;
- reduced deepseek-moe-16b on (2, 2, 1): the loss with its load-balance
  term, which is nonlinear in the batch, against JAX's single-device step;
  and the routing groups a rank cannot hold whole, refused;
- every leaf's partition names each mesh axis once, and every rank's
  block of it, gathered as the mesh step gathers it, gives it back;
- tensor-parallel compute on (1, 1, 4): reduced qwen3-14b (query heads
  split, its 2 KV heads whole), musicgen-large (heads split, a plain MLP,
  the audio frontend), deepseek-moe-16b (attention and the dense MLP
  split, expert-parallel: 2 of the 8 experts a rank, the shared experts
  column- and row-parallel; the einsum dispatch, and the sort dispatch
  with remat and the backward on another thread), qwen2-moe-a2.7b (the
  sigmoid shared gate, QKV bias), recurrentgemma-9b (the RG-LRU's
  channels split) and xlstm-125m (the mLSTM's inner width and heads split,
  the sLSTM's FFN; with remat and the backward on another thread) against
  the single-device steps, reruns equal bit for bit, each rank's compute
  leaves model-local; and the rank-ordered collectives against a gather of
  every rank's copy;
- tensor-parallel serving on the same (1, 1, 4) world (``SERVE_JOBS``):
  the sharded prefill and decode steps with the decode cache placed as the
  reference's ``cache_specs``, one reduced config per placement (KV heads
  split; the sequence split with the query heads whole; the sequence split
  with the query heads split, a GQA config and a wrapped ring buffer with
  RG-LRU states split by channel; xlstm-125m's mLSTM states split by head
  and its sLSTM's by channel), each rank's logits gathered over the
  vocabulary against JAX's and the port's single-device steps, greedy
  tokens equal, the heads-whole merge equal bit for bit on every rank,
  each rank's cache shaped as the reference's shards;
- sequence parallelism on the same (1, 1, 4) world (``SP_JOBS``): the
  residual stream split over the sequence between blocks, in the remat
  qwen3-14b job with the backward on another thread and the MoE,
  RG-LRU and xLSTM jobs, each held to the single-device steps as its
  tensor-parallel job is, its first-step gradients leaf by leaf, and its
  norm scales' gradients (each rank computes a part of them) to the
  tensor-parallel job's; the sequence-split qwen3-14b prefill with the
  stream split, and the deepseek-moe-16b serving job with
  ``shard_cache_seq``, its cache over the sequence with every KV head;
- the port's ``cache_specs`` against the reference's leaf by leaf for
  every arch's decode cells on both production meshes, with and without
  ``shard_cache_seq`` (where the reference's spec names ``model`` on the
  positions and on the KV heads, which its own ``NamedSharding`` refuses,
  the later repeat dropped), and ``local_cache``'s blocks shaped as the
  reference's shards.
"""

import contextlib
import functools
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import reduced_config as jax_reduced_config
from repro.data import StreamSource as JaxStreamSource
from repro.models import ModelOptions as JaxModelOptions
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import shape_applicable as jax_shape_applicable
from repro.launch import cells as jax_cells
from repro.models import decode_step as jax_decode_step
from repro.models import forward_with_cache as jax_forward_with_cache
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.serve.engine import _merge_slot as jax_merge_slot
from repro.sharding import ctx as jax_ctx
from repro.sharding import specs as jax_specs
from repro.train import OptimizerConfig as JaxOptimizerConfig
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import adamw_update as jax_adamw_update
from repro.train import clip_by_global_norm as jax_clip_by_global_norm
from repro.train import compress as jax_compress
from repro.train import init_train_state as jax_init_train_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import get_config as get_config_port
from repro_torch.configs import reduced_config
from repro_torch.convert import map_params, params_from_numpy, params_to_numpy
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import ModelOptions, decode_step, forward_with_cache, init_cache, loss_fn
from repro_torch.sharding import ctx, specs
from repro_torch.train import (
    OptimizerConfig,
    TrainConfig,
    abstract_train_state,
    compress,
    init_train_state,
    make_train_step,
    train_state_specs,
)
from repro_torch.train.optim import leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(2, 2, 2), (1, 2, 4), (4, 2, 1)]
AXES = ("pod", "data", "model")
# the bounds of tests/test_sharding_multi.py: loss and parameters after two
# steps (:77-78); the compressed step's loss and grad norm against the
# uncompressed one (:120-124)
LOSS_TOL, PARAM_TOL = 1e-3, 1e-4
COMP_LOSS_TOL, COMP_GNORM_RTOL = 1e-2, 0.1
# a mesh step's first mean gradient against the single-device one, each
# leaf of its largest entry (f32 sums in another order)
GRAD_RTOL = 1e-4
# the compressed combine against the reference's on the same per-pod
# gradients: within one int8 quantum (scale / npods) everywhere, and within
# REL_TOL relative on all but a share under OFF_SHARE of the elements (those
# at a rounding tie)
REL_TOL, OFF_SHARE = 1e-6, 1e-3
# The two packages' per-pod gradients part by f32 rounding (the reduced
# gemma's init gives a grad norm near 100), so their int8 scales differ by
# up to ~1e-4 relative and move every dequantized entry by as much: against
# independently computed gradients the 1e-6 bound cannot hold, so the
# combine is held to it on the same gradients, and the step's mean to one
# quantum widened by the scales' measured difference
# an optimizer whose two steps the parameter bound can see (as
# tests/test_torch_train.py::STEP_OPT)
STEP_OPT = {"lr": 1e-2, "warmup_steps": 4, "eps": 1e-4}
WORLD_TIMEOUT_S = 240


def _flat(tree, path="") -> dict:
    """path -> leaf of a nested dict/list tree; tuples are leaves (specs)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}[{k!r}]"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}[{i}]"))
        return out
    return {path: tree}


def _ref_spec(logical: tuple, shape: tuple, sizes: dict) -> tuple:
    """The reference's ``fit_spec`` of a leaf, each mesh axis left on the
    first dim that names it (``specs.fit_spec``)."""
    spec, used = [], set()
    for p in tuple(jax_specs.fit_spec(jax_specs.logical_to_spec(logical, jax_specs.PARAM_RULES),
                                      shape, SimpleNamespace(shape=sizes))):
        axes = set(specs.spec_axes(p))
        spec.append(None if axes & used else p)
        used |= axes
    return tuple(spec)


def _shard_shape(shape: tuple, spec: tuple, sizes: dict) -> tuple:
    return tuple(d // int(np.prod([sizes[a] for a in specs.spec_axes(p)]))
                 for d, p in zip(shape, tuple(spec) + (None,) * len(shape)))


@functools.lru_cache(maxsize=None)
def _jax_abstract(arch):
    return jax.eval_shape(lambda: jax_init_params(jax.random.key(0),
                                                  jax_reduced_config(arch)))


# -------------------------------------------------------------- specs


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_axes_match_reference(arch):
    want = _flat(jax_specs.param_logical_axes(_jax_abstract(arch)))
    got = _flat(specs.param_logical_axes(
        abstract_train_state(reduced_config(arch))["params"]))
    assert got == want


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_partition_specs_match_reference(arch, shape):
    """``param_specs`` and ``train_state_specs`` against the reference's
    ``fit_spec`` (which reads only ``mesh.shape``) leaf by leaf, a mesh axis
    that it leaves on two dims (the mLSTM's ``wq (ff, heads, dk)`` where
    ``model`` divides both) kept on the first only: the reference's own
    ``NamedSharding`` refuses the spec that names it twice."""
    sizes = dict(zip(AXES, shape))
    mesh = SimpleNamespace(shape=sizes)
    abstract = _jax_abstract(arch)
    logical = _flat(jax_specs.param_logical_axes(abstract))
    want = {k: _ref_spec(logical[k], leaf.shape, sizes) for k, leaf in _flat(abstract).items()}
    for k, leaf in _flat(abstract).items():
        fitted = jax_specs.fit_spec(jax_specs.logical_to_spec(logical[k], jax_specs.PARAM_RULES),
                                    leaf.shape, mesh)
        if tuple(fitted) != want[k]:
            with pytest.raises(Exception) as refused:
                jax.sharding.NamedSharding(jax.sharding.AbstractMesh(shape, AXES), fitted)
            assert type(refused.value).__name__ == "DuplicateSpecError", refused.value
    state = abstract_train_state(reduced_config(arch),
                                 TrainConfig(compress_pod_grads=True, num_pods=shape[0]))
    got = train_state_specs(state, sizes)
    assert _flat(specs.param_specs(state["params"], sizes)) == want
    assert _flat(got["params"]) == want and _flat(got["opt"]["m"]) == want
    assert _flat(got["ef"]) == {k: ("pod",) + v for k, v in want.items()}


class _Ranks:
    """Every rank's view of an abstract mesh, and ``gather_leaf`` run on all
    of them at once, in one process."""

    def __init__(self, shape):
        self.meshes = [abstract_mesh(shape, AXES, rank=r) for r in range(int(np.prod(shape)))]

    def blocks(self, full, spec) -> list:
        return [specs.local_block(full, spec, m) for m in self.meshes]

    def gather(self, blocks: list, spec) -> list:
        """What each rank's ``collectives.gather_leaf`` of its block
        returns: over each split dim, the minor axis first, the blocks of
        the ranks that differ only along the axis joined in its order."""
        x = list(blocks)
        for dim, part in enumerate(spec):
            for axis in reversed(specs.spec_axes(part)):
                def peers(m):
                    return sorted((q for q in self.meshes if all(
                        q.coords[a] == m.coords[a] for a in AXES if a != axis)),
                        key=lambda q: q.coords[axis])
                x = [torch.cat([x[q.rank] for q in peers(m)], dim) for m in self.meshes]
        return x


@pytest.mark.parametrize("shape", MESHES + [(1, 1, 2)])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_partition_names_each_axis_once_and_gathers_back(arch, shape):
    """Every leaf's partition names each mesh axis at most once, and every
    rank's block of a leaf (``local_block``), gathered as the mesh step
    gathers it (``gather_leaf``, emulated on all ranks at once), gives the
    leaf back exactly on every rank."""
    ranks = _Ranks(shape)
    state = abstract_train_state(reduced_config(arch))
    named = []
    specs.map_specs(lambda names, s: named.append(("/".join(names), s)), state["params"],
                    ranks.meshes[0], specs.mesh_rules(ranks.meshes[0]))
    gen = torch.Generator().manual_seed(0)
    for (name, spec), leaf in zip(named, leaves(state["params"])):
        axes = [a for p in spec for a in specs.spec_axes(p)]
        assert len(axes) == len(set(axes)), (name, spec)
        full = torch.randn(tuple(leaf.shape), generator=gen)
        for got in ranks.gather(ranks.blocks(full, spec), spec):
            assert torch.equal(got, full), (name, spec)


def test_activation_rules_and_resolve_match_reference():
    for kw in ({}, {"sequence_parallel": True, "shard_cache_seq": True},
               {"data_axes": ("data",), "model_axis": "model"}):
        rules = ctx.activation_rules(**kw)
        assert rules == jax_ctx.activation_rules(**kw)
        for axes in (("batch", "seq", "embed"), ("dp", None, "expert", None),
                     ("batch", None, "heads", None), ("unknown",)):
            # PartitionSpec writes a one-axis tuple as the axis
            got = tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                        for p in ctx.resolve(axes, rules))
            assert got == tuple(jax_ctx.resolve(axes, rules))
    x = torch.ones(2)
    assert ctx.shard(x, ("batch",)) is x
    assert ctx.loss_group() == (None, 1)


# ---------------------------------------------------------- compression


def _near_half(x: np.ndarray, scale) -> np.ndarray:
    """Where ``x / scale`` lies within an ulp of a half-integer: the two
    packages' divisions may round it to either side."""
    y = (x / scale).astype(np.float32)
    frac = np.abs(y - np.trunc(y))
    return np.abs(frac - 0.5) <= 2 * np.spacing(np.abs(y).astype(np.float32))


def _arrays(seed, shape):
    rng = np.random.default_rng(seed)
    # magnitudes spread over decades, as gradients' are
    return (rng.standard_normal(shape) * np.exp(rng.uniform(-6, 2, shape))).astype(np.float32)


@pytest.mark.parametrize("shape,seed", [((1000,), 0), ((64, 96), 1), ((4, 8, 33), 2)])
def test_quantize_int8_matches_reference(shape, seed):
    x = _arrays(seed, shape)
    jq, js = jax_compress.quantize_int8(jnp.asarray(x))
    q, s = compress.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.item() == float(js)
    near = _near_half(x, float(js))
    off = q.numpy() != np.asarray(jq)
    assert not (off & ~near).any(), "int8 payloads differ off a rounding tie"
    assert np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 1
    print(f"{near.sum()} of {x.size} elements within an ulp of a tie, "
          f"{off.sum()} rounded the other way")


@pytest.mark.parametrize("npods,shape", [(1, (300,)), (2, (48, 40)), (4, (6, 5, 7))])
def test_ef_quantize_mean_matches_reference(npods, shape):
    """Two rounds of the combine (the second with the first's EF buffers)
    on the same seeded gradients: means and buffers bit for bit, apart from
    elements at a rounding tie (counted), where one pod's payload moves by
    one quantum."""
    g = {"a": _arrays(10 + npods, (npods, *shape)), "b": _arrays(20 + npods, (npods, 3))}
    ef_j = jax_compress.init_ef_state({k: jnp.asarray(v[0]) for k, v in g.items()}, npods)
    ef_t = compress.init_ef_state({k: torch.from_numpy(v[0]) for k, v in g.items()}, npods)
    ties = 0
    for _round in range(2):
        mean_j, new_j = jax_compress.ef_quantize_mean(
            {k: jnp.asarray(v) for k, v in g.items()}, ef_j)
        mean_t, new_t = compress.ef_quantize_mean(
            {k: torch.from_numpy(v) for k, v in g.items()}, ef_t)
        for k in g:
            corrected = g[k] + np.asarray(ef_j[k])
            scale = (np.maximum(np.abs(corrected).reshape(npods, -1).max(1), 1e-12)
                     / np.float32(127.0)).reshape((npods,) + (1,) * len(shape))
            near = _near_half(corrected, scale)
            ties += int(near.sum())
            assert not ((new_t[k].numpy() != np.asarray(new_j[k])) & ~near).any(), \
                "EF buffers differ off a rounding tie"
            if near.any():
                np.testing.assert_allclose(mean_t[k].numpy(), np.asarray(mean_j[k]), rtol=0,
                                           atol=1.001 * scale.max() / npods)
            else:
                np.testing.assert_array_equal(mean_t[k].numpy(), np.asarray(mean_j[k]))
        ef_j, ef_t = new_j, new_t
        g = {k: v * np.float32(0.5) + np.float32(1e-3) for k, v in g.items()}
    print(f"{ties} elements within an ulp of a rounding tie")


def test_quantize_int8_rounds_ties_to_even_as_reference():
    """A largest entry of 127 makes the scale exactly 1: every x.5 is a tie,
    which both round to the even neighbour."""
    x = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5, 3.25], np.float32)
    jq, js = jax_compress.quantize_int8(jnp.asarray(x))
    q, s = compress.quantize_int8(torch.from_numpy(x))
    assert s.item() == float(js) == 1.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.tolist() == [127, 2, -4, 0, 0, 2, 126, -126, 3]


# -------------------------------------------------------------- worlds

# One rank of a gloo world: runs each job of ``in.pt`` on the mesh and saves
# what the tests read to ``out<rank>.pt``.  A compressed step's last
# combine is recorded: its input (this pod's gradient) and the mean gradient
# it gave, which the step clips, each gathered whole from the ranks'
# blocks.  The shapes of the leaves the model computes on are recorded.
WORKER = textwrap.dedent("""
    import functools
    import sys
    import threading
    import torch
    torch.set_num_threads(1)
    import repro_torch.train.step as step_mod
    from repro_torch.configs import reduced_config
    from repro_torch.convert import map_params, zip_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ModelOptions
    from repro_torch.sharding.collectives import (gather_leaf, gather_stack, ordered_max,
                                                  ordered_reduce_scatter, ordered_sum)
    from repro_torch.models import lm as lm_mod
    from repro_torch.serve import make_decode_step, make_prefill_step
    from repro_torch.sharding.ctx import activation_rules, data_axes_for
    from repro_torch.sharding.specs import local_params
    from repro_torch.train import (OptimizerConfig, TrainConfig, abstract_train_state,
                                   init_train_state, make_train_step, train_state_specs)
    from repro_torch.train.step import mesh_rules

    root, rank, port = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    spec = torch.load(f"{root}/in.pt", weights_only=False)
    mesh = make_mesh(spec["mesh"], device="cpu", init_method=f"tcp://127.0.0.1:{port}",
                     rank=rank)
    seen = {}
    real_clip, real_combine = step_mod.clip_by_global_norm, step_mod.compressed_mean_over_axis

    def clip(grads, c, **kw):
        seen["mean_grads"] = map_params(lambda _k, g: g.clone(), grads)
        return real_clip(grads, c, **kw)

    def combine(grads, ef, group, *args):
        seen["pod_grads"] = map_params(lambda _k, g: g.clone(), grads)
        return real_combine(grads, ef, group, *args)

    real_grads = step_mod._grads_and_metrics

    def grads_and_metrics(params, *args):
        seen["compute_shapes"] = map_params(lambda _k, p: tuple(p.shape), params)
        return real_grads(params, *args)

    real_backward = torch.Tensor.backward

    def backward_on_a_thread(self, *args, **kwargs):
        failed = []

        def run():
            try:
                real_backward(self, *args, **kwargs)
            except BaseException as e:  # noqa: BLE001 - raised again below
                failed.append(e)

        t = threading.Thread(target=run)
        t.start()
        t.join()
        if failed:
            raise failed[0]

    step_mod.clip_by_global_norm = clip
    step_mod.compressed_mean_over_axis = combine
    step_mod._grads_and_metrics = grads_and_metrics
    out = {}
    for name, job in spec["jobs"].items():
        if name == "collectives":  # over the model group, at sizes n does not divide
            group, n = mesh.group(("model",)), mesh.shape["model"]
            gen = torch.Generator().manual_seed(rank)
            res = {}
            for numel in job["numels"]:
                x = torch.randn(numel, generator=gen) * torch.exp(
                    torch.randn(numel, generator=gen) * 4)
                copies = gather_stack(x, group, n)
                whole = functools.reduce(torch.add, copies.unbind(0))
                m = -(-numel // n)
                res[numel] = {
                    "sum": (ordered_sum(x, group, n), whole),
                    "scatter": (ordered_reduce_scatter(x, group, n),
                                torch.nn.functional.pad(whole, (0, m * n - numel))
                                [rank * m:(rank + 1) * m]),
                    "max": (ordered_max(x, group, n), copies.amax(0)),
                }
            out[name] = res
            continue
        if job.get("serve"):  # the sharded prefill, then greedy decode steps
            cfg = reduced_config(job["arch"]).with_(**job["mods"])
            opts = ModelOptions(compute_dtype="float32")
            batch_axes = data_axes_for(mesh, job["tokens"].shape[0])
            rules = activation_rules(data_axes=batch_axes, **job.get("rules", {}))
            params = local_params(spec["params"][name], mesh)
            prefill = make_prefill_step(cfg, opts, max_len=job["max_len"], mesh=mesh,
                                        act_rules=rules)
            decode = make_decode_step(cfg, opts, mesh=mesh, act_rules=rules)
            group, n = mesh.group(("model",)), mesh.shape["model"]
            merged = []
            real_split = lm_mod.seq_split_decode_attention

            def split(*args, **kwargs):  # the merged attention outputs, in call order
                merged.append(real_split(*args, **kwargs))
                return merged[-1]

            def whole(lg):  # this rank's rows and vocab block -> all of them
                lg = torch.cat(gather_stack(lg, group, n).unbind(0), -1)
                rows = mesh.group(batch_axes), mesh.size(batch_axes)
                return torch.cat(gather_stack(lg, *rows).unbind(0), 0)

            lm_mod.seq_split_decode_attention = split
            try:
                with torch.no_grad():
                    lg, cache = prefill(params, {"tokens": job["tokens"]})
                    logits, tokens = [whole(lg)], []
                    res = {"cache_shapes": [tuple(e["k"].shape) for e in cache["tail"]
                                            + cache["main"] + cache["prefix"] if "k" in e],
                           "leaf_shapes": {f"{seg}/{i}/{k}": tuple(x.shape)
                                           for seg in ("prefix", "main", "tail")
                                           for i, e in enumerate(cache[seg])
                                           for k, x in e.items()}}
                    for t in range(job["steps"]):
                        tokens.append(logits[-1][:, -1].argmax(-1) if t == 0
                                      else logits[-1].argmax(-1))
                        adv = job["advance"] if t == job["masked_step"] else None
                        lg, cache = decode(params, cache, tokens[-1].to(torch.int32), adv)
                        logits.append(whole(lg))
            finally:
                lm_mod.seq_split_decode_attention = real_split
            res.update(logits=logits, tokens=tokens, merged=merged, len=cache["len"])
            out[name] = res
            continue
        cfg = reduced_config(job["arch"])
        tcfg = TrainConfig(optimizer=OptimizerConfig(**job["opt"]),
                           remat=job.get("remat", False),
                           compress_pod_grads=job["compress"],
                           num_pods=mesh.shape["pod"] if job["compress"] else 1)
        params = map_params(lambda _k, p: p.clone(), spec["params"][job["arch"]])
        state = init_train_state(cfg, tcfg, params=params, mesh=mesh)
        step = make_train_step(cfg, tcfg, ModelOptions(compute_dtype="float32",
                                                       moe_impl=job.get("moe_impl")),
                               mesh=mesh, act_rules=activation_rules(**job.get("rules", {})))
        res = {"shapes": map_params(lambda _k, p: tuple(p.shape), state["params"]),
               "m_shapes": map_params(lambda _k, p: tuple(p.shape), state["opt"]["m"])}
        specs = train_state_specs(abstract_train_state(cfg, tcfg), mesh, mesh_rules(mesh))
        if job.get("backward_thread"):  # as autograd's device thread runs it on the card
            torch.Tensor.backward = backward_on_a_thread
        try:
            metrics = []
            for i, batch in enumerate(job["batches"]):
                seen.clear()
                state, m = step(state, batch)
                metrics.append({k: float(v) for k, v in m.items()})
                if i == 0 and len(job["batches"]) > 1:
                    res["params_1"] = zip_params(
                        lambda p, s: gather_leaf(p.detach(), s, mesh).clone(), state["params"],
                        specs["params"])
                if i == 0 and job.get("grads"):  # the first step's mean gradient, whole
                    res["grads_1"] = zip_params(lambda g, s: gather_leaf(g, s, mesh),
                                                seen["mean_grads"], specs["params"])
            res["compute_shapes"] = seen["compute_shapes"]
        except ValueError as e:
            res["error"] = str(e)
            out[name] = res
            continue
        finally:
            torch.Tensor.backward = real_backward
        res["metrics"] = metrics
        res["params"] = zip_params(lambda p, s: gather_leaf(p.detach(), s, mesh),
                                   state["params"], specs["params"])
        if job["compress"]:  # of the last step, each leaf whole from the ranks' blocks
            res.update({k: zip_params(lambda g, s: gather_leaf(g, s, mesh), seen[k],
                                      specs["params"]) for k in ("pod_grads", "mean_grads")})
            res["ef"] = zip_params(lambda e, s: gather_leaf(e, (None,) + s[1:], mesh)[0],
                                   state["ef"], specs["ef"])
        out[name] = res
    torch.save(out, f"{root}/out{rank}.pt")
    mesh.close()
""")


class _World:
    """A gloo world of ``prod(shape)`` ranks running ``jobs`` in the
    background (the tests compute their references meanwhile);
    ``ranks()`` waits for it and returns each rank's results, by rank."""

    def __init__(self, tmp_path, shape, params, jobs):
        from repro_torch.launch.mesh import free_port

        self.tmp, self.n, self.results = tmp_path, int(np.prod(shape)), None
        torch.save({"mesh": shape, "params": params, "jobs": jobs}, tmp_path / "in.pt")
        port = str(free_port())
        env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
        self.procs = []
        for r in range(self.n):
            with open(tmp_path / f"log{r}.txt", "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", WORKER, str(tmp_path), str(r), port], env=env,
                    stdout=log, stderr=subprocess.STDOUT))

    def ranks(self) -> list:
        if self.results is None:
            try:
                for r, p in enumerate(self.procs):
                    rc = p.wait(timeout=WORLD_TIMEOUT_S)
                    assert rc == 0, (tmp := self.tmp / f"log{r}.txt").read_text()[-3000:]
            finally:
                self.kill()
            self.results = [torch.load(self.tmp / f"out{r}.pt", weights_only=False)
                            for r in range(self.n)]
        return self.results

    def kill(self) -> None:
        for p in self.procs:
            p.kill()
            p.wait()


def _jax_batches(cfg, n):
    src = JaxStreamSource(vocab_size=cfg.vocab_size, batch=8, seq_len=32, seed=0,
                          frontend_len=cfg.frontend_len if cfg.frontend else 0,
                          frontend_dim=cfg.frontend_dim if cfg.frontend else 0)
    return [{k: np.asarray(v) for k, v in src.batch_at(i).items()} for i in range(n)]


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.device_get(jax_init_params(jax.random.key(0), jax_reduced_config(arch)))


def _jax_steps(arch, batches, opt):
    """JAX's single-device train step from ``jax.random.key(0)``: per step
    its metrics and the parameters after it."""
    cfg = jax_reduced_config(arch)
    tcfg = JaxTrainConfig(optimizer=JaxOptimizerConfig(**opt), remat=False)
    state = jax_init_train_state(jax.random.key(0), cfg, tcfg)
    step = jax.jit(jax_make_train_step(cfg, tcfg, JaxModelOptions(compute_dtype="float32")))
    metrics, params = [], []
    for b in batches:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
        params.append(jax.device_get(state["params"]))
    return metrics, params


def _port_steps(arch, params_np, batches, opt, moe_impl=None):
    """The port's single-device train step from the same parameters: per
    step its metrics and the parameters after it."""
    cfg = reduced_config(arch)
    tcfg = TrainConfig(optimizer=OptimizerConfig(**opt), remat=False)
    state = init_train_state(cfg, tcfg, params=params_from_numpy(params_np, device="cpu"))
    step = make_train_step(cfg, tcfg, ModelOptions(compute_dtype="float32", moe_impl=moe_impl))
    metrics, params = [], []
    for b in batches:
        state, m = step(state, _torch_batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
        # a copy: the arrays share the parameters' storage, which steps update
        params.append(map_params(lambda _k, a: a.copy(), params_to_numpy(state["params"])))
    return metrics, params


def _port_grads(arch, params_np, batch, moe_impl=None, f64=False):
    """The gradient of the port's single-device loss on one batch; with
    ``f64``, of its plain path run in f64 on the same weights (every
    ``.float()`` leaving f64 tensors f64: ``test_torch_gpu._f64_plain``)."""
    from test_torch_gpu import _f64_plain

    params = map_params(lambda _k, p: (p.double() if f64 else p).requires_grad_(True),
                        params_from_numpy(params_np, device="cpu"))
    opts = ModelOptions(compute_dtype="float64", attn_impl="plain") if f64 else ModelOptions(
        compute_dtype="float32", moe_impl=moe_impl)
    with _f64_plain() if f64 else contextlib.nullcontext():
        loss, _ = loss_fn(params, reduced_config(arch), _torch_batch(batch), opts, remat=False)
        loss.backward()
    return map_params(lambda _k, p: p.grad, params)


def _serve_cfgs(job):
    """(JAX's config, the port's) of a serving job."""
    arch, mods = SERVE_JOBS[job][:2]
    return jax_reduced_config(arch).with_(**mods), reduced_config(arch).with_(**mods)


def _serve_tokens(job) -> np.ndarray:
    """The job's prompts: 2 x 32 tokens from a seed."""
    rng = np.random.default_rng(len(job))
    return rng.integers(0, _serve_cfgs(job)[0].vocab_size, SERVE_JOBS[job][4]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _serve_params(job):
    return jax.device_get(jax_init_params(jax.random.key(0), _serve_cfgs(job)[0]))


def _jax_serve(job) -> tuple:
    """JAX's single-device prefill and greedy decode steps (the masked step
    followed by the reference engine's ``_merge_slot`` of each advancing
    row): the logits of each, and the tokens fed."""
    cfg, max_len = _serve_cfgs(job)[0], SERVE_JOBS[job][2]
    opts = JaxModelOptions(compute_dtype="float32")
    params = _serve_params(job)
    logits, cache = jax.jit(lambda p, t: jax_forward_with_cache(
        p, cfg, t, max_len=max_len, opts=opts))(params, _serve_tokens(job))
    step = jax.jit(lambda p, c, t: jax_decode_step(p, cfg, c, t, opts))
    out, tokens = [np.asarray(logits)], []
    for t in range(SERVE_STEPS):
        tok = out[-1][:, -1].argmax(-1) if t == 0 else out[-1].argmax(-1)
        tokens.append(tok.tolist())
        lg, new = step(params, cache, jnp.asarray(tok, jnp.int32))
        if t == SERVE_MASKED:
            for row in np.flatnonzero(_serve_advance(job).numpy()):
                cache = jax_merge_slot(cache, new, int(row))
        else:
            cache = new
        out.append(np.asarray(lg))
    return out, tokens


def _port_serve(job) -> tuple:
    """The port's one-device prefill and greedy decode steps on the same
    weights (the masked step through ``advance``)."""
    cfg, max_len = _serve_cfgs(job)[1], SERVE_JOBS[job][2]
    opts = ModelOptions(compute_dtype="float32")
    params = params_from_numpy(_serve_params(job), device="cpu")
    with torch.no_grad():
        logits, cache = forward_with_cache(params, cfg, torch.from_numpy(_serve_tokens(job)),
                                           max_len=max_len, opts=opts)
        out, tokens = [logits], []
        for t in range(SERVE_STEPS):
            tok = out[-1][:, -1].argmax(-1) if t == 0 else out[-1].argmax(-1)
            tokens.append(tok.tolist())
            lg, cache = decode_step(params, cfg, cache, tok.to(torch.int32), opts,
                                    _serve_advance(job) if t == SERVE_MASKED else None)
            out.append(lg)
    return [o.numpy() for o in out], tokens, cache["len"]


# the tensor-parallel world's jobs: job -> arch (the MoE jobs expert-parallel:
# 2 of the 8 experts a rank, a quarter of the shared experts' width)
TP_JOBS = {"qwen": "qwen3-14b", "musicgen": "musicgen-large", "moe": "deepseek-moe-16b",
           "moe_sort": "deepseek-moe-16b", "qwen2moe": "qwen2-moe-a2.7b",
           "rglru": "recurrentgemma-9b", "xlstm": "xlstm-125m"}
# the jobs' options besides the arch: the sort dispatch, with remat and the
# backward pass on another thread (as qwen_remat); the MoE jobs record their
# first step's mean gradient, held leaf by leaf to the single-device one (the
# router's and qwen2's shared gate's among them: a term summed over the
# model group that every rank computes alike would count n times); so do the
# recurrent jobs, xlstm with remat and the backward on another thread
TP_JOB_OPTS = {"qwen": {"grads": True},
               "moe": {"grads": True},
               "moe_sort": {"moe_impl": "sort", "remat": True, "backward_thread": True,
                            "grads": True},
               "qwen2moe": {"grads": True},
               "rglru": {"grads": True},
               "xlstm": {"remat": True, "backward_thread": True, "grads": True}}
# the steps through which each job's grad norm is held to both references,
# and its parameters to JAX's (to the port's single-device step after both
# steps; the losses of both steps to both): the port's own single-device
# step parts from JAX's in the second step by more than the bounds for the
# frontend, MoE and recurrent families (parameters 1.1e-4 and 1.4e-4 off,
# musicgen's grad norm 2.3e-3; recurrentgemma's and xlstm's parameters 6.1e-4
# and 4.8e-3, their grad norms 0.04 and 0.28: rounding that their first step
# amplifies), so they are held after the first, as tests/test_torch_train.py
# holds their train steps; the sort job is held to the port's single-device
# sort step alone
JAX_STEPS = {"qwen": 2, "musicgen": 1, "moe": 1, "moe_sort": 1, "qwen2moe": 1, "rglru": 1,
             "xlstm": 1}
# the steps after which each job's parameters are held to the port's
# single-device step (2 where not named): the recurrent families' second
# step amplifies the tensor-parallel sums' rounding as it does JAX's (above)
PORT_STEPS = {"rglru": 1, "xlstm": 1}
# the sequence-parallel jobs on the same world: job -> the tensor-parallel
# job it reruns with the stream split over the sequence (its options, and
# its first-step gradient recorded); qwen3-14b as ``qwen_remat`` (remat, the
# backward on another thread)
SP_JOBS = {"qwen_remat_sp": "qwen", "moe_sp": "moe", "rglru_sp": "rglru",
           "xlstm_sp": "xlstm"}
SP_RULES = {"sequence_parallel": True}
# the jobs whose first-step gradient is held to the port's f64 run: the
# recurrent families' f32 gradients part from their exact ones by up to
# 3e-4 of a leaf's largest entry, an sLSTM input-gate bias's by far more
# (tests/test_torch_train.py::test_recurrent_loss_and_grads_match_jax), so
# GRAD_RTOL against the single-device f32 gradient would hold rounding
GRAD_F64 = {"rglru", "xlstm"}
PORT_ONLY = {"moe_sort"}
# element counts of the collectives' check, which the 4 ranks do not divide
COLLECTIVE_NUMELS = (7, 10_001)
# the serving jobs: job -> (arch, changes to its reduced config, max_len,
# each attention cache's (positions, KV heads) a rank, the prompts' shape).
# On the (1, 1, 4) world, one a placement of the decode cache:
# deepseek-moe-16b, its 4 KV heads split (an MoE decode group too); gemma-2b
# with 6 query heads, which 4 does not divide (wq whole): the MQA cache's 64
# positions split, rank 3's 16 never valid; qwen3-14b, 4 query heads split,
# its 2 KV heads whole: the 48 positions split; recurrentgemma-9b with a
# window of 16, its ring of 16 slots split, wrapped by the prefill, its
# RG-LRU states split by channel; xlstm-125m (no attention cache), its mLSTM
# states split by head (one a rank) and its sLSTM states by channel.  On the
# (2, 2, 1) world: deepseek-moe-16b with one row a rank, whose routing groups
# span the 4 ranks (gathered whole).  Rerun with the reference's options
# (``SERVE_RULES``): qwen3-14b's prefill with the stream split over the
# sequence, and deepseek-moe-16b with ``shard_cache_seq``: its cache over
# the 48 positions, every KV head a rank (``wk`` still splits them: the
# prefill moves its K/V by an all-to-all, a decode step gathers its new
# token's heads), the partials merged
SERVE_JOBS = {"serve_kv": ("deepseek-moe-16b", {}, 48, (48, 1), (2, 32)),
              "serve_kv_seq": ("deepseek-moe-16b", {}, 48, (12, 4), (2, 32)),
              "serve_seq_split_sp": ("qwen3-14b", {}, 48, (12, 2), (2, 32)),
              "serve_seq_whole": ("gemma-2b", {"num_heads": 6}, 64, (16, 1), (2, 32)),
              "serve_seq_split": ("qwen3-14b", {}, 48, (12, 2), (2, 32)),
              "serve_ring": ("recurrentgemma-9b", {"window": 16}, 64, (4, 1), (2, 32)),
              "serve_xlstm": ("xlstm-125m", {}, 48, None, (2, 32)),
              "serve_dp": ("deepseek-moe-16b", {}, 24, (24, 4), (4, 16))}
SERVE_WORLD = {"serve_dp": (2, 2, 1)}
SERVE_RULES = {"serve_kv_seq": {"shard_cache_seq": True},
               "serve_seq_split_sp": {"sequence_parallel": True}}
# a prefill, then greedy decode steps, the masked one leaving row 1 where it
# was (``advance``)
SERVE_STEPS, SERVE_MASKED = 4, 2


def _cache_shards(job) -> dict:
    """Each decode-cache leaf's shard on a rank of the job's world, as the
    reference's ``cache_specs`` places the whole cache.  The reference reads
    a main-group leaf's group dim off its shape, so it takes the groups for
    the rows where they number the rows alike (recurrentgemma-9b's and
    xlstm-125m's two groups here): its placement is read off a cache of
    more rows, over the same batch axes."""
    jcfg, (B, _), max_len = _serve_cfgs(job)[0], SERVE_JOBS[job][4], SERVE_JOBS[job][2]
    dims = SERVE_WORLD.get(job, (1, 1, 4))
    mesh = jax.sharding.AbstractMesh(dims, AXES)
    ba = jax_cells.data_axes_for(mesh, B)
    groups = (jcfg.num_layers - jcfg.first_dense) // len(jcfg.block_pattern)
    whole = jax.eval_shape(lambda: jax_init_cache(jcfg, B, max_len, dtype=jnp.float32))
    wide = jax.eval_shape(lambda: jax_init_cache(jcfg, B * (groups + 1), max_len,
                                                 dtype=jnp.float32))
    placed = _jax_cache_specs(wide, jcfg, mesh, ba, jax_ctx.activation_rules(
        data_axes=ba, **SERVE_RULES.get(job, {})))
    sizes = dict(zip(AXES, dims))
    return {f"{seg}/{i}/{k}": _shard_shape(x.shape, placed[seg][i][k], sizes)
            for seg in ("prefix", "main", "tail") for i, e in enumerate(whole[seg])
            for k, x in e.items()}


def _serve_advance(job) -> torch.Tensor:
    return torch.arange(SERVE_JOBS[job][4][0]) != 1


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three worlds, started together: (2, 2, 2) runs reduced qwen3-14b
    for two steps, twice, and reduced gemma-2b for one step without and
    with compression; (2, 2, 1) runs reduced deepseek-moe-16b for two steps
    of 8 x 32 tokens (2 rows, 64 tokens, one routing group a rank), then a
    step of 4 x 16 (16 tokens a rank of a 64-token group), after its
    serving job; (1, 1, 4), one
    tensor-parallel group, runs ``SERVE_JOBS``, then ``TP_JOBS`` for two
    steps (qwen3-14b thrice), ``SP_JOBS`` and the collectives' check."""
    batches = {arch: _jax_batches(jax_reduced_config(arch), 2)
               for arch in ("qwen3-14b", "gemma-2b", *TP_JOBS.values())}
    params = {arch: params_from_numpy(_jax_params(arch), device="cpu") for arch in batches}
    tb = {arch: [_torch_batch(b) for b in bs] for arch, bs in batches.items()}
    serve = {job: {"serve": True, "arch": arch, "mods": mods, "max_len": max_len,
                   "tokens": torch.from_numpy(_serve_tokens(job)), "steps": SERVE_STEPS,
                   "masked_step": SERVE_MASKED, "advance": _serve_advance(job),
                   "rules": SERVE_RULES.get(job, {})}
             for job, (arch, mods, max_len, *_) in SERVE_JOBS.items()}
    serve_params = {job: params_from_numpy(_serve_params(job), device="cpu")
                    for job in SERVE_JOBS}
    qwen = {"arch": "qwen3-14b", "opt": STEP_OPT, "compress": False,
            "batches": tb["qwen3-14b"]}
    gemma = {"arch": "gemma-2b", "opt": {}, "batches": tb["gemma-2b"][:1]}
    moe = {"arch": "deepseek-moe-16b", "opt": STEP_OPT, "compress": False}
    small = {k: v[:4, :16] for k, v in batches["deepseek-moe-16b"][0].items()}
    started = {
        (2, 2, 2): _World(tmp_path_factory.mktemp("world_222"), (2, 2, 2),
                          {a: params[a] for a in ("qwen3-14b", "gemma-2b")},
                          {"qwen": qwen, "qwen_again": qwen,
                           "gemma": {**gemma, "compress": False},
                           "gemma_compressed": {**gemma, "compress": True}}),
        (2, 2, 1): _World(tmp_path_factory.mktemp("world_221"), (2, 2, 1),
                          {"deepseek-moe-16b": params["deepseek-moe-16b"],
                           "serve_dp": serve_params["serve_dp"]},
                          {"serve_dp": serve["serve_dp"],
                           "moe": {**moe, "batches": tb["deepseek-moe-16b"]},
                           "moe_split_group": {**moe, "batches": [_torch_batch(small)]}}),
        (1, 1, 4): _World(tmp_path_factory.mktemp("world_114"), (1, 1, 4),
                          {**{a: params[a] for a in TP_JOBS.values()},
                           **{job: serve_params[job] for job in SERVE_JOBS
                              if job not in SERVE_WORLD}},
                          {**{job: serve[job] for job in SERVE_JOBS if job not in SERVE_WORLD},
                           **{job: {"arch": a, "opt": STEP_OPT, "compress": False,
                                    "batches": tb[a], **TP_JOB_OPTS.get(job, {})}
                              for job, a in TP_JOBS.items()},
                           "qwen_again": {**qwen},
                           "qwen_remat": {**qwen, "remat": True, "backward_thread": True},
                           **{job: {"arch": TP_JOBS[tp], "opt": STEP_OPT, "compress": False,
                                    "batches": tb[TP_JOBS[tp]], **TP_JOB_OPTS.get(tp, {}),
                                    **({"remat": True, "backward_thread": True}
                                       if tp == "qwen" else {}),
                                    "grads": True, "rules": SP_RULES}
                              for job, tp in SP_JOBS.items()},
                           "collectives": {"numels": COLLECTIVE_NUMELS}}),
    }
    yield started, batches
    for w in started.values():
        w.kill()


def _np_flat(tree) -> dict:
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in _flat(tree).items()}


def test_mesh_step_matches_single_device(worlds):
    """(2, 2, 2), reduced qwen3-14b, two steps: loss within 1e-3 and every
    parameter within 1e-4 of JAX's single-device step and of the port's;
    the rerun equal bit for bit; each rank's parameter and moment shards
    shaped as the reference's ``fit_spec`` partition."""
    started, batches = worlds
    qb = batches["qwen3-14b"]
    jax_metrics, jax_params = _jax_steps("qwen3-14b", qb, STEP_OPT)
    port_metrics, port_params = _port_steps("qwen3-14b", _jax_params("qwen3-14b"), qb,
                                            STEP_OPT)
    jax_params, port_params = jax_params[-1], port_params[-1]
    ranks = started[2, 2, 2].ranks()
    got = ranks[0]["qwen"]
    for ref_metrics, ref_params in ((jax_metrics, jax_params), (port_metrics, port_params)):
        for g, w in zip(got["metrics"], ref_metrics):
            assert abs(g["loss"] - w["loss"]) < LOSS_TOL, (g, w)
            assert abs(g["grad_norm"] - w["grad_norm"]) < LOSS_TOL, (g, w)
        want, have = _np_flat(ref_params), _np_flat(got["params"])
        assert have.keys() == want.keys()
        worst = max(np.abs(have[k] - want[k]).max() for k in want)
        assert worst < PARAM_TOL, worst
    for r in ranks:
        assert r["qwen"]["metrics"] == r["qwen_again"]["metrics"] == got["metrics"]
        a, b = _np_flat(r["qwen"]["params"]), _np_flat(r["qwen_again"]["params"])
        assert all(np.array_equal(a[k], b[k]) for k in a)
    sizes = dict(zip(AXES, (2, 2, 2)))
    abstract = _jax_abstract("qwen3-14b")
    logical = _flat(jax_specs.param_logical_axes(abstract))
    for rank in ranks:
        shapes, m_shapes = _flat(rank["qwen"]["shapes"]), _flat(rank["qwen"]["m_shapes"])
        for k, leaf in _flat(abstract).items():
            want = _shard_shape(leaf.shape, _ref_spec(logical[k], leaf.shape, sizes), sizes)
            assert shapes[k] == m_shapes[k] == want, (k, shapes[k], want)


def test_compressed_step_close_to_uncompressed(worlds):
    """The reference test's bounds: loss within 1e-2, grad norm within 10%."""
    ranks = worlds[0][2, 2, 2].ranks()
    base, comp = ranks[0]["gemma"]["metrics"][0], ranks[0]["gemma_compressed"]["metrics"][0]
    assert abs(base["loss"] - comp["loss"]) < COMP_LOSS_TOL, (base, comp)
    assert abs(base["grad_norm"] - comp["grad_norm"]) / base["grad_norm"] < COMP_GNORM_RTOL


def _pod_grads(ranks, name):
    """The pods' gradients a compressed step combined, stacked in pod order
    (pod 0 from rank 0, pod 1 from rank 4)."""
    pods = [_np_flat(ranks[r][name]["pod_grads"]) for r in (0, 4)]
    return {k: np.stack([p[k] for p in pods]) for k in pods[0]}


def _quantum(grads_g: np.ndarray) -> float:
    """One int8 quantum of the mean: the largest pod's scale over npods."""
    npods = grads_g.shape[0]
    return float(np.abs(grads_g).reshape(npods, -1).max(1).max() / 127.0 / npods)


def test_compressed_combine_matches_reference_on_the_same_gradients(worlds):
    """The distributed combine (int8 payloads and scales all-gathered over
    the pod group) against the reference's ``ef_quantize_mean`` fed the
    same per-pod gradients: the mean gradient within one int8 quantum
    everywhere and within 1e-6 relative on all but a share under 1e-3 of
    the elements (in fact bit for bit apart from rounding ties), and each
    pod's new EF buffer likewise."""
    ranks = worlds[0][2, 2, 2].ranks()
    grads_g = _pod_grads(ranks, "gemma_compressed")
    # op by op: under jit XLA's CPU backend contracts multiply-subtract into
    # an FMA and divides by a constant through its reciprocal, which moves
    # last bits; the port follows the operations as written
    mean, new_ef = jax_compress.ef_quantize_mean(
        {k: jnp.asarray(v) for k, v in grads_g.items()},
        {k: jnp.zeros_like(v) for k, v in grads_g.items()})
    have = _np_flat(ranks[0]["gemma_compressed"]["mean_grads"])
    off = total = 0
    for k, g in grads_g.items():
        want = np.asarray(mean[k])
        err = np.abs(have[k] - want)
        assert err.max() <= _quantum(g), (k, err.max())
        off += int((err > REL_TOL * np.abs(want)).sum())
        total += want.size
        for pod, r in enumerate((0, 4)):
            ef = _np_flat(ranks[r]["gemma_compressed"]["ef"])[k]
            assert np.abs(ef - np.asarray(new_ef[k])[pod]).max() <= _quantum(g) * 2, k
    assert off < OFF_SHARE * total, (off, total)


def test_compressed_step_matches_jax_composition(worlds):
    """The compressed step against the reference's pieces on the same
    weights and pod halves: ``loss_fn``'s gradient per half,
    ``ef_quantize_mean`` (the mean within one int8 quantum, widened by the
    two packages' scales' own difference: a scale that parts by r moves
    every entry by up to 127 r of a quantum), then ``clip_by_global_norm``
    and ``adamw_update`` (loss and grad norm within 1e-3, parameters within
    1e-4)."""
    started, batches = worlds
    gb = batches["gemma-2b"]
    cfg = jax_reduced_config("gemma-2b")
    params = _jax_params("gemma-2b")
    opts = JaxModelOptions(compute_dtype="float32")
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(p, cfg, b, opts, remat=False), has_aux=True))
    halves = [grad(params, {k: v[i * 4:(i + 1) * 4] for k, v in gb[0].items()})
              for i in range(2)]
    grads_g = jax.tree.map(lambda *g: jnp.stack(g), *[h[1] for h in halves])
    mean, _ = jax.jit(jax_compress.ef_quantize_mean)(
        grads_g, jax_compress.init_ef_state(params, 2))
    clipped, gnorm = jax.jit(jax_clip_by_global_norm, static_argnums=1)(mean, 1.0)
    new_params, _ = jax.jit(jax_adamw_update, static_argnums=0)(
        JaxOptimizerConfig(), params, clipped,
        {"m": jax.tree.map(jnp.zeros_like, params), "v": jax.tree.map(jnp.zeros_like, params)},
        jnp.int32(0))
    ranks = started[2, 2, 2].ranks()
    got = ranks[0]["gemma_compressed"]
    loss = float(np.mean([float(h[0][0]) for h in halves]))
    assert abs(got["metrics"][0]["loss"] - loss) < LOSS_TOL
    assert abs(got["metrics"][0]["grad_norm"] - float(gnorm)) < LOSS_TOL * float(gnorm)
    want_g, have_g = _np_flat(grads_g), _pod_grads(ranks, "gemma_compressed")
    want, have = _np_flat(mean), _np_flat(got["mean_grads"])
    for k, g in want_g.items():
        s_want = np.abs(g).reshape(2, -1).max(1)
        s_have = np.abs(have_g[k]).reshape(2, -1).max(1)
        r = float(np.max(np.abs(s_have - s_want) / s_want))
        err = np.abs(have[k] - want[k]).max()
        assert err <= _quantum(g) * (1 + 127 * r), (k, err, _quantum(g), r)
    want_p, have_p = _np_flat(new_params), _np_flat(got["params"])
    assert max(np.abs(have_p[k] - want_p[k]).max() for k in want_p) < PARAM_TOL


def test_moe_mesh_step_takes_the_global_aux_loss(worlds):
    """(2, 2, 1), reduced deepseek-moe-16b: the loss, its load-balance term
    included (E * sum f * P over the global batch), within 1e-3 of JAX's
    single-device step for two steps."""
    started, batches = worlds
    jax_metrics, _ = _jax_steps("deepseek-moe-16b", batches["deepseek-moe-16b"], STEP_OPT)
    ranks = started[2, 2, 1].ranks()
    for g, w in zip(ranks[0]["moe"]["metrics"], jax_metrics):
        assert abs(g["loss"] - w["loss"]) < LOSS_TOL, (g, w)
        assert abs(g["aux_loss"] - w["aux_loss"]) < LOSS_TOL, (g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) < LOSS_TOL, (g, w)


def test_moe_mesh_step_refuses_split_routing_groups(worlds):
    """4 x 16 tokens over 4 ranks: 16 a rank of one 64-token group, whose
    capacity the reference takes over the whole group."""
    for r in worlds[0][2, 2, 1].ranks():
        assert "routing groups of the global batch of 64 tokens over 4 ranks" \
            in r["moe_split_group"]["error"]


def _tp_local(path: str) -> bool:
    """Whether a leaf's compute keeps its model-axis block: the dense
    attention, the dense MLPs, the embedding table and the head, the routed
    and the shared experts (not the router or qwen2's shared gate), the
    RG-LRU and mLSTM layers, the sLSTM's FFN (not its recurrent weights)."""
    return any(k in path for k in ("['attn']", "['mlp']", "['embed']['table']",
                                   "['head']['w']", "['rglru']", "['mlstm']",
                                   "['slstm']['ffn']")) or (
        "['moe']" in path and not path.endswith(("['router']", "['shared_gate']")))


@functools.lru_cache(maxsize=None)
def _single_device(arch, moe_impl=None, jax_too=True) -> tuple:
    """The single-device references of a mesh job on ``arch``'s two
    batches: the port's steps and JAX's (where ``jax_too``), computed once
    for the tensor-parallel and the sequence-parallel jobs alike."""
    batches = _jax_batches(jax_reduced_config(arch), 2)
    port = _port_steps(arch, _jax_params(arch), batches, STEP_OPT, moe_impl)
    return port, _jax_steps(arch, batches, STEP_OPT) if jax_too else None


@functools.lru_cache(maxsize=None)
def _first_grads(arch, moe_impl=None, f64=False) -> dict:
    """The port's single-device first-step gradient (``_port_grads``),
    computed once."""
    batch = _jax_batches(jax_reduced_config(arch), 1)[0]
    return _np_flat(_port_grads(arch, _jax_params(arch), batch, moe_impl, f64))


@pytest.mark.parametrize("job", list(TP_JOBS))
def test_tensor_parallel_step_matches_single_device(worlds, job):
    """(1, 1, 4), two steps with model-local compute: each step's loss
    within 1e-3 of the port's single-device step and of JAX's, the grad
    norm through ``JAX_STEPS`` too, and every parameter within 1e-4 of the
    port's after both steps (``PORT_STEPS``) and of JAX's after
    ``JAX_STEPS``; the first step's mean gradient, where a job records it,
    leaf by leaf within GRAD_RTOL of the port's single-device one (of the
    port's f64 run for ``GRAD_F64``, or no farther from it than twice the
    port's own f32 gradient); each rank's parameters and moments at rest
    its ``fit_spec`` shards, and the leaves it computes on model-local: the
    attention, MLP, embedding, head, routed and shared expert, RG-LRU,
    mLSTM and sLSTM FFN leaves split over ``model`` where ``fit_spec``
    splits them, the rest (the router and the sLSTM's recurrent weights
    among them) whole.  The sort job is held to the port's single-device
    sort step."""
    _held_to_single_device(worlds, job, job)


def _held_to_single_device(worlds, job: str, tp: str) -> None:
    """``job`` on the (1, 1, 4) world held as the tensor-parallel job ``tp``
    is: ``test_tensor_parallel_step_matches_single_device``'s checks."""
    started, _ = worlds
    arch, n_jax = TP_JOBS[tp], JAX_STEPS[tp]
    moe_impl = TP_JOB_OPTS.get(tp, {}).get("moe_impl")
    (port_metrics, port_params), jax_ref = _single_device(arch, moe_impl, tp not in PORT_ONLY)
    n_port = PORT_STEPS.get(tp, 2)
    refs = [(port_metrics, port_params[n_port - 1], n_port)]
    if jax_ref is not None:
        jax_metrics, jax_params = jax_ref
        refs.append((jax_metrics, jax_params[n_jax - 1], n_jax))
    ranks = started[1, 1, 4].ranks()
    got = ranks[0][job]
    for ref, _, _ in refs:
        for i, (g, w) in enumerate(zip(got["metrics"], ref)):
            assert abs(g["loss"] - w["loss"]) < LOSS_TOL, (g, w)
            if i < n_jax:
                assert abs(g["grad_norm"] - w["grad_norm"]) < LOSS_TOL, (g, w)
    for _, ref_params, n_steps in refs:
        have = got["params"] if n_steps == 2 else got["params_1"]
        want, have = _np_flat(ref_params), _np_flat(have)
        assert have.keys() == want.keys()
        worst = max(np.abs(have[k] - want[k]).max() for k in want)
        print(f"{arch}: worst parameter difference {worst:.3g}")
        assert worst < PARAM_TOL, worst
    if "grads_1" in got:
        want = _first_grads(arch, moe_impl)
        have = _np_flat(got["grads_1"])
        assert have.keys() == want.keys()
        bound = {k: GRAD_RTOL for k in want}
        if tp in GRAD_F64:  # held to the f64 run, beside the f32 one's own distance
            exact = _first_grads(arch, f64=True)
            bound = {k: max(GRAD_RTOL, 2 * np.abs(want[k] - exact[k]).max()
                            / np.abs(exact[k]).max()) for k in want}
            want = exact
        rel = {k: np.abs(have[k] - want[k]).max() / np.abs(want[k]).max() / bound[k]
               for k in want}
        worst = max(rel, key=rel.get)
        print(f"{arch}: worst first-step gradient {rel[worst]:.3g} of its bound ({worst})")
        assert rel[worst] < 1, (worst, rel[worst], bound[worst])
    sizes = dict(zip(AXES, (1, 1, 4)))
    abstract = _jax_abstract(arch)
    logical = _flat(jax_specs.param_logical_axes(abstract))
    split = 0
    for rank in ranks:
        shapes, compute = _flat(rank[job]["shapes"]), _flat(rank[job]["compute_shapes"])
        for k, leaf in _flat(abstract).items():
            at_rest = _shard_shape(leaf.shape, _ref_spec(logical[k], leaf.shape, sizes), sizes)
            assert shapes[k] == at_rest, (k, shapes[k], at_rest)
            want = at_rest if _tp_local(k) else tuple(leaf.shape)
            assert compute[k] == want, (k, compute[k], want)
            split += compute[k] != tuple(leaf.shape)
    assert split > 0


@pytest.mark.parametrize("job", list(SP_JOBS))
def test_sequence_parallel_step_matches_single_device(worlds, job):
    """(1, 1, 4), the residual stream split over the sequence between blocks
    (``activation_rules(sequence_parallel=True)``: 8 x 32 tokens, 8
    positions a rank): the tensor-parallel job's checks against the
    single-device steps, its first-step gradients leaf by leaf among them;
    and the norm scales' gradients, of which each rank computes its
    positions' part (summed over ``model`` in rank order), within GRAD_RTOL
    of the tensor-parallel job's, leaf by leaf."""
    _held_to_single_device(worlds, job, SP_JOBS[job])
    ranks = worlds[0][1, 1, 4].ranks()
    sp, tp = (_np_flat(ranks[0][j]["grads_1"]) for j in (job, SP_JOBS[job]))
    scales = [k for k in tp if k.endswith("['scale']")]
    assert any("['final_norm']" in k for k in scales) and any("['norm1']" in k for k in scales)
    for k in scales:
        err = np.abs(sp[k] - tp[k]).max() / np.abs(tp[k]).max()
        assert err < GRAD_RTOL, (k, err)


@pytest.mark.parametrize("rerun", ["qwen_again", "qwen_remat"])
def test_tensor_parallel_reruns_equal_bits(worlds, rerun):
    """(1, 1, 4): the same two steps of reduced qwen3-14b run again give the
    same metrics and parameters on every rank, bit for bit: plainly, and
    with remat and the backward pass on another thread than the step (as
    autograd runs it on the card), whose recomputed blocks must still see
    the step's tensor-parallel group."""
    for r in worlds[0][1, 1, 4].ranks():
        assert r["qwen"]["metrics"] == r[rerun]["metrics"]
        a, b = _np_flat(r["qwen"]["params"]), _np_flat(r[rerun]["params"])
        assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("numel", COLLECTIVE_NUMELS)
def test_ordered_collectives_equal_gather_and_add(worlds, numel):
    """Over a gloo group of 4 ranks, at an element count 4 does not divide:
    ``ordered_sum`` (all-to-all, sums in rank order, all-gather) equals the
    sum in rank order of every rank's gathered copy bit for bit,
    ``ordered_reduce_scatter`` this rank's zero-padded block of it, and
    ``ordered_max`` the gathered copies' max."""
    for r in worlds[0][1, 1, 4].ranks():
        for what, (got, want) in r["collectives"][numel].items():
            assert got.shape == want.shape and torch.equal(got, want), (what, numel)


@pytest.mark.parametrize("job", list(SERVE_JOBS))
def test_tensor_parallel_serving_matches_single_device(worlds, job):
    """(1, 1, 4) (``serve_dp``: (2, 2, 1), one row a rank), the sharded
    prefill of 2 x 32 tokens (4 x 16) and 4 greedy decode steps (one
    leaving row 1 where it was), on each rank's shards of the parameters
    and its block of the cache: every rank's logits, gathered over the
    vocabulary and the rows, within 1e-4 of the largest logit
    (``tests/test_torch_models.py``'s LOGITS_TOL) of JAX's single-device
    ``forward_with_cache`` / ``decode_step`` (the masked step merged as the
    reference engine merges a slot) and of the port's one-device steps;
    the same greedy tokens; each rank's attention caches placed as the
    reference's ``cache_specs`` places them (``SERVE_JOBS``); under a
    sequence split one merge per attention layer and step, which where the
    query heads are whole gives every rank the same bits."""
    want_jax, tok_jax = _jax_serve(job)
    want_port, tok_port, lengths = _port_serve(job)
    assert tok_jax == tok_port
    cfg = _serve_cfgs(job)[1]
    shards = _cache_shards(job)
    ranks = worlds[0][SERVE_WORLD.get(job, (1, 1, 4))].ranks()
    for rank, r in enumerate(ranks):
        got = r[job]
        assert [t.tolist() for t in got["tokens"]] == tok_port
        rows = got["len"].shape[0]
        i = rank % (lengths.shape[0] // rows)  # this rank's block of the rows
        assert torch.equal(got["len"], lengths[i * rows:(i + 1) * rows])
        for want in (want_jax, want_port):
            for g, w in zip(got["logits"], want, strict=True):
                np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                           atol=1e-4 * max(np.abs(w).max(), 1.0))
        assert all(s[-3:-1] == SERVE_JOBS[job][3] for s in got["cache_shapes"]), \
            got["cache_shapes"]
        assert bool(got["cache_shapes"]) == (SERVE_JOBS[job][3] is not None)
        assert got["leaf_shapes"] == shards, (got["leaf_shapes"], shards)
    attn = sum(k in ("attn", "local") for k in cfg.layer_kinds)
    n_merged = len(ranks[0][job]["merged"])
    over_seq = SERVE_JOBS[job][3] is not None and SERVE_JOBS[job][3][0] < SERVE_JOBS[job][2]
    assert n_merged == (SERVE_STEPS * attn if over_seq else 0), n_merged
    if cfg.num_heads % 4:  # heads whole: the merged output is every rank's, bit for bit
        for r in ranks[1:]:
            assert all(torch.equal(a, b) for a, b in zip(r[job]["merged"],
                                                          ranks[0][job]["merged"]))


def _spec_norm(spec) -> tuple:
    """A spec's entries with a one-axis tuple as the axis and an empty one
    as None (how ``PartitionSpec`` writes them)."""
    def entry(p):
        if isinstance(p, tuple):
            return None if not p else p[0] if len(p) == 1 else p
        return p
    return tuple(entry(p) for p in spec)


def _jax_cache_specs(cache_abs, jcfg, mesh, ba, rules):
    """The reference's ``cache_specs`` of ``cache_abs``, each leaf's spec
    (``_spec_norm``) with a mesh axis that it names on two dims kept on the
    first only: with ``shard_cache_seq`` and a model axis that divides the
    KV heads it names ``model`` on the positions and on the heads, which
    its own ``NamedSharding`` refuses (checked: ``DuplicateSpecError``)."""
    with mock.patch.object(jax_cells, "NamedSharding", lambda _m, spec: spec):
        placed = jax_cells.cache_specs(cache_abs, jcfg, mesh, ba, rules)

    def once(spec):
        kept, used = [], set()
        for p in _spec_norm(spec):
            axes = set(specs.spec_axes(p))
            kept.append(None if axes & used else p)
            used |= axes
        if tuple(kept) != _spec_norm(spec):
            with pytest.raises(Exception) as refused:
                jax.sharding.NamedSharding(mesh, spec)
            assert type(refused.value).__name__ == "DuplicateSpecError", refused.value
        return tuple(kept)

    return jax.tree.map(once, placed, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


SERVE_MESHES = {"pod16x16": ((16, 16), ("data", "model")),
                "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("cache_seq", [False, True])
@pytest.mark.parametrize("mesh_name", list(SERVE_MESHES))
@pytest.mark.parametrize("arch,shape", [
    (a, s) for a in ARCH_IDS for s in ("decode_32k", "long_500k")
    if jax_shape_applicable(jax_get_config(a), JAX_SHAPES[s])[0]])
def test_cache_specs_match_reference(arch, shape, mesh_name, cache_seq):
    """The port's ``cache_specs`` against the reference's
    (``repro.launch.cells.cache_specs`` on an abstract mesh) leaf by leaf,
    for every arch's applicable decode shapes at full size on both
    production meshes, without and with ``shard_cache_seq`` (the
    reference's spec there minus its later repeat of ``model``:
    ``_jax_cache_specs``); and ``local_cache``'s rank-0 blocks (fake
    tensors) shaped as the reference's shards, every leaf: the attention
    caches, the recurrent states and the lengths."""
    cfg, jcfg, sh = get_config_port(arch), jax_get_config(arch), JAX_SHAPES[shape]
    dims, axes = SERVE_MESHES[mesh_name]
    mesh = jax.sharding.AbstractMesh(dims, axes)
    ba = jax_cells.data_axes_for(mesh, sh.global_batch)
    assert ba == ctx.data_axes_for(abstract_mesh(dims, axes), sh.global_batch)
    rules = jax_ctx.activation_rules(data_axes=ba, shard_cache_seq=cache_seq)
    whole_j = jax.eval_shape(lambda: jax_init_cache(jcfg, sh.global_batch, sh.seq_len,
                                                    dtype=jnp.bfloat16))
    want = _flat(_jax_cache_specs(whole_j, jcfg, mesh, ba, rules))
    from torch._subclasses.fake_tensor import FakeTensorMode

    sizes = dict(zip(axes, dims))
    with FakeTensorMode():
        whole = init_cache(cfg, sh.global_batch, sh.seq_len, torch.bfloat16, "cpu")
        got = specs.cache_specs(whole, cfg, sizes, ba,
                                ctx.activation_rules(data_axes=ba, shard_cache_seq=cache_seq))
        assert {k: _spec_norm(v) for k, v in _flat(got).items()} == want
        local = specs.local_cache(whole, got, abstract_mesh(dims, axes))
    shapes = {k: tuple(v.shape) for k, v in _flat(local).items() if k != "['max_len']"}
    positions = [e["k"].shape[-3] for seg in ("prefix", "main", "tail")
                 for e in whole[seg] if "k" in e]
    assert local.get("max_len") == (max(positions) if positions else None)
    want_shapes = {k: _shard_shape(x.shape, want[k], sizes) for k, x in _flat(whole_j).items()}
    assert shapes == want_shapes


@pytest.mark.parametrize("heads,G,want", [
    (range(0, 1), 2, range(0, 1)),  # qwen3-14b reduced over 4: one query head
    (range(4, 8), 8, range(0, 1)),  # MQA: every query head reads KV head 0
    (range(4, 8), 2, range(2, 4)),  # two KV heads, two query heads each
    (range(2, 5), 2, [1, 1, 2]),  # straddling: one KV head a query head
])
def test_kv_heads_of_local_queries(heads, G, want):
    """The KV heads a rank's query heads read (head h reads h // G), as the
    compact K/V the kernel indexes by h // (local G), or one per query."""
    from repro_torch.models.lm import _kv_heads

    got = _kv_heads(heads, G)
    if isinstance(want, range):
        assert got == want
    else:
        assert torch.equal(got, torch.tensor(want))
