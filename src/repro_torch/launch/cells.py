"""Cell construction: (arch x shape x mesh) -> a step to count, the port's
counterpart of ``repro/launch/cells.py``.

A *cell* is one entry of the dry-run / roofline matrix.  Where the
reference lowers a sharded program over the whole mesh, the port runs its
own step as one rank of it, on fake tensors (nothing is drawn or
allocated), and ``repro_torch.launch.dryrun`` counts the ops it runs
(``launch.op_analysis``):

- **train**: the port's mesh train step (``train.step._mesh_step``) as rank
  0 of an abstract mesh (``launch.mesh.abstract_mesh``: its collectives
  count the bytes they would move), on a fake train state that holds rank
  0's shards and on the global batch of ``batch_specs``, of which the step
  takes rank 0's rows.  Its compute is tensor-parallel over ``model``
  (``"model_axis"`` names the parts): dense attention where the axis
  divides the heads, dense MLPs where it divides ``d_ff``, the embedding
  and the head where it divides the vocabulary, the routed experts
  (expert-parallel) where it divides their number, the shared experts
  where it divides their width, the RG-LRU where it divides ``d_rnn``, the
  mLSTM where it divides its inner width (its recurrence on the rank's
  heads where it divides them too), the sLSTM's FFN where it divides its
  width; the sLSTM's cell (whole in the reference's partition too), and any
  part the axis does not divide (qwen2-moe-a2.7b's 60 experts over 16
  ranks), run whole on every rank of the group.  With ``dp_layout``
  every parameter is replicated and the batch spans ``model`` too;
- **prefill** and **decode**: the port's sharded serving steps
  (``serve.engine.make_prefill_step`` and ``make_decode_step`` with the
  mesh) as rank 0, on rank 0's shards of the parameters in the compute
  dtype (``sharding.specs.local_params``) and, for decode, rank 0's block
  of the cache as the reference's ``cache_specs`` places it
  (``sharding.specs.local_cache``); the steps take rank 0's rows of the
  global batch.  Their compute is tensor-parallel over ``model`` as the
  train step's, the decode cache's attention layers split over their KV
  heads or, where ``model`` does not divide those, over the sequence, and
  its recurrent states over their heads or channels (``"model_axis"``
  names which).

The reference's three options carry over: ``sequence_parallel`` (the rule
``seq`` on ``model``: between blocks the train and prefill steps hold the
residual stream by blocks of positions where the axis divides its length),
``shard_cache_seq`` (the rule ``cache_seq`` on ``model``: every attention
cache over its positions where the axis divides them, its KV heads whole)
and ``tree_attention`` (``ModelOptions.tree_attention``: the plain path's
exact-causal tree; the kernel path, which already does only the causal
work, counts as it does without it).  ``"model_axis"`` says where the
stream and the cache split over the sequence.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

from ..configs import SHAPES, ArchConfig, ShapeCfg, get_config, shape_applicable
from ..convert import cast_params
from ..data.stream import batch_specs
from ..models.lm import ModelOptions, init_cache, init_params
from ..models.recurrent import slstm_ff
from ..serve.engine import make_decode_step, make_prefill_step
from ..sharding.ctx import activation_rules, data_axes_for, tensor_axis
from ..sharding.specs import PARAM_RULES, cache_specs, kv_cache_split, local_cache, local_params
from ..train.step import TrainConfig, init_train_state, make_train_step
from .mesh import BATCH_AXES


@dataclass(frozen=True)
class CellOptions:
    """The port's knobs of a cell.  ``dp_layout``: the batch over the
    ``model`` axis too and every parameter replicated (the reference's
    layout for small archs), which strips the sequence rules as it strips
    every tensor-axis name.  ``sequence_parallel`` and ``shard_cache_seq``
    are the reference's, which go to ``activation_rules``; its third,
    ``tree_attention``, is ``model``'s, as in the reference."""

    model: ModelOptions = ModelOptions()
    train: TrainConfig = TrainConfig()
    dp_layout: bool = False
    param_rules: dict = field(default_factory=lambda: dict(PARAM_RULES))
    sequence_parallel: bool = False
    shard_cache_seq: bool = False


@dataclass
class Cell:
    arch: str
    shape: ShapeCfg
    cfg: ArchConfig
    kind: str  # train | prefill | decode
    fn: object  # the step callable
    args: tuple  # fake tensors: rank 0's
    meta: dict
    fake_mode: object  # the FakeTensorMode of args, in which the step runs


def train_model_axis(cfg: ArchConfig, n: int, stream_positions: int = 0) -> str:
    """What a train step's compute splits over a model axis of n ranks, and
    what runs whole on each of them; and, where sequence parallelism splits
    a residual stream of ``stream_positions`` (0: it is off), that the
    stream does so where n divides them."""
    kinds, moe = set(cfg.layer_kinds), cfg.moe
    parts = (("attention", any(k in kinds for k in ("attn", "local")),
              cfg.num_heads % n == 0),
             ("MLP", cfg.d_ff > 0 and (moe is None or cfg.first_dense > 0)
              and not kinds <= {"mlstm", "slstm"}, cfg.d_ff % n == 0),
             ("embedding and head", True, cfg.padded_vocab % n == 0),
             ("experts", moe is not None, moe is not None and moe.num_experts % n == 0),
             ("shared experts", moe is not None and moe.num_shared > 0,
              moe is not None and moe.num_shared * moe.d_expert % n == 0),
             ("RG-LRU", "rglru" in kinds, (cfg.d_rnn or cfg.d_model) % n == 0),
             ("mLSTM", "mlstm" in kinds, 2 * cfg.d_model % n == 0),
             ("mLSTM recurrence", "mlstm" in kinds, cfg.num_heads % n == 0),
             ("sLSTM FFN", "slstm" in kinds, slstm_ff(cfg.d_model) % n == 0),
             ("sLSTM cell", "slstm" in kinds, False))
    split = [name for name, has, ok in parts if has and ok]
    whole = [name for name, has, ok in parts if has and not ok]
    stream = ""
    if stream_positions:
        stream = "; residual stream " + ("over the sequence" if stream_positions % n == 0
                                         else "whole")
    return ("tensor-parallel: " + (", ".join(split) or "nothing")
            + (f"; whole on every rank: {', '.join(whole)}" if whole else "") + stream)


def serve_model_axis(cfg: ArchConfig, n: int, shape: ShapeCfg, cache_seq: bool = False,
                     stream_positions: int = 0) -> str:
    """``train_model_axis`` for a serving step, and where its decode cache
    splits over the n ranks: each attention kind's cache (global attention
    of ``seq_len`` positions, a local layer's ring) over its KV heads, its
    sequence or whole (``sharding.specs.kv_cache_split``, the sequence
    first with ``cache_seq``); each recurrent kind's state over its heads
    or channels, or whole, as ``sharding.specs.cache_specs`` places it."""
    kinds = set(cfg.layer_kinds)
    where = {"kv": "KV heads", "seq": "sequence", "whole": "whole"}
    cache = [f"{name} over "
             f"{where[kv_cache_split(positions, cfg.num_kv_heads, n, cache_seq)]}"
             for kind, name, positions in (
                 ("attn", "attention", shape.seq_len),
                 ("local", "local ring", min(cfg.window, shape.seq_len)))
             if kind in kinds]
    d, di = cfg.d_model, 2 * cfg.d_model
    for kind, name, parts in (
            ("rglru", "RG-LRU state", (("channels", (cfg.d_rnn or d) % n == 0),)),
            ("mlstm", "mLSTM state", (("heads", cfg.num_heads % n == 0),
                                      ("conv channels", di % n == 0))),
            ("slstm", "sLSTM state", (("channels", d % n == 0),))):
        if kind in kinds:
            over = [what for what, ok in parts if ok]
            cache.append(f"{name} over {' and '.join(over)}" if over else f"{name} whole")
    return train_model_axis(cfg, n, stream_positions) + "; cache: " + ", ".join(cache)


def token_count(cfg: ArchConfig, shape: ShapeCfg) -> int:
    if shape.kind in ("train", "prefill"):
        return shape.global_batch * shape.seq_len
    return shape.global_batch  # decode: one token per sequence


def build_cell(arch: str, shape_name: str, mesh, opts: CellOptions = CellOptions()) -> Cell:
    """The cell's step and its fake arguments, as rank ``mesh.rank`` of
    ``mesh`` (an abstract mesh for train cells)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"cell ({arch}, {shape_name}) skipped: {why}")
    stream = shape.seq_len if opts.sequence_parallel and shape.kind != "decode" else 0

    batch_axes = data_axes_for(mesh, shape.global_batch, include_model=opts.dp_layout)
    rows = shape.global_batch // mesh.size(batch_axes)
    ftok = cfg.frontend_len if cfg.frontend else 0
    seq_tok = shape.seq_len - ftok
    meta = {"batch_axes": batch_axes, "rows": rows}
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake = FakeTensorMode()

    if shape.kind == "train":
        tcfg = opts.train
        if tcfg.compress_pod_grads:  # across pods: a mesh of one pod has none
            tcfg = TrainConfig(optimizer=tcfg.optimizer, accum_steps=tcfg.accum_steps,
                               compress_pod_grads="pod" in mesh.axis_names,
                               num_pods=mesh.shape.get("pod", 1), remat=tcfg.remat)
        rules = {} if opts.dp_layout else opts.param_rules
        act_rules = activation_rules(sequence_parallel=opts.sequence_parallel,
                                     shard_cache_seq=opts.shard_cache_seq)
        if opts.dp_layout:  # as the reference: no tensor-axis names
            act_rules = {k: (v if k in ("batch", "dp") else None)
                         for k, v in act_rules.items()}
        with fake:
            state = init_train_state(cfg, tcfg, device="cpu", mesh=mesh, rules=rules)
        # a fake 0-dim step cannot be read on the host, where AdamW reads it
        state["step"] = 0
        batch = batch_specs(cfg.vocab_size, shape.global_batch, seq_tok, ftok,
                            cfg.frontend_dim, mode=fake)
        step = make_train_step(cfg, tcfg, opts.model, mesh=mesh, act_rules=act_rules,
                               param_rules=rules,
                               batch_axes=batch_axes if opts.dp_layout else BATCH_AXES)
        tp = tensor_axis(act_rules, mesh, batch_axes)
        meta["model_axis"] = (train_model_axis(cfg, mesh.shape[tp], stream) if tp
                              else "replicated compute, sharded state")
        return Cell(arch, shape, cfg, "train", step, (state, batch), meta, fake)

    act_rules = activation_rules(data_axes=batch_axes, sequence_parallel=opts.sequence_parallel,
                                 shard_cache_seq=opts.shard_cache_seq)
    rules = opts.param_rules
    if opts.dp_layout:  # as the train cells: no tensor-axis names
        act_rules = {k: (v if k in ("batch", "dp") else None) for k, v in act_rules.items()}
        rules = {}
    tp = tensor_axis(act_rules, mesh, batch_axes)
    meta["model_axis"] = (serve_model_axis(cfg, mesh.shape[tp], shape,
                                           opts.shard_cache_seq, stream) if tp
                          else "replicated compute, sharded state")
    with fake:
        params = local_params(cast_params(init_params(cfg, device="cpu"), opts.model.dtype,
                                          "cpu"), mesh, rules)
        if shape.kind == "prefill":
            batch = batch_specs(cfg.vocab_size, shape.global_batch, seq_tok, ftok,
                                cfg.frontend_dim, mode=fake)
            del batch["labels"]
            step = make_prefill_step(cfg, opts.model, max_len=shape.seq_len, mesh=mesh,
                                     act_rules=act_rules, param_rules=rules)
            return Cell(arch, shape, cfg, "prefill", step, (params, batch), meta, fake)
        # decode: one new token a row against rank 0's block of a cache of seq_len
        whole = init_cache(cfg, shape.global_batch, shape.seq_len, opts.model.dtype, "cpu")
        cache = local_cache(whole, cache_specs(whole, cfg, mesh, batch_axes, act_rules), mesh)
        del whole
        tokens = torch.empty((shape.global_batch,), dtype=torch.int32)
    step = make_decode_step(cfg, opts.model, mesh=mesh, act_rules=act_rules, param_rules=rules)
    return Cell(arch, shape, cfg, "decode", step, (params, cache, tokens), meta, fake)


def run_step(cell: Cell, mode: str = "kernel") -> tuple:
    """Run the cell's step once on its fake arguments under an op counter
    (in kernel mode, shapes only): ``(result, Totals)``."""
    from .op_analysis import count

    grad = contextlib.nullcontext() if cell.kind == "train" else torch.no_grad()
    with cell.fake_mode, grad:
        return count(cell.fn, *cell.args, mode=mode, shapes_only=mode == "kernel")
