#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (built for the H100, sm_90a).

    python3 chip_smoke.py [--seed N]

Phases, each of which ends the run with a non-zero exit on any error or
tolerance miss:

1. device: the card's name, count and power limit;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels: hold each kernel against its plain PyTorch version at the
   serving, prefill and training paths' shapes, and time kernel, plain version and a
   PyTorch library call beside the least time the card could take (f32
   flash rows also beside the split-TF32 bound, with the variant each
   took: at D a multiple of 8 the f32 backward must take the f32
   tensor-core one, and the f32 forward the CUDA-core one), and hold the
   f32 flash backward at scores in the hundreds no farther from an f64
   run than the CUDA-core variant (``check_flash_near_hard``); the dense
   decode kernel's log-sum-exp output (its output bits unchanged by it,
   and its time with and without) and the rank-ordered merge of a
   sequence-split decode's partials (``merge_partials``, over 16 and 2
   slices of a cache) at the serving shapes, in bf16 and f32;
4. paged serve: full-width gemma-2b in bf16 through ``PagedServeEngine``
   (random weights from ``--seed``), 16 requests with prefix sharing and
   copy-on-write, with the kernels' launch counts read around the run and
   one prefill and one decode tick profiled;
5. fixed-slot serve: the same model through ``ServeEngine``, 8 requests of
   about 48 tokens on 4 slots, with the launch counts read around the run;
6. prefill: ``make_prefill_step`` over 1024 tokens, then 16 decode steps
   from that cache, timed on the host and profiled on the device;
7. train: full-width, full-depth gemma-2b through
   ``repro_torch.launch.train.main`` (batch 2 x 1024 tokens of the lcg
   stream, f32 parameters and AdamW moments, bf16 compute, remat; 2
   warm-up and 6 timed steps) with exact launch counts per step, then one
   step of a fresh state built with ``init_train_state`` and
   ``make_train_step`` profiled on the device;
8. checks at full width and 2 layers: the paged kernel path against its
   gather path (first-tick logits in bf16, greedy tokens in f32); the
   flash path of ``forward`` (bf16: each layer's attention on forward's
   own inputs against f64, and the 1-layer logits against the plain
   path); prefill
   plus decode against ``forward`` (f32); the fixed-slot engine against
   the paged engine (greedy tokens, f32); one train step, kernels against
   the plain path (loss, gradients, updated parameters: f32 at 2 layers,
   bf16 at 1), and two kernel-path steps from one state bit for bit;
9. recurrentgemma-9b (RG-LRU + local attention) at full width and depth in
   bf16: ``make_prefill_step`` over 4096 tokens (past its 2048 window) and
   16 decode steps with exact launch counts, one profiled prefill, then
   at its first 18 layers ``PagedServeEngine`` over 8 requests of 160 +
   32 tokens;
10. xlstm-125m (mLSTM + sLSTM) at full width and depth in bf16: a prefill
   of 2048 tokens and 16 decode steps with exact launch counts, one
   profiled prefill, then at its first 4 layers ``ServeEngine`` over 8
   requests on 4 slots;
11. checks of both families at full width and one pattern group (3 and 4
   layers): in f32 the kernel path's logits against the plain path's,
   prefill plus decode against ``forward`` past the window, the paged
   engine's greedy tokens against the fixed-slot engine's; in bf16 each
   recurrent and windowed kernel on its own layer's inputs against its
   plain version;
12. deepseek-moe-16b (28 layers) and qwen2-moe-a2.7b (24) at full width
   and depth in bf16, drawn and cast layer by layer: a prefill of 2048
   tokens and 16 decode steps with exact launch counts and peak memory,
   one profiled prefill and decode step with the MoE layers' routing,
   dispatch and expert time apart; then, at half depth (the first 14 and
   12 layers), deepseek through ``PagedServeEngine`` (the gemma trace)
   and qwen2 through ``ServeEngine`` (4 slots);
13. checks of both at full width and 2 layers: in f32 the kernel path's
   logits and cache against the plain path's, the sort dispatch against
   the einsum one, each MoE layer against an f64 MoE on the same routing
   (and the sort dispatch twice, bit for bit), the paged engine's kernel
   path against its gather path; in bf16 the kernel path against the
   plain one, with the share of positions whose expert set differs;
14. training: deepseek-moe-16b at full width and 3 layers (4 steps of 2 x
   1024; the first step's gradients in f32, kernels against plain, and
   both held to the plain path in f64 on the same routing),
   musicgen-large at full depth through the launcher (4 steps of 2 x (64
   + 960), frontend embeddings from the stream), internvl2-26b at full
   width and 4 layers (a forward of (1, 256 + 768) and 2 train steps);
15. training the recurrent families at full width in bf16 with remat:
   recurrentgemma-9b at 3 layers over 1 x 4096 tokens, xlstm-125m at 8
   layers over 2 x 1024, 2 warm-up and 3 timed steps with exact launch
   counts, one step profiled; their checks: the first step in f32,
   kernels against plain (leaves past the tolerance held to the plain path
   in f64), each backward kernel (windowed flash, RG-LRU, mLSTM) on its
   layer's own inputs against its plain version, and two bf16 steps from
   one state bit for bit;
16. the trainer PE (``repro_torch.platform.run_trainer``) on a stand-in
   runtime with the port's checkpoint store: gemma-2b at full width and 2
   layers, stopped after step 6, restarted from the committed step 4,
   ending at the uninterrupted run's checkpoint bytes;
17. the mesh train step (``repro_torch.launch.mesh``) at world size 1 over
   NCCL: gemma-2b at full width and 2 layers, 2 steps of 2 x 1024, the
   mesh step equal to the one-device step and the compressed step
   (``num_pods`` 1) to the one-device gradients through the plain
   ``ef_quantize_mean``, clipping and AdamW, bit for bit, with equal
   launch counts; then full-depth gemma-2b through
   ``repro_torch.launch.train.main`` with ``--mesh 1,1,1`` (as phase 7),
   its peak memory within 5% of phase 7's; and the compressed combine's
   bytes and time; then the tensor-parallel step on a (1, 1, 2) mesh of
   two processes sharing the card over gloo (``--tp-rank`` runs one),
   at full width in f32: gemma-2b at 2 layers, two steps of 2 x 1024 (4
   query heads a rank), then deepseek-moe-16b expert-parallel at 2 layers
   (its dense layer and one MoE layer, 32 of the 64 routed experts a rank,
   the shared experts column- and row-parallel), recurrentgemma-9b at 2
   layers (two RG-LRU layers, 2048 of the 4096 channels a rank) and
   xlstm-125m at 4 layers (three mLSTM layers, 768 of the 1536 inner
   width and 2 of the 4 heads a rank, and one sLSTM layer, its FFN split),
   two steps of 2 x 512 each; each first step's loss and gradients held to
   the one-device f32 step (the MoE's routed as rank 0 routed; leaves past
   the tolerance: both held to the plain path in f64), the leaves every
   rank holds whole equal on both ranks, the flash and recurrent kernels
   run at the local heads' and channels' counted work, equal launch
   counts; then, on the same two processes, tensor-parallel serving at
   full width in f32 (``make_prefill_step`` and ``make_decode_step`` with
   the mesh): gemma-2b and qwen3-14b at 2 layers, a prefill of (1, 1024)
   and 16 greedy decode steps (gemma's 4 query heads a rank, its MQA cache
   split over the sequence, the partials merged; qwen3's 20 query and 4 KV
   heads a rank, the cache split over its KV heads), then
   recurrentgemma-9b at 3 layers (two RG-LRU layers, their states split
   by channel, and a local layer, its ring split over the sequence) and
   xlstm-125m at 4 layers (the mLSTM states split by head, the sLSTM's by
   channel), a prefill of (1, 256) and 8 greedy decode steps; each rank's
   logits held to the one-device f32 steps (or, past that, both to the
   plain path in f64), greedy tokens equal, each rank's cache placed as
   ``cache_specs`` places it, every kernel launched as often as on one
   device (one merge more a local or global attention layer and step where
   the sequence splits); and the reference's mesh options on the same
   processes: sequence parallelism (the residual stream split over the
   sequence between blocks) in the gemma-2b and deepseek-moe-16b train
   jobs and the gemma-2b serving prefill, and ``shard_cache_seq`` in the
   qwen3-14b serving job (its cache over the sequence with every KV head a
   rank: a decode kernel and a merge a layer and step), each held as its
   plain tensor-parallel job is;
18. analysis: the dry-run (``repro_torch.launch.dryrun``) of gemma-2b's
   applicable cells on both production meshes, (16, 16) and (2, 16, 16),
   on fake tensors; phase 6's prefill and one phase-7 train step, counted
   in kernel mode on the card (``repro_torch.launch.op_analysis``; the
   counts are taken in those phases), must equal the same steps counted on
   fake tensors (FLOPs, bytes, each kernel's calls and work), and the
   counted FLOPs over each step's time by CUDA events, as a share of the
   card's 989 TFLOP/s, must not read over 1.05 (the count would be wrong);
   rank 0's count of each tensor-parallel job's step on the card
   (collective bytes by key too) must equal rank 0's on fake tensors of an
   abstract (1, 1, 2) mesh, and so must each serving job's prefill and
   decode step (rank 0's shards and its block of the cache, placed by
   ``cache_specs``);
19. the kernels line (JSON), the run's wall, the card's name and power
   limit, and the result line ``{"ok": true, "device": {...}}`` last.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

# the trainer PE's deterministic mode needs cuBLAS's fixed workspace, which
# cuBLAS reads when its first handle is made: set before any CUDA call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# the recurrent f64 gradient check (phase 15) runs near the card's memory
# with 8 GB tensors: segments that grow, rather than fixed cached blocks,
# keep it from failing on fragmentation left by earlier phases
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# the port, from this checkout (outside one, this import fails)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.convert import cast_params, map_params, zip_params  # noqa: E402
from repro_torch.data import StreamSource  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    CUDA_CORE_PLAN,
    TC_PLAN,
    _paged_cuda_core_splits,
    _paged_splits,
    _splits,
    decode_attention_cost,
    merge_partials_cost,
    paged_decode_attention_cost,
)
from repro_torch.ckpt import CheckpointStore  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _dkv_splits,
    flash_attention_bwd_cost,
    flash_attention_cost,
)
from repro_torch.kernels.mlstm_chunk import mlstm_chunk_bwd_cost, mlstm_chunk_cost  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan_bwd_cost, rglru_scan_cost  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_cost  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.mesh import HW, abstract_mesh, free_port, make_mesh  # noqa: E402
from repro_torch.launch.op_analysis import count as count_ops  # noqa: E402
from repro_torch.models import (  # noqa: E402
    ModelOptions,
    decode_step,
    forward,
    forward_with_cache,
    init_cache,
    init_params,
    layers,
    loss_fn,
)
from repro_torch.models import lm as lm_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.lm import layer_specs, stack_plan  # noqa: E402
from repro_torch.platform import run_trainer  # noqa: E402

# the kernel modules (the package's names of the same spelling are the
# wrapper functions)
flash_mod = importlib.import_module("repro_torch.kernels.flash_attention")
mlstm_mod = importlib.import_module("repro_torch.kernels.mlstm_chunk")
rglru_mod = importlib.import_module("repro_torch.kernels.rglru_scan")
from repro_torch.serve import (  # noqa: E402
    PagedServeEngine,
    Request,
    ServeEngine,
    make_decode_step,
    make_prefill_step,
    paged_model,
)
from repro_torch.sharding import activation_rules  # noqa: E402
from repro_torch.sharding.collectives import gather_stack  # noqa: E402
from repro_torch.sharding.ctx import data_axes_for  # noqa: E402
from repro_torch.sharding.specs import (  # noqa: E402
    cache_specs,
    kv_cache_split,
    local_cache,
    local_params,
)
from repro_torch.train import (  # noqa: E402
    OptimizerConfig,
    TrainConfig,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_train_state,
    lr_schedule,
    make_train_step,
)
from repro_torch.train.compress import compressed_mean_over_axis, ef_quantize_mean  # noqa: E402
from repro_torch.train.optim import leaves  # noqa: E402
from repro_torch.train.step import abstract_train_state, train_state_specs  # noqa: E402

step_mod = importlib.import_module("repro_torch.train.step")

HBM_BYTES_PER_S = HW["hbm_bw"]  # H100 SXM
PEAK_OPS_PER_S = {"torch.bfloat16": HW["peak_flops_bf16"],
                  "torch.float32": HW["peak_flops_f32"]}
# f32 products as split TF32 on the tensor cores (the f32 flash variants):
# three TF32 products each, at a third of the 495 TFLOP/s TF32 rate
SPLIT_TF32_OPS_PER_S = 495e12 / 3
TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}  # as tests/test_kernels.py
# bf16 logits, kernel path vs plain path (the paged first tick at 2 layers,
# forward at 1 layer): the two attention outputs differ by summation order,
# which moves a bf16 rounding (2^-8 relative) now and then; held relative
# to the largest logit
LOGITS_BF16_RTOL = 2e-2
# prefill + decode against the full forward, f32, relative to the largest
# logit: the bound of tests/test_models.py::test_prefill_decode_equivalence
PREFILL_DECODE_RTOL = 5e-3
L2_BYTES = 50 * 2**20
# RMSNorm's timed shapes: gemma-2b's decode (first: its bf16 row is the one
# in the kernels line) and qwen3's per-head norm, then the prefill and
# training shapes (gemma-2b 1024 and 2 x 1024 tokens, recurrentgemma-9b
# 4096, xlstm-125m 2048 at its model and inner widths)
RMSNORM_SHAPES = ((8, 2048), (64, 8, 128), (1024, 2048), (2048, 2048), (4096, 4096),
                  (2048, 768), (2048, 1536))
WHERE = {  # kernel -> (CUDA source, the TPU kernel it replaces)
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:28"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        "src/repro/kernels/decode_attention.py:176"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:82"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:78"),
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention.py:214"),
    "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan.py:45"),
    "mlstm_chunk": ("src/repro_torch/kernels/csrc/mlstm_chunk.cu",
                    "src/repro/kernels/mlstm_chunk.py:83"),
    # the backward kernels of the recurrent training slice: the flash
    # backward with a window (recurrentgemma's local layers), and the
    # RG-LRU and mLSTM backwards, which the TPU kernels did not have (the
    # reference differentiates their XLA formulations)
    "flash_attention_bwd_window": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                                   "src/repro/kernels/flash_attention.py:214"),
    "rglru_scan_bwd": ("src/repro_torch/kernels/csrc/rglru_scan_bwd.cu",
                       "src/repro/kernels/rglru_scan.py:45"),
    "mlstm_chunk_bwd": ("src/repro_torch/kernels/csrc/mlstm_chunk_bwd.cu",
                        "src/repro/kernels/mlstm_chunk.py:83"),
    # the rank-ordered merge of a sequence-split decode's partial outputs:
    # the dense decode kernel's combine pass with the ranks as its splits
    # (the TPU program's counterpart is XLA's, around the decode kernel)
    "merge_partials": ("src/repro_torch/kernels/csrc/decode_combine.cuh",
                       "src/repro/kernels/decode_attention.py:82"),
}
# the recurrent kernels against their plain versions: RG-LRU f32 1e-5 abs +
# rel and mLSTM 5e-5 abs + 5e-4 rel, as tests/test_kernels.py; the windowed
# flash on a layer's own bf16 inputs within 2e-2 of the largest entry (one
# bf16 rounding)
RGLRU_TOL = 1e-5
MLSTM_ATOL, MLSTM_RTOL = 5e-5, 5e-4
WINDOW_BF16_REL = 2e-2
# the recurrent families' f32 logits at one pattern group and full width,
# kernel path against plain path, relative to the largest logit: f32 sums
# in another order (flash against a plain band softmax, the chunkwise mLSTM
# kernel against its plain loop), carried through 3-4 layers
RECURRENT_F32_RTOL = 1e-3
# the MoE families' f32 logits and cache at 2 layers, kernel path against
# plain path and sort dispatch against einsum, relative to the largest
# entry: the same bound, for the same reason
MOE_F32_RTOL = RECURRENT_F32_RTOL
# flash backward against its plain version: f32 as
# tests/test_kernels.py::test_flash_attention_backward_kernels (5e-5 abs +
# 5e-4 rel); bf16 within 2e-2 of each output's largest entry (one bf16
# rounding of f32 sums)
BWD_F32_ATOL, BWD_F32_RTOL, BWD_BF16_REL = 5e-5, 5e-4, 2e-2
# one train step: the loss (relative) and each gradient leaf (relative to
# its largest entry), kernel path against plain path; the step's clipped
# gradient and each leaf's change, against the first AdamW step in closed
# form.  f32 at 2 layers; bf16 at 1 (the 2-layer bf16 forward already parts
# by 0.1 with the reference's init: PERF.md, Findings)
TRAIN_F32 = {"loss": 1e-5, "leaf": 1e-3}
TRAIN_BF16 = {"loss": 2e-2, "leaf": 2e-2}
# the optimizer of that step: lr 2.5e-3 at step 0, a change that f32
# parameters resolve (at the default 3e-6 it lies within a few ulps of
# the parameter)
TRAIN_CHECK_OPT = OptimizerConfig(lr=1e-2, warmup_steps=4)
# the full-depth --mesh 1,1,1 run's peak memory against phase 7's
MESH_PEAK_RTOL = 0.05
# the tensor-parallel sub-phase: a (1, 1, 2) mesh, two processes on one card
# over gloo (whose all-to-all and all-gather take CUDA tensors), each job at
# full width and (layers) in f32, two steps of (batch, seq) tokens:
# gemma-2b (4 query heads a rank, MQA's one KV head whole, ff 8192 and vocab
# 128000 a rank), then deepseek-moe-16b (its dense layer and one MoE layer:
# 8 query and KV heads, ff 5472, 32 of the 64 routed experts, 1408 of the
# shared experts' width and half the vocab a rank; two routing groups of
# 512, capacity 60), recurrentgemma-9b (two RG-LRU layers: 2048 channels,
# ff 6144 and 128000 of the vocab a rank) and xlstm-125m (three mLSTM layers
# and an sLSTM layer: 768 of the inner width's 1536, 2 of the 4 heads and
# 512 of the sLSTM FFN's 1024 a rank).  Each first step's loss and gradients are held to the
# one-device f32 step by TRAIN_F32, as phase 8 holds the kernel path to the
# plain one (leaves past it: both held to the plain path in f64); the
# one-device MoE step routed as rank 0 routed (``routing_log``).  The second
# step is logged: its parameters moved by the first AdamW step, whose
# direction g / (|g| + eps) flips wherever two correct f32 runs give a
# gradient entry opposite signs
TP_MESH = (1, 1, 2)
TP_JOBS = {"gemma-2b": (2, 1024, 2), "deepseek-moe-16b": (2, 512, 2),
           "recurrentgemma-9b": (2, 512, 2), "xlstm-125m": (2, 512, 4),
           "gemma-2b+sp": (2, 1024, 2), "deepseek-moe-16b+sp": (2, 512, 2)}
TP_WORKER_TIMEOUT_S = 600
# the sub-phase's serving jobs, on the same two processes: the sharded
# prefill of (1, prompt) tokens and greedy decode steps at full width and
# (layers) in f32, max_len prompt + steps (2 divides it): gemma-2b (4 query
# heads a rank, its MQA cache split over the sequence: a decode kernel and a
# merge a layer and step), qwen3-14b (20 query heads and 4 of the 8 KV
# heads a rank: the cache split over its KV heads), recurrentgemma-9b (two
# RG-LRU layers, their states' 2048 channels a rank, and a local layer, its
# ring of 264 slots split over the sequence) and xlstm-125m (three mLSTM
# layers, 2 heads of their states a rank, and an sLSTM layer, 384 of its
# state's 768 channels a rank).  Each rank's logits,
# gathered over the vocabulary, are held to the one-device f32 steps within
# SERVE_TP_RTOL of the largest logit (tests/test_torch_models.py's
# LOGITS_TOL); where they miss, both are held to the plain path in f64, as
# the TP train jobs' gradients; greedy tokens equal
TP_SERVE_JOBS = {"gemma-2b": (1024, 16, 2), "qwen3-14b": (1024, 16, 2),
                 "recurrentgemma-9b": (256, 8, 3), "xlstm-125m": (256, 8, 4),
                 "gemma-2b+sp": (1024, 16, 2), "qwen3-14b+cache-seq": (1024, 16, 2)}
SERVE_TP_RTOL = 1e-4
# a job named "arch+option" runs its arch with one of the reference's mesh
# options: "sp", sequence parallelism (the residual stream split over the
# sequence between blocks, 512 or 256 positions a rank; the train jobs and
# the prefill), and "cache-seq", ``shard_cache_seq`` (qwen3-14b's cache
# over its 1040 positions with all 8 KV heads a rank, where its heads split
# without it)
JOB_OPTIONS = {"sp": {"sequence_parallel": True}, "cache-seq": {"shard_cache_seq": True}}


def job_arch(job: str) -> tuple:
    """(arch, the activation rules' options) of a tensor-parallel job."""
    arch, _, option = job.partition("+")
    return arch, JOB_OPTIONS[option] if option else {}


def log(*args) -> None:
    print(*args, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time of one ``fn(i)`` call.  ``iters`` calls are
    captured in one CUDA graph and the graph is replayed between CUDA
    events, so the host's launch overhead stays out of the figure."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def ptxas_summary(text: str) -> list:
    """One line per compiled kernel of ``nvcc -Xptxas -v``'s log: its
    (mangled) name, registers, spills and shared memory."""
    out, name, spill = [], "", ""
    for line in text.splitlines():
        if line.startswith("=="):
            out.append(line.strip())
        elif "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            used = line.split("Used", 1)[1].strip()
            out.append(f"  {name}: {used}; {spill}")
    return out


def max_err_within(got, want, tol: float, what: str) -> float:
    """max |got - want|, which must stay within tol + tol * |want|."""
    return abs_rel_err(got, want, tol, tol, what)


def abs_rel_err(got, want, atol: float, rtol: float, what: str) -> float:
    """max |got - want|, which must stay within atol + rtol * |want|."""
    err = (got.float() - want.float()).abs()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    if (err > atol + rtol * want.float().abs()).any():
        raise AssertionError(f"{what}: max abs error {err.max().item()} exceeds "
                             f"{atol} + {rtol} rel")
    return err.max().item()


def bound(cost: _build.Cost, dtype) -> tuple:
    """The least time in ms the card could take for a kernel call's work
    (its wrapper module's ``*_cost``): its bytes over the memory rate or
    its operations over the peak rate of ``dtype``, the larger, and which."""
    t_bytes = cost.bytes / HBM_BYTES_PER_S * 1e3
    t_ops = cost.flops / PEAK_OPS_PER_S[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    return ((got - want).abs().max() / want.abs().max()).item()


# ------------------------------------------------------------------ kernels


def check_rmsnorm(gen, rows_shape, dtype) -> dict:
    d = rows_shape[-1]
    x = torch.randn(rows_shape, generator=gen, device="cuda").to(dtype)
    scale = torch.randn(d, generator=gen, device="cuda") * 0.1
    got = kernels.rmsnorm(x, scale)
    want = kernels.ref.rmsnorm_ref(x, scale)
    torch.cuda.synchronize()
    err = max_err_within(got, want, TOL[str(dtype)],
                         f"rmsnorm {rows_shape} {dtype}")
    weight = (1.0 + scale).to(dtype)
    b_ms, b_by = bound(rmsnorm_cost(x.numel() // d, d, dtype), dtype)
    # every call reads the same x, as the model's norm reads the x that the
    # op before it has just written: from L2 where it fits in its 50 MB
    return {
        "shape": list(rows_shape), "dtype": str(dtype), "max_abs_err": err,
        "ms": time_ms(lambda i: kernels.rmsnorm(x, scale)),
        "plain_ms": time_ms(lambda i: kernels.ref.rmsnorm_ref(x, scale)),
        "library_ms": time_ms(lambda i: F.rms_norm(x, (d,), weight, 1e-6)),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def paged_inputs(gen, B, H, KV, D, bs, max_len, dtype):
    """Ragged lengths up to ``max_len``, shuffled tables, unused entries on
    scratch block 0, as the engine leaves them."""
    T = -(-max_len // bs)
    N = B * T + 1
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(N, bs, KV, D, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(N, bs, KV, D, generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(N - 1, generator=gen, device="cuda") + 1
    lens = [max(1, max_len - (max_len * i) // (B + 1)) for i in range(B)]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    used = (lengths + bs - 1) // bs
    cols = torch.arange(T, device="cuda")[None, :]
    tables = torch.where(cols < used[:, None], perm.view(B, T), 0)
    return q, kp, vp, tables.to(torch.int32).contiguous(), lengths, lens


def check_paged(gen, B, H, KV, D, bs, max_len, dtype) -> dict:
    q, kp, vp, tables, lengths, lens = paged_inputs(
        gen, B, H, KV, D, bs, max_len, dtype)
    got = kernels.paged_decode_attention(q, kp, vp, tables, lengths)
    want = kernels.ref.paged_decode_attention_ref(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    what = f"paged_decode_attention B={B} H={H} KV={KV} D={D} bs={bs} {dtype}"
    err = max_err_within(got, want, TOL[str(dtype)], what)
    # time on copies of the pools that together exceed L2: in the serving
    # path a layer's pool was last touched a whole micro-step earlier
    copies = max(1, min(16, math.ceil(2 * L2_BYTES / (2 * kp.numel() * kp.element_size()))))
    pools = [(kp.clone(), vp.clone()) for _ in range(copies)]
    ms = time_ms(lambda i: kernels.paged_decode_attention(
        q, *pools[i % copies], tables, lengths))
    plain_ms = time_ms(lambda i: kernels.ref.paged_decode_attention_ref(
        q, *pools[i % copies], tables, lengths))
    # yardstick: SDPA over the cache gathered beforehand (the gather
    # untimed), from as many copies as the kernel reads, so that neither
    # finds its inputs in L2
    S = tables.shape[1] * bs
    tab = tables.long()
    gathered = [tuple(p[tab].reshape(B, S, KV, D).transpose(1, 2).contiguous()
                      for p in pool) for pool in pools]
    mask = (torch.arange(S, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    library_ms = time_ms(lambda i: F.scaled_dot_product_attention(
        q[:, :, None, :], *gathered[i % copies], attn_mask=mask, enable_gqa=True))
    del gathered
    # only the pages the lengths need
    b_ms, b_by = bound(paged_decode_attention_cost(B, H, KV, D, bs, tables.shape[1], dtype,
                                                   lengths=lens), dtype)
    del pools
    if dtype == torch.float32:  # the CUDA-core split body: 32-key stages
        (chunk, nsplit), tile = _paged_cuda_core_splits(
            B, KV, tables.shape[1], bs, _build.sm_count(0)), CUDA_CORE_PLAN[0]
    else:
        chunk, tile, nsplit = _paged_splits(
            B, KV, tables.shape[1], bs, _build.library().repro_paged_decode_max_tile(),
            _build.sm_count(0))
    return {
        "shape": {"B": B, "H": H, "KV": KV, "D": D, "bs": bs,
                  "max_len": max_len}, "dtype": str(dtype),
        "plan": f"chunk {chunk}, tile {tile}, {nsplit} splits: "
                f"{nsplit * KV * B} blocks",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
    }


def check_decode(gen, B, H, KV, D, Smax, dtype) -> dict:
    """Dense decode over a (B, Smax, KV, D) cache, ragged lengths with one
    above Smax (it attends to the whole cache)."""
    lens = [Smax + 1] + [max(1, Smax - (Smax * i) // B) for i in range(1, B)]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(B, Smax, KV, D, generator=gen, device="cuda").to(dtype)
    vc = torch.randn(B, Smax, KV, D, generator=gen, device="cuda").to(dtype)
    got = kernels.decode_attention(q, kc, vc, lengths)
    want = kernels.ref.decode_attention_ref(q, kc, vc, lengths)
    torch.cuda.synchronize()
    what = f"decode_attention B={B} H={H} KV={KV} D={D} Smax={Smax} {dtype}"
    err = max_err_within(got, want, TOL[str(dtype)], what)
    # time on copies of the caches that together exceed L2: in the serving
    # path a layer's cache was last touched a whole decode step earlier
    # (up to 64 copies for the small serving caches, each call of the
    # captured graph on its own copy)
    es = q.element_size()
    copies = max(1, min(64, math.ceil(2 * L2_BYTES / (2 * kc.numel() * es))))
    iters = max(20, copies)
    caches = [(kc.clone(), vc.clone()) for _ in range(copies)]
    ms = time_ms(lambda i: kernels.decode_attention(q, *caches[i % copies], lengths),
                 iters=iters)
    plain_ms = time_ms(lambda i: kernels.ref.decode_attention_ref(
        q, *caches[i % copies], lengths), iters=iters)
    # yardstick: SDPA with a length mask on pre-transposed caches, from as
    # many copies as the kernel reads
    transposed = [tuple(c.transpose(1, 2).contiguous() for c in pair)
                  for pair in caches]
    mask = (torch.arange(Smax, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    library_ms = time_ms(lambda i: F.scaled_dot_product_attention(
        q[:, :, None, :], *transposed[i % copies], attn_mask=mask, enable_gqa=True),
        iters=iters)
    del transposed
    # only the rows the lengths need
    b_ms, b_by = bound(decode_attention_cost(B, H, KV, D, Smax, dtype, lengths=lens),
                       dtype)
    del caches
    tc = _build.library().repro_decode_attention_tensor_cores(
        _build.DTYPE_CODES[dtype], H // KV, D, q.data_ptr(), kc.data_ptr(), vc.data_ptr())
    chunk, nsplit = _splits(B, KV, Smax, _build.sm_count(0),
                            TC_PLAN if tc else CUDA_CORE_PLAN)
    return {
        "shape": {"B": B, "H": H, "KV": KV, "D": D, "Smax": Smax},
        "plan": f"chunk {chunk}, {nsplit} splits: {nsplit * KV * B} blocks",
        "dtype": str(dtype), "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
        "bound_by": b_by,
    }


def check_decode_lse(gen, B, H, KV, D, Smax, dtype) -> dict:
    """The dense decode kernel's log-sum-exp output (``return_lse``) against
    its plain version, over ``check_decode``'s ragged lengths with the last
    row empty (-1e30); its output equal bit for bit to the call without it,
    and both timed on the same copies of the caches (the store's cost)."""
    lens = [Smax + 1] + [max(1, Smax - (Smax * i) // B) for i in range(1, B - 1)] + [0]
    lengths = torch.tensor(lens[:B], dtype=torch.int32, device="cuda")
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(B, Smax, KV, D, generator=gen, device="cuda").to(dtype)
    vc = torch.randn(B, Smax, KV, D, generator=gen, device="cuda").to(dtype)
    got, lse = kernels.decode_attention(q, kc, vc, lengths, return_lse=True)
    base = kernels.decode_attention(q, kc, vc, lengths)
    want, want_lse = kernels.ref.decode_attention_ref(q, kc, vc, lengths, return_lse=True)
    torch.cuda.synchronize()
    what = f"decode_attention lse B={B} H={H} KV={KV} D={D} Smax={Smax} {dtype}"
    assert torch.equal(got, base), f"{what}: the output changed with the lse"
    err = max_err_within(got, want, TOL[str(dtype)], what)
    lse_err = max_err_within(lse, want_lse, TOL["torch.float32"], what + " (lse)")
    copies = max(1, min(64, math.ceil(2 * L2_BYTES / (2 * kc.numel() * q.element_size()))))
    caches = [(kc.clone(), vc.clone()) for _ in range(copies)]
    iters = max(20, copies)
    ms = time_ms(lambda i: kernels.decode_attention(q, *caches[i % copies], lengths,
                                                    return_lse=True), iters=iters)
    ms_without = time_ms(lambda i: kernels.decode_attention(q, *caches[i % copies], lengths),
                         iters=iters)
    del caches
    return {"shape": {"B": B, "H": H, "KV": KV, "D": D, "Smax": Smax}, "dtype": str(dtype),
            "max_abs_err": err, "lse_err": lse_err, "ms": ms, "ms_without": ms_without}


def check_merge(gen, n, B, H, KV, D, Smax, dtype) -> dict:
    """``merge_partials`` over n slices of one cache (each slice's decode
    kernel output and log-sum-exp, at local lengths as a rank of a
    sequence split holds them; short rows leave the last slices empty)
    against its plain version on the same partials, and the merge against
    the plain decode over the whole cache; timed against the plain
    merge."""
    lens = [Smax + 1] + [max(1, Smax - (Smax * i) // B) for i in range(1, B)]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(B, Smax, KV, D, generator=gen, device="cuda").to(dtype)
    vc = torch.randn(B, Smax, KV, D, generator=gen, device="cuda").to(dtype)
    size = Smax // n
    parts = [kernels.decode_attention(
        q, kc[:, r * size:(r + 1) * size].contiguous(), vc[:, r * size:(r + 1) * size]
        .contiguous(), torch.clamp(torch.clamp(lengths, max=Smax) - r * size, 0, size)
        .to(torch.int32), return_lse=True) for r in range(n)]
    o = torch.stack([p[0] for p in parts])
    lse = torch.stack([p[1] for p in parts])
    got = kernels.merge_partials(o, lse)
    want = kernels.ref.merge_partials_ref(o, lse)
    whole = kernels.ref.decode_attention_ref(q, kc, vc, lengths)
    torch.cuda.synchronize()
    what = f"merge_partials n={n} B={B} H={H} KV={KV} D={D} Smax={Smax} {dtype}"
    err = max_err_within(got, want, TOL[str(dtype)], what)
    max_err_within(got, whole, TOL[str(dtype)], what + " (against the whole cache)")
    b_ms, b_by = bound(merge_partials_cost(n, B, H, D, dtype), dtype)
    return {"shape": {"n": n, "B": B, "H": H, "D": D}, "dtype": str(dtype),
            "max_abs_err": err, "ms": time_ms(lambda i: kernels.merge_partials(o, lse)),
            "plain_ms": time_ms(lambda i: kernels.ref.merge_partials_ref(o, lse)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


def check_flash(gen, B, S, H, KV, D, dtype, window: int = 0) -> dict:
    """Causal flash attention forward (windowed with ``window`` > 0, as
    local layers run it), output and LSE, over (B, S, H, D), and two
    launches bit for bit."""
    q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    route = kernels.flash_route(q, k, v)
    if dtype == torch.float32:  # the f32 forward's scores round as plain f32's
        assert route == "cuda-cores", route
    got, lse = kernels.flash_attention(q, k, v, return_lse=True, window=window)
    again, lse_again = kernels.flash_attention(q, k, v, return_lse=True, window=window)
    want = kernels.ref.causal_attention_ref(q, k, v, window=window)
    want_lse = kernels.ref.attention_lse_ref(q, k, window=window)
    torch.cuda.synchronize()
    what = f"flash_attention B={B} S={S} H={H} KV={KV} D={D} window={window} {dtype}"
    if not (torch.equal(got, again) and torch.equal(lse, lse_again)):
        raise AssertionError(f"{what}: two launches differ")
    del again, lse_again
    tol = TOL[str(dtype)]
    err = max(max_err_within(got, want, tol, what),
              max_err_within(lse, want_lse, tol, what + " lse"))
    del got, lse, want, want_lse
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    i = torch.arange(S, device="cuda")
    # yardstick: SDPA, causal, or with a boolean band mask
    band = ((i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
            if window else None)
    # with the LSE, as the timed call writes it
    cost = flash_attention_cost(B, S, H, KV, D, dtype, window=window, lse=True)
    b_ms, b_by = bound(cost, dtype)
    return {
        "shape": {"B": B, "S": S, "H": H, "KV": KV, "D": D, "window": window},
        "dtype": str(dtype), "max_abs_err": err, "route": route,
        "bound_split_tf32_ms": (cost.flops / SPLIT_TF32_OPS_PER_S * 1e3
                                if dtype == torch.float32 else None),
        # with the LSE, as the prefill and train paths launch it (through
        # flash_attention_train)
        "ms": time_ms(lambda i: kernels.flash_attention(q, k, v, return_lse=True,
                                                        window=window), iters=5),
        "plain_ms": time_ms(lambda i: kernels.ref.causal_attention_ref(
            q, k, v, window=window), iters=5),
        "library_ms": time_ms(lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band, is_causal=not window, enable_gqa=True),
            iters=5),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def check_flash_bwd(gen, B, S, H, KV, D, dtype, window: int = 0) -> dict:
    """Causal flash attention backward (windowed with ``window`` > 0) on
    the forward kernel's (out, lse): dq, dk, dv against the plain version,
    and two launches bit for bit."""
    q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    do = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    out, lse = kernels.flash_attention(q, k, v, return_lse=True, window=window)
    args = (q, k, v, out, lse, do)
    route = kernels.flash_route(q, k, v, do, backward=True)
    if dtype == torch.float32 and D % 8 == 0:  # the f32 tensor-core backward's
        assert route == "f32-tensor-cores", route
    got = kernels.flash_attention_bwd(*args, window=window)
    again = kernels.flash_attention_bwd(*args, window=window)
    want = kernels.ref.flash_attention_bwd_ref(*args, True, window)
    torch.cuda.synchronize()
    what = f"flash_attention_bwd B={B} S={S} H={H} KV={KV} D={D} window={window} {dtype}"
    err = rel = 0.0
    for name, g, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
        rel = max(rel, rel_err(g.float(), w.float()))
        if not torch.equal(g, g2):
            raise AssertionError(f"{what} {name}: two launches differ")
        if dtype == torch.float32:
            err = max(err, abs_rel_err(g, w, BWD_F32_ATOL, BWD_F32_RTOL,
                                       what + " " + name))
        else:
            e = (g.float() - w.float()).abs().max().item()
            if not torch.isfinite(g).all() or e > BWD_BF16_REL * w.float().abs().max().item():
                raise AssertionError(f"{what} {name}: max abs error {e} over "
                                     f"{BWD_BF16_REL} of the largest entry")
            err = max(err, e)
    del got, again, want
    # yardstick: SDPA on K/V expanded to H heads (outside the timing), its
    # flash backend in bf16 (it takes no f32: there SDPA picks its backend),
    # or with a boolean band mask for a window (SDPA picks a backend that
    # takes the mask); backward time taken as (forward + backward) -
    # forward, both replayed from CUDA graphs
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def backend():
        return (sdpa_kernel(SDPBackend.FLASH_ATTENTION)
                if dtype == torch.bfloat16 and not window else contextlib.nullcontext())

    G = H // KV
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt, vt = (x.repeat_interleave(G, 2).transpose(1, 2).contiguous().requires_grad_()
              for x in (k, v))
    dot = do.transpose(1, 2).contiguous()
    i_ = torch.arange(S, device="cuda")
    band = ((i_[None, :] <= i_[:, None]) & (i_[None, :] > i_[:, None] - window)
            if window else None)

    def sdpa(grad):
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                              is_causal=not window)

    def sdpa_fwd(i):
        with backend(), torch.no_grad():
            sdpa(False)

    def sdpa_fwd_bwd(i):
        with backend():
            torch.autograd.grad(sdpa(True), (qt, kt, vt), dot)

    fwd_ms = time_ms(sdpa_fwd, iters=5)
    library_ms = time_ms(sdpa_fwd_bwd, iters=5) - fwd_ms
    del qt, kt, vt, dot
    cost = flash_attention_bwd_cost(B, S, H, KV, D, dtype, window=window)
    b_ms, b_by = bound(cost, dtype)
    lib = _build.library()
    tile = {"bf16-tensor-cores": lib.repro_flash_attention_bwd_key_tile(),
            "f32-tensor-cores": lib.repro_flash_attention_bwd_f32_key_tile()}.get(route)
    nsplit = (_dkv_splits(B, S, H, KV, tile, _build.sm_count(0), window,
                          paired=route == "f32-tensor-cores") if tile else 1)
    return {
        "shape": {"B": B, "S": S, "H": H, "KV": KV, "D": D, "window": window},
        "dtype": str(dtype), "max_abs_err": err, "route": route,
        "bound_split_tf32_ms": (cost.flops / SPLIT_TF32_OPS_PER_S * 1e3
                                if dtype == torch.float32 else None),
        "plan": f"dk/dv pass in {nsplit} query ranges; max error {rel:.3g} of the "
                "output's largest entry",
        "ms": time_ms(lambda i: kernels.flash_attention_bwd(*args, window=window),
                      iters=5),
        "plain_ms": time_ms(lambda i: kernels.ref.flash_attention_bwd_ref(
            *args, True, window), iters=5),
        "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
    }


def exact_attention(q, k, v, do, window: int = 0) -> tuple:
    """out, lse, dq, dk, dv of causal GQA attention in f64, by autograd
    through the plain statement."""
    qd, kd, vd = (t.double().requires_grad_() for t in (q, k, v))
    S, G = q.shape[1], q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd.repeat_interleave(G, 2)) / math.sqrt(q.shape[3])
    i = torch.arange(S, device=q.device)
    mask = i[None, :] <= i[:, None]
    if window:
        mask = mask & (i[None, :] > i[:, None] - window)
    s = s.masked_fill(~mask, float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vd.repeat_interleave(G, 2))
    out.backward(do.double())
    return (out.detach(), torch.logsumexp(s, -1).transpose(1, 2).detach(), qd.grad, kd.grad,
            vd.grad)


def unaligned(t):
    """The same values 4 bytes into a fresh buffer: rows off 16-byte
    boundaries, which the flash kernels' CUDA-core variant takes."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


# how much farther from f64 the f32 tensor-core flash backward may be than
# the CUDA-core one, of the largest f64 entry: both take p from the same
# scores and lse, and their products' own rounding (split TF32 against f32
# FMA chains) differs by about 2^-21 of a product
NEAR_HARD_MARGIN = 1e-5


def check_flash_near_hard(gen, B, S, H, KV, D, window: int = 0) -> dict:
    """f32 flash attention at scores in the hundreds (q and k of std 10:
    a score's std is 100 at any D), the near-hard attention the reference's
    init gives.  The forward and both backward variants on the forward's
    out and lse against f64, each error over the largest f64 entry: the
    tensor-core backward (the route these inputs take) must be no farther
    from f64 than the CUDA-core one (the same inputs on rows off 16-byte
    boundaries) by more than NEAR_HARD_MARGIN."""
    q = torch.randn(B, S, H, D, generator=gen, device="cuda") * 10
    k = torch.randn(B, S, KV, D, generator=gen, device="cuda") * 10
    v = torch.randn(B, S, KV, D, generator=gen, device="cuda")
    do = torch.randn(B, S, H, D, generator=gen, device="cuda")
    out, lse = kernels.flash_attention(q, k, v, return_lse=True, window=window)
    want = exact_attention(q, k, v, do, window)

    def rel(g, w):
        return ((g.double() - w).abs().max() / w.abs().max()).item()

    row = {"shape": {"B": B, "S": S, "H": H, "KV": KV, "D": D, "window": window},
           "out": rel(out, want[0]), "lse": rel(lse, want[1])}
    got = {}
    for variant, qq in (("f32-tensor-cores", q), ("cuda-cores", unaligned(q))):
        assert kernels.flash_route(qq, k, v, do, backward=True) == variant, variant
        got[variant] = kernels.flash_attention_bwd(qq, k, v, out, lse, do, window=window)
    for i, name in enumerate(("dq", "dk", "dv")):
        tc, cc = (rel(got[variant][i], want[2 + i]) for variant in got)
        row[name] = {"tensor-cores": tc, "cuda-cores": cc}
        if not torch.isfinite(got["f32-tensor-cores"][i]).all() or tc > cc + NEAR_HARD_MARGIN:
            raise AssertionError(f"flash_attention_bwd f32 near-hard {row['shape']} {name}: "
                                 f"{tc:.3g} of the largest entry off f64 on the tensor "
                                 f"cores, {cc:.3g} on the CUDA cores")
    del got, want
    return row


def check_rglru(gen, B, S, C) -> dict:
    """The RG-LRU scan over (B, S, C) f32 on the inputs of
    test_rglru_scan_sweep: log_a = -0.2 |N|, b ~ N."""
    log_a = -(torch.randn(B, S, C, generator=gen, device="cuda").abs() * 0.2)
    b = torch.randn(B, S, C, generator=gen, device="cuda")
    got = kernels.rglru_scan(log_a, b)
    want = kernels.ref.rglru_scan_ref(log_a, b)
    torch.cuda.synchronize()
    err = max_err_within(got, want, RGLRU_TOL, f"rglru_scan ({B}, {S}, {C})")
    del got, want
    b_ms, b_by = bound(rglru_scan_cost(log_a.numel()), torch.float32)
    return {
        "shape": [B, S, C], "dtype": "torch.float32", "max_abs_err": err,
        "ms": time_ms(lambda i: kernels.rglru_scan(log_a, b), iters=10),
        # S small kernels a call: one call a graph
        "plain_ms": time_ms(lambda i: kernels.ref.rglru_scan_ref(log_a, b),
                            iters=1, replays=2),
        "library_ms": None,  # no PyTorch call computes a linear recurrence
        "bound_ms": b_ms, "bound_by": b_by,
    }


def check_mlstm(gen, B, S, H, dk, chunk, dtype) -> dict:
    """The chunkwise mLSTM with its final carry, as the prefill launches it,
    on the inputs of test_mlstm_chunk_sweep: i_pre ~ N - 2, f_pre ~ N + 3."""
    q, k, v = (torch.randn(B, S, H, dk, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    i_pre = torch.randn(B, S, H, generator=gen, device="cuda") - 2.0
    f_pre = torch.randn(B, S, H, generator=gen, device="cuda") + 3.0
    args = (q, k, v, i_pre, f_pre)
    got, final = kernels.mlstm_chunk(*args, chunk=chunk, return_final=True)
    want, wfinal = kernels.ref.mlstm_chunk_ref(*args, chunk=chunk, return_final=True)
    torch.cuda.synchronize()
    what = f"mlstm_chunk B={B} S={S} H={H} dk={dk} chunk={chunk} {dtype}"
    err = max(abs_rel_err(g, w, MLSTM_ATOL, MLSTM_RTOL, f"{what} {name}")
              for name, g, w in zip(("h", "C", "n", "m"), (got, *final), (want, *wfinal)))
    del got, final, want, wfinal
    # the products' rate follows the input type: bf16 q, k, v run them on
    # the tensor cores (989 TFLOP/s; the kernel's split of its f32 operands
    # into bf16 terms is its own choice, not the work's), f32 ones on the
    # CUDA cores (67 TFLOP/s)
    b_ms, b_by = bound(mlstm_chunk_cost(B, S, H, dk, dtype, chunk=chunk, final=True),
                       dtype)
    return {
        "shape": {"B": B, "S": S, "H": H, "dk": dk, "chunk": chunk},
        "dtype": str(dtype), "max_abs_err": err,
        "ms": time_ms(lambda i: kernels.mlstm_chunk(*args, chunk=chunk,
                                                    return_final=True), iters=5),
        "plain_ms": time_ms(lambda i: kernels.ref.mlstm_chunk_ref(
            *args, chunk=chunk, return_final=True), iters=5),
        "library_ms": None,  # no PyTorch call computes it
        "bound_ms": b_ms, "bound_by": b_by,
    }


def check_rglru_bwd(gen, B, S, C) -> dict:
    """The RG-LRU backward over (B, S, C) f32 on the forward kernel's h
    (inputs as check_rglru's, dh ~ N): dlog_a and db against the plain
    reverse loop, and two launches bit for bit."""
    log_a = -(torch.randn(B, S, C, generator=gen, device="cuda").abs() * 0.2)
    b = torch.randn(B, S, C, generator=gen, device="cuda")
    dh = torch.randn(B, S, C, generator=gen, device="cuda")
    h = rglru_mod.rglru_scan_fwd(log_a, b)
    del b
    got = kernels.rglru_scan_bwd(log_a, h, dh)
    again = kernels.rglru_scan_bwd(log_a, h, dh)
    want = kernels.ref.rglru_scan_bwd_ref(log_a, h, dh)
    torch.cuda.synchronize()
    what = f"rglru_scan_bwd ({B}, {S}, {C})"
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{what}: two launches differ")
    err = max(abs_rel_err(g, w, RGLRU_TOL, RGLRU_TOL, f"{what} {name}")
              for name, g, w in zip(("dlog_a", "db"), got, want))
    del got, again, want
    n = log_a.numel()
    b_ms, b_by = bound(rglru_scan_bwd_cost(n), torch.float32)
    # a same-bytes yardstick: one torch.add moving 5 n floats (2 reads, 1 write)
    x = torch.randn(5 * n // 3, generator=gen, device="cuda")
    y, z = torch.randn_like(x), torch.empty_like(x)
    add_ms = time_ms(lambda i: torch.add(x, y, out=z), iters=10)
    del x, y, z
    return {
        "shape": [B, S, C], "dtype": "torch.float32", "max_abs_err": err,
        "ms": time_ms(lambda i: kernels.rglru_scan_bwd(log_a, h, dh), iters=10),
        "plain_ms": time_ms(lambda i: kernels.ref.rglru_scan_bwd_ref(log_a, h, dh),
                            iters=1, replays=2),
        "library_ms": None,  # no PyTorch call computes a linear recurrence
        "plan": f"torch.add over the same bytes {add_ms:.4f} ms",
        "bound_ms": b_ms, "bound_by": b_by,
    }


def mlstm_bwd_close(got, want, dtype, what: str) -> float:
    """Each gradient against its plain version, relative to its largest
    entry: f32 within MLSTM_ATOL + MLSTM_RTOL of it (every entry is a sum
    of terms of both signs over a chunk, dlog_f a reverse cumulative sum
    of them, so its rounding scales with the terms, not with the entry);
    bf16 inputs within BWD_BF16_REL (dq, dk, dv are rounded to bf16, and
    the forward's h came from bf16 products)."""
    err = 0.0
    for name, g, w in zip(("dq", "dk", "dv", "dlog_i", "dlog_f"), got, want):
        e = (g.float() - w.float()).abs().max().item()
        big = w.float().abs().max().item()
        limit = (MLSTM_ATOL + MLSTM_RTOL * big if dtype == torch.float32
                 else BWD_BF16_REL * big)
        if not torch.isfinite(g).all() or e > limit:
            raise AssertionError(f"{what} {name}: max abs error {e} over {limit} "
                                 f"(largest entry {big})")
        err = max(err, e)
    return err


def check_mlstm_bwd(gen, B, S, H, dk, chunk, dtype) -> dict:
    """The mLSTM backward on the forward kernel's workspace, denominators
    and h (inputs as check_mlstm's, dh ~ N): dq, dk, dv, dlog_i, dlog_f
    against the plain version, and two launches bit for bit."""
    q, k, v = (torch.randn(B, S, H, dk, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    log_i = torch.randn(B, S, H, generator=gen, device="cuda") - 2.0
    log_f = F.logsigmoid(torch.randn(B, S, H, generator=gen, device="cuda") + 3.0)
    dh = torch.randn(B, S, H, dk, generator=gen, device="cuda")
    h, _, (ws, den) = mlstm_mod.mlstm_chunk_fwd(q, k, v, log_i, log_f, chunk=chunk,
                                                keep=True)
    args = (q, k, v, log_i, log_f, ws, den, h, dh)
    got = kernels.mlstm_chunk_bwd(*args, chunk=chunk)
    again = kernels.mlstm_chunk_bwd(*args, chunk=chunk)
    want = kernels.ref.mlstm_chunk_bwd_ref(q, k, v, log_i, log_f, dh, chunk=chunk)
    torch.cuda.synchronize()
    what = f"mlstm_chunk_bwd B={B} S={S} H={H} dk={dk} chunk={chunk} {dtype}"
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{what}: two launches differ")
    err = mlstm_bwd_close(got, want, dtype, what)
    del got, again, want
    # the products' rate follows the input type, as check_mlstm's: bf16 q,
    # k, v run them on the tensor cores (989 TFLOP/s; the kernel's split of
    # its f32 operands into bf16 terms is its own choice, not the work's),
    # f32 ones at the CUDA cores' 67 TFLOP/s; the plan keeps the f32-rate
    # figure beside it.  The carries read are the forward's workspace.
    cost = mlstm_chunk_bwd_cost(B, S, H, dk, dtype, chunk=chunk)
    b_ms, b_by = bound(cost, dtype)
    f32_ms, f32_by = bound(cost, torch.float32)
    return {
        "shape": {"B": B, "S": S, "H": H, "dk": dk, "chunk": chunk},
        "dtype": str(dtype), "max_abs_err": err,
        "ms": time_ms(lambda i: kernels.mlstm_chunk_bwd(*args, chunk=chunk), iters=5),
        "plain_ms": time_ms(lambda i: kernels.ref.mlstm_chunk_bwd_ref(
            q, k, v, log_i, log_f, dh, chunk=chunk), iters=2),
        "library_ms": None,  # no PyTorch call computes it
        "bound_ms": b_ms, "bound_by": b_by,
        "plan": f"bound at the f32 rate {f32_ms:.4f} ms ({f32_by})",
    }


# the f32 mLSTM backward per layer against f64: a gradient's distance from
# f64 (over its largest f64 entry) may be at most twice the plain f32
# version's, or this if that is larger
MLSTM_BWD_F64_FLOOR = 1e-6


def mlstm_carries(ws, B, S, H, dk, c) -> list:
    """The carries (C (B,H,dk,dk), n (B,H,dk), m (B,H)) entering each chunk
    from the f32 forward kernel's workspace (C row-major with rows of dk;
    chunk 0's, never written, is zero)."""
    nc, dkp = S // c, -(-dk // 16) * 16
    P = B * H * nc
    Cw = ws[:P * dkp * dkp].view(B, H, nc, dkp * dkp)[..., :dk * dk].reshape(B, H, nc, dk, dk)
    nw = ws[P * dkp * dkp:P * dkp * (dkp + 1)].view(B, H, nc, dkp)[..., :dk]
    mw = ws[P * dkp * (dkp + 1):P * dkp * (dkp + 1) + P].view(B, H, nc)
    zero = (ws.new_zeros((B, H, dk, dk)), ws.new_zeros((B, H, dk)), ws.new_zeros((B, H)))
    return [zero] + [(Cw[:, :, t], nw[:, :, t], mw[:, :, t]) for t in range(1, nc)]


def mlstm_bwd_near_f64(args: tuple, got, want, kw: dict, what: str) -> dict:
    """The f32 backward kernel's gradients (``got``) on one call's inputs
    against the f64 evaluation of its own equations from the same forward
    state (the forward kernel's h, den and carries: ``ref.
    mlstm_chunk_bwd_state_ref``), as a distance over the largest f64 entry;
    the kernel must lie within twice the plain f32 evaluation's distance or
    MLSTM_BWD_F64_FLOOR (the pattern of check_flash_near_hard).  Beside it,
    end to end: the kernel and the plain version through autograd
    (``want``, which runs its own f32 forward) against
    ``mlstm_chunk_bwd_ref`` in f64 (logged: there the forward kernel's own
    rounding of h and den counts too)."""
    q, k, v, log_i, log_f, ws, den, h, dh = args
    B, S, H, dk = q.shape
    c = min(kw.get("chunk", 128), S)
    carries = mlstm_carries(ws, B, S, H, dk, c)
    inputs = (q, k, v, log_i, log_f, h, den)
    exact = kernels.ref.mlstm_chunk_bwd_state_ref(
        *(x.double() for x in inputs), [tuple(y.double() for y in cr) for cr in carries],
        dh.double(), chunk=c)
    plain = kernels.ref.mlstm_chunk_bwd_state_ref(*inputs, carries, dh, chunk=c)
    e2e = kernels.ref.mlstm_chunk_bwd_ref(*(x.double() for x in (q, k, v, log_i, log_f, dh)),
                                          **kw)
    row = {}
    for name, g, p, e, w, x in zip(("dq", "dk", "dv", "dlog_i", "dlog_f"), got, plain, exact,
                                   want, e2e):
        dist = [((y.double() - ref).abs().max() / ref.abs().max().clamp(min=1e-300)).item()
                for y, ref in ((g, e), (p, e), (g, x), (w, x))]
        row[name] = dist
        if not torch.isfinite(g).all() or dist[0] > max(2 * dist[1], MLSTM_BWD_F64_FLOOR):
            raise AssertionError(f"{what} {name}: {dist[0]:.3g} of the largest entry off its "
                                 f"equations in f64, their plain f32 evaluation {dist[1]:.3g}")
    return row


# -------------------------------------------------------------------- serve


def serve_trace(vocab: int, seed: int, prefix_len=128, unique_len=20,
                disjoint_len=160, max_new=32) -> list:
    """16 requests: 8 share a ``prefix_len``-token prefix and then diverge
    (their length is off the block grid, so the committed tail is shared
    and copy-on-write fires), 8 are disjoint.  One shared request leads,
    so the other seven arrive after its prompt is cached."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len).tolist()
    shared = [prefix + rng.integers(0, vocab, unique_len).tolist()
              for _ in range(8)]
    disjoint = [rng.integers(0, vocab, disjoint_len).tolist() for _ in range(8)]
    order = [shared[0]] + disjoint[:7] + shared[1:] + disjoint[7:]
    return [(rid, p, max_new) for rid, p in enumerate(order)]


def fixed_trace(vocab: int, seed: int, n=8, prompt_len=48, max_new=32) -> list:
    """``n`` requests of about ``prompt_len`` random tokens (47 to 49)."""
    rng = np.random.default_rng(seed + 1)
    return [(rid, rng.integers(0, vocab, prompt_len - 1 + rid % 3).tolist(),
             max_new) for rid in range(n)]


def drive(eng, trace) -> dict:
    """Submit ``trace`` and step the engine until it drains, timing
    tokens/s, per-request TTFT (submit to first returned token) and peak
    admitted concurrency."""
    for rid, prompt, max_new in trace:
        eng.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=max_new))
    first: dict = {}
    peak = 0
    t0 = time.monotonic()
    while eng.queue or eng.slots_busy:
        out = eng.step()  # ends in a device-to-host copy: synchronous
        now = time.monotonic()
        peak = max(peak, eng.slots_busy)
        for rid, _tok in out:
            first.setdefault(rid, now - t0)
        if eng.ticks > 5000:
            raise AssertionError("engine did not drain in 5000 ticks")
    wall = time.monotonic() - t0
    ttfts = sorted(first.values())

    def pct(q: float) -> float:
        return ttfts[min(len(ttfts) - 1, int(q * len(ttfts)))]

    gen = sum(len(r.generated) for r in eng.finished)
    return {"wall_s": wall, "generated": gen, "tokens_per_s": gen / wall,
            "ttft_p50_s": pct(0.50), "ttft_p99_s": pct(0.99),
            "peak_concurrency": peak, "ticks": eng.ticks}


def check_finished(eng, trace, vocab: int) -> None:
    done = {r.rid: r for r in eng.finished}
    assert len(done) == len(trace), f"{len(done)} of {len(trace)} finished"
    for rid, _p, max_new in trace:
        toks = done[rid].generated
        assert len(toks) == max_new and all(0 <= t < vocab for t in toks), rid


def log_serve(m: dict, smi: str) -> None:
    log(f"   {m['generated']} tokens in {m['wall_s']:.3f} s: "
        f"{m['tokens_per_s']:.2f} tokens/s, TTFT p50 {m['ttft_p50_s']:.4f} s "
        f"p99 {m['ttft_p99_s']:.4f} s, peak concurrency "
        f"{m['peak_concurrency']}, {m['ticks']} ticks ({smi})")


def counts() -> dict:
    return {fn.__name__: fn.launches for fn in kernels.KERNELS}


def decode_launches_since(before: dict) -> dict:
    """The dense and paged decode kernels' launches since ``counts()`` gave
    ``before``."""
    now = counts()
    return {k: now[k] - before[k] for k in ("decode_attention", "paged_decode_attention")}


def tick_inputs(cfg, opts, trace, C: int):
    """A fresh pool and one tick's inputs: 8 slots, each advancing through
    the first ``C`` tokens of its prompt."""
    B, bs = 8, 16
    state = paged_model.init_paged_state(cfg, B, B + 1, bs, opts.dtype, "cuda")
    tables = torch.arange(1, B + 1, dtype=torch.int32, device="cuda")[:, None]
    feed = torch.tensor([p[:C] for _rid, p, _n in trace[:B]], dtype=torch.int32,
                        device="cuda")
    counts = torch.full((B,), C, dtype=torch.int32, device="cuda")
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    return state, tables, feed, counts, active


def first_tick_logits(cfg, params, opts, trace, C, attn_impl):
    tick = paged_model.make_paged_tick(cfg, opts, attn_impl=attn_impl)
    state, *inputs = tick_inputs(cfg, opts, trace, C)
    logits, _ = tick(params, state, *inputs)
    return logits


def profiled(fn, by_op: bool = False, ranges: tuple = (),
             device_only: bool = False) -> dict:
    """Wall time of ``fn()`` (host clock, synchronized) and its device time
    by kernel (torch.profiler; kernels on one stream do not overlap).  With
    ``by_op``, also the host ops whose kernels took the most device time,
    with their input shapes.  ``ranges`` names ``record_function`` ranges
    (``moe_ranges``) whose kernels' device time is reported apart.  With
    ``device_only`` the host ops are not traced (for a function of 1e5
    host ops, whose trace takes minutes to read back)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = ([ProfilerActivity.CUDA] if device_only
                  else [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with profile(activities=activities, record_shapes=by_op) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies); a CPU op's device time is
    # its kernels' again
    # (a range's own device-side span is left out: its kernels count)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and e.key not in ranges]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms == 0:
        raise AssertionError("the profiler recorded no device time")
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "busy_share": device_ms / wall_ms, "top": rows[:10],
           "port": [r for r in rows if "repro::" in r[0]]}
    if ranges:  # the device time of the kernels launched inside each range
        out["ranges"] = {e.key: (e.device_time_total / 1e3, e.count)
                         for e in prof.key_averages()
                         if e.device_type == DeviceType.CPU and e.key in ranges}
    if by_op:
        def host_ops(events, label):
            ops = [(label(e), e.device_time_total / 1e3, e.count) for e in events
                   if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
                   and e.device_time_total > 0]
            return sorted(ops, key=lambda r: -r[1])

        out["top_ops"] = host_ops(prof.key_averages(), lambda e: e.key)[:10]
        out["top_ops_by_shape"] = host_ops(
            prof.key_averages(group_by_input_shape=True),
            lambda e: f"{e.key} {e.input_shapes}")[:12]
    return out


def log_profile(label: str, p: dict, smi: str) -> None:
    log(f"   {label}: wall {p['wall_ms']:.3f} ms, device busy "
        f"{p['device_ms']:.3f} ms ({p['busy_share']:.3f} of wall) ({smi})")
    for name, ms, calls in p["top"]:
        log(f"      {ms:9.3f} ms  {calls:6d} calls  {name[:90]}")
    log("   the port's kernels: " + "; ".join(
        f"{name.split('namespace)::')[-1].split('(')[0]} {ms:.3f} ms / {calls} calls"
        for name, ms, calls in p["port"]))
    for key, what in (("top_ops", "host ops"), ("top_ops_by_shape", "host ops by input shape")):
        if key in p:
            log(f"   {what}, by the device time of their kernels (children included):")
            for name, ms, calls in p[key]:
                log(f"      {ms:9.3f} ms  {calls:6d} calls  {name[:150]}")


def profile_tick(cfg, params, opts, trace, C) -> dict:
    """One paged tick of ``C`` micro-steps on a fresh pool, profiled."""
    tick = paged_model.make_paged_tick(cfg, opts)
    state, *inputs = tick_inputs(cfg, opts, trace, C)
    tick(params, state, *inputs)  # warm
    state, *inputs = tick_inputs(cfg, opts, trace, C)
    return profiled(lambda: tick(params, state, *inputs))


def prefill_then_decode(cfg, params, opts, tokens, n_decode: int):
    """``make_prefill_step`` over ``tokens`` (1, S), then ``n_decode``
    greedy decode steps from its cache.  Returns the prefill's last logits
    row and the host wall times of the prefill and of the decode steps."""
    prefill = make_prefill_step(cfg, opts, max_len=tokens.shape[1] + n_decode)
    step = make_decode_step(cfg, opts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens})
    last = logits[:, -1]
    del logits
    nxt = torch.argmax(last, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(n_decode):
        lg, cache = step(params, cache, nxt)
        nxt = torch.argmax(lg, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return last, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def card_count(fn, *args) -> dict:
    """``fn(*args)`` counted once in kernel mode on the card (each kernel's
    launch counts by its cost, through the wrappers' hook), then timed:
    the least of 3 runs by CUDA events, ms."""
    _, totals = count_ops(fn, *args)
    times = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return {"totals": totals, "ms": min(times)}


def fake_counts(cfg, opts, prefill_tokens, batch: int, seq: int) -> dict:
    """Phase 6's prefill and a phase-7 train step counted as the dry-run
    counts, in kernel mode on fake tensors of the same shapes and dtypes
    (nothing allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake = FakeTensorMode()
    with fake:
        params = cast_params(init_params(cfg, seed=0, device="cpu"), opts.dtype, "cpu")
        tokens = torch.empty(prefill_tokens.shape, dtype=prefill_tokens.dtype)
        prefill = make_prefill_step(cfg, opts, max_len=tokens.shape[1])
        with torch.no_grad():
            _, pre = count_ops(prefill, params, {"tokens": tokens}, shapes_only=True)
        del params
        tcfg = TrainConfig(remat=True)
        state = init_train_state(cfg, tcfg, device="cpu")
        state["step"] = 0  # a fake 0-dim step cannot be read on the host
        tb = {k: torch.empty((batch, seq), dtype=torch.int32) for k in ("tokens", "labels")}
        _, train = count_ops(make_train_step(cfg, tcfg, opts), state, tb, shapes_only=True)
    return {"prefill": pre, "train": train}


def analysis_phase(analysis: dict, cfg, opts, prefill_tokens, batch: int, seq: int,
                   smi: str, tp: list) -> None:
    """Phase 18 (see the module's docstring)."""
    t0 = time.perf_counter()
    log(f"== analysis: the dry-run of {cfg.name} on fake tensors, per device")
    for multi_pod in (False, True):
        for shape_name in SHAPES:
            rec = dryrun.run_cell(cfg.name, shape_name, multi_pod=multi_pod, verbose=False)
            assert rec["status"] in ("ok", "skipped"), rec
            if rec["status"] == "skipped":
                log(f"   {shape_name} {rec['mesh']}: skipped ({rec['reason']})")
                continue
            r, m = rec["roofline"], rec["memory"]
            log(f"   {shape_name} {rec['mesh']} ({rec['kind']}, {rec['rows']} rows a "
                f"rank over {rec['batch_axes']}, model axis {rec['model_axis']}): "
                f"{r['flops_per_device']:.6g} FLOP, {r['bytes_per_device']:.6g} B, "
                f"collectives {r['collective_bytes_per_device']:.6g} B, peak "
                f"{m['peak_bytes'] / 1e9:.2f} GB (fits 80 GB: {m['fits']}); "
                f"compute {r['compute_s'] * 1e3:.3f} ms, memory {r['memory_s'] * 1e3:.3f} "
                f"ms, collective {r['collective_s'] * 1e3:.3f} ms, dominant "
                f"{r['dominant']}; model FLOPs / counted {r['model_vs_counted_flops']:.4f}")
    fake = fake_counts(cfg, opts, prefill_tokens, batch, seq)
    for name, what in (("prefill", f"prefill {tuple(prefill_tokens.shape)}"),
                       ("train", f"train step {batch} x {seq}")):
        card, ms = analysis[name]["totals"], analysis[name]["ms"]
        want = fake[name]
        for key in ("flops", "bytes", "by_kernel"):
            assert getattr(card, key) == getattr(want, key), \
                (name, key, getattr(card, key), getattr(want, key))
        share = card.flops / (ms / 1e3) / HW["peak_flops_bf16"]
        log(f"   {what}, kernel mode: {card.flops:.6g} FLOP, {card.bytes:.6g} B on the "
            f"card = on fake tensors; kernels {card.by_kernel}; bytes_raw "
            f"{card.bytes_raw:.6g} (fake {want.bytes_raw:.6g}); counted peak "
            f"{card.peak_bytes / 2**30:.2f} GiB (fake {want.peak_bytes / 2**30:.2f}); "
            f"{ms:.3f} ms by CUDA events: {share:.4f} of 989 TFLOP/s ({smi})")
        assert 0 < share <= 1.05, (name, share)
    tp_counts_phase(tp)
    log(f"   analysis phase: {time.perf_counter() - t0:.1f} s")


def tp_counts_phase(tp: dict) -> None:
    """Phase 18's tensor-parallel part: each job's rank-0 count on the card
    (gloo collectives included) against rank 0's on fake tensors of an
    abstract (1, 1, 2) mesh."""
    for job in tp["serve"]:
        want = tp_serve_fake_count(job)
        for what in ("prefill", "decode"):
            card = job["count"][what]
            for key in ("flops", "bytes", "by_kernel", "coll_by_key"):
                assert card[key] == want[what][key], (job["job"], "tensor-parallel", what,
                                                      key, card[key], want[what][key])
            log(f"   {job['job']} tensor-parallel {what} ({job['tokens']} prompt, "
                f"max_len {job['max_len']}) on {TP_MESH}, rank 0, kernel mode: "
                f"{card['flops']:.6g} FLOP, {card['bytes']:.6g} B, collective bytes received "
                f"{card['coll_by_key']} on the card = on fake tensors of an abstract mesh; "
                f"kernels {card['by_kernel']}")
    for job in tp["train"]:
        card, want = job["count"], tp_fake_count(job)
        name = job["job"]
        for key in ("flops", "bytes", "by_kernel", "coll_by_key"):
            assert card[key] == want[key], (name, "tensor-parallel step", key, card[key],
                                            want[key])
        log(f"   {name} tensor-parallel train step {job['batch']} on {TP_MESH}, rank 0, "
            f"kernel mode: {card['flops']:.6g} FLOP, {card['bytes']:.6g} B, collective bytes "
            f"received {card['coll_by_key']} on the card = on fake tensors of an abstract "
            f"mesh; kernels {card['by_kernel']}")


def take_layers(params, n: int):
    """The first ``n`` main-group layers of ``params`` (views, no copy)."""
    def cut(tree):
        return ({k: cut(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree[:n])
    return {**params, "main": [cut(g) for g in params["main"]]}


def half_depth(cfg, params) -> tuple:
    """(config, parameters) of the model's first layers, half its depth or
    less: its dense prefix and the whole pattern groups that fit (views, no
    copy; no tail).  The engines' ticks are host-bound, so a serve run's
    wall follows the layers."""
    P = len(cfg.block_pattern)
    groups = max(1, (cfg.num_layers // 2 - cfg.first_dense) // P)
    return (cfg.with_(num_layers=cfg.first_dense + groups * P),
            {**take_layers(params, groups), "tail": []})


def capture(module, name: str, seen: list):
    """Replace ``module.name`` with a wrapper that records its inputs;
    returns a function that puts the original back."""
    real = getattr(module, name)

    def wrap(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    # a kernel wrapper counts its launches on the name it is looked up by
    wrap.__dict__.update(real.__dict__)

    def undo():
        real.__dict__.update(wrap.__dict__)
        setattr(module, name, real)

    setattr(module, name, wrap)
    return undo


def check_forward_flash(cfg2, params16, tokens, opts) -> None:
    """``forward``'s flash path against its plain path, bf16, full width.

    At 2 layers the logits of two correct attention paths part ways: the
    reference's init makes attention nearly hard (scores in the
    thousands) and v large (about 45 times unit scale), so a one-ulp
    difference in a few layer-1 outputs moves layer-2 scores by about a
    unit and changes which key wins in rows whose best two scores are that
    close.  In such rows any f32 implementation is off the exact result by
    up to about half a unit, so the kernel cannot be held to the plain
    version element by element either.  This holds each layer's kernel
    output, on the q, k, v that ``forward`` hands it, to the correctly
    rounded f64 result: it may leave no more elements off it than the
    plain version does.  It holds the 1-layer logits to the plain path's,
    and prints the 2-layer logits' difference without holding it."""
    plain = ModelOptions(compute_dtype="bfloat16", attn_impl="plain")
    seen = []
    undo = capture(layers, "flash_attention_train", seen)
    try:
        lk, _ = forward(params16, cfg2, tokens, opts=opts)
    finally:
        undo()
    lp, _ = forward(params16, cfg2, tokens, opts=plain)
    assert torch.isfinite(lk).all() and len(seen) == cfg2.num_layers
    per_pos = ((lk - lp).abs().amax(-1) / lp.abs().max())[0]
    log(f"   forward logits {tuple(tokens.shape)}, bf16, {cfg2.num_layers} layers, "
        f"flash vs plain attention: max |diff| / max |logit| = {rel_err(lk, lp):.3g}; "
        f"positions over {LOGITS_BF16_RTOL}: {(per_pos > LOGITS_BF16_RTOL).sum().item()} "
        f"of {per_pos.numel()}; argmax agrees on "
        f"{(lk.argmax(-1) == lp.argmax(-1)).float().mean().item():.4f} (not held: see "
        "check_forward_flash)")
    del lk, lp
    for i, ((q, k, v), _kw) in enumerate(seen):
        got = kernels.flash_attention(q, k, v)
        want = kernels.ref.causal_attention_ref(q, k, v)
        G, D = q.shape[2] // k.shape[2], q.shape[3]
        s = torch.einsum("bqhd,bkhd->bhqk", q.double(),
                         k.repeat_interleave(G, 2).double()) / math.sqrt(D)
        causal = torch.ones(s.shape[-2:], dtype=torch.bool, device="cuda").tril()
        s = s.masked_fill(~causal, float("-inf"))
        top2 = s.topk(2, dim=-1).values
        close = ((top2[..., 0] - top2[..., 1]) < 1).sum().item()
        p = torch.softmax(s, dim=-1)
        exact = torch.einsum("bhqk,bkhd->bqhd", p, v.repeat_interleave(G, 2).double())
        off = {name: (x != exact.to(q.dtype)).sum().item()
               for name, x in (("kernel", got), ("plain", want))}
        err = {name: (x.double() - exact).abs().max().item()
               for name, x in (("kernel", got), ("plain", want))}
        log(f"   layer {i} attention on forward's inputs, against f64: elements off "
            f"the rounded result: kernel {off['kernel']}, plain {off['plain']} of "
            f"{got.numel()}; max abs error: kernel {err['kernel']:.3g}, plain "
            f"{err['plain']:.3g}; kernel vs plain {(got.float() - want.float()).abs().max().item():.3g}; "
            f"rows whose best two scores are within 1: {close} of {top2.shape[:-1].numel()}")
        assert torch.isfinite(got).all() and off["kernel"] <= off["plain"], (i, off)
        del s, top2, p, exact
    del seen
    cfg1 = cfg2.with_(num_layers=1)
    params1 = take_layers(params16, 1)
    lk, _ = forward(params1, cfg1, tokens, opts=opts)
    lp, _ = forward(params1, cfg1, tokens, opts=plain)
    rel = rel_err(lk, lp)
    log(f"   forward logits {tuple(tokens.shape)}, bf16, 1 layer, flash vs plain "
        f"attention: max |diff| / max |logit| = {rel:.3g} (tolerance {LOGITS_BF16_RTOL})")
    assert rel <= LOGITS_BF16_RTOL, rel


# ---------------------------------------------------------------- recurrent


def norm_sites(cfg) -> int:
    """RMSNorm launches of one forward or decode step: each layer's pre-norm
    and, with an MLP or an MoE, its second norm (an MoE layer has d_ff 0);
    mLSTM's group norm; sLSTM's group and FFN norms; the final norm."""
    return 1 + sum(1 + (spec.d_ff > 0 or spec.use_moe)
                   + {"mlstm": 1, "slstm": 2}.get(spec.kind, 0)
                   for spec in layer_specs(cfg))


def recurrent_phase(arch: str, S: int, seed: int, smi: str) -> dict:
    """Full-width, full-depth ``arch`` in bf16: random f32 weights cast to
    bf16 (the f32 copy dropped), ``make_prefill_step`` over (1, S) tokens
    and 16 decode steps with exact launch counts, one profiled prefill and
    one profiled decode step, then serving at half depth or less
    (``half_depth``: 18 and 4 layers): recurrentgemma-9b through
    ``PagedServeEngine`` (8 requests of 160 + 32 tokens; per-slot rings
    and states, no prefix cache), xlstm-125m through ``ServeEngine`` (8
    requests of 47-49 + 32 tokens on 4 slots).  Returns the prefill run's
    launch counts."""
    cfg = get_config(arch)
    opts = ModelOptions(compute_dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda", dtype=opts.dtype)
    torch.cuda.synchronize()
    log(f"== prefill: {arch} bf16, {cfg.param_count() / 1e9:.3f} B params "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card), "
        f"ready in {time.perf_counter() - t0:.1f} s")
    n_decode = 16
    rng = np.random.default_rng(seed + 3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S))).to("cuda")
    prefill_then_decode(cfg, params, opts, tokens[:, :128], 1)  # warm
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    last, prefill_ms, decode_ms = prefill_then_decode(cfg, params, opts, tokens,
                                                      n_decode)
    got = counts()
    assert last.shape == (1, cfg.padded_vocab) and torch.isfinite(last).all()
    log(f"   (1, {S}) tokens through make_prefill_step: wall {prefill_ms:.3f} ms; "
        f"then {n_decode} decode steps: wall {decode_ms:.3f} ms "
        f"({decode_ms / n_decode:.3f} ms a step); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
    log(f"   launches {got}")
    kinds = cfg.layer_kinds
    want = {"rglru_scan": kinds.count("rglru"), "mlstm_chunk": kinds.count("mlstm"),
            "flash_attention": kinds.count("local"),
            "decode_attention": kinds.count("local") * n_decode,
            "rmsnorm": norm_sites(cfg) * (1 + n_decode),
            "paged_decode_attention": 0, "flash_attention_bwd": 0,
            "rglru_scan_bwd": 0, "mlstm_chunk_bwd": 0, "merge_partials": 0}
    assert got == want, (got, want)
    prefill = make_prefill_step(cfg, opts, max_len=S + 1)
    log_profile(f"prefill ({S} tokens x {cfg.num_layers} layers)",
                profiled(lambda: prefill(params, {"tokens": tokens}),
                         by_op=arch == "recurrentgemma-9b",
                         device_only=arch == "xlstm-125m"), smi)  # its loops' host ops
    _, cache = prefill(params, {"tokens": tokens})
    step = make_decode_step(cfg, opts)
    log_profile(f"decode step (context {S})",
                profiled(lambda: step(params, cache, tokens[:, 0].to(torch.int32))),
                smi)
    del cache

    cfg, params = half_depth(cfg, params)
    if arch == "recurrentgemma-9b":
        trace = [(rid, rng.integers(0, cfg.vocab_size, 160).tolist(), 32)
                 for rid in range(8)]
        make = functools.partial(PagedServeEngine, cfg, params, num_blocks=128,
                                 block_size=16, max_active=8, prefill_chunk=16,
                                 opts=opts)
        label = "PagedServeEngine, 8 slots, prefill chunk 16"
    else:
        trace = fixed_trace(cfg.vocab_size, seed)
        make = functools.partial(ServeEngine, cfg, params, num_slots=4,
                                 max_len=256, opts=opts)
        label = "ServeEngine, 4 slots, max_len 256"
    drive(make(), [(0, trace[0][1][:20], 2)])  # warm
    eng = make()
    kernels.reset_launch_counts()
    m = drive(eng, trace)
    log(f"== serve: {arch} bf16 at {cfg.num_layers} layers, {label}, {len(trace)} "
        f"requests of {min(len(p) for _r, p, _n in trace)}-"
        f"{max(len(p) for _r, p, _n in trace)} prompt tokens + {trace[0][2]} new")
    log_serve(m, smi)
    log(f"   launches {counts()}; metrics {eng.metrics()}")
    check_finished(eng, trace, cfg.vocab_size)
    if arch == "recurrentgemma-9b":
        assert eng.cache is None and eng.metrics()["prefillBacklog"] == 0
    del eng, params
    torch.cuda.empty_cache()
    return got


def mlstm_layer_vs_f64(args: tuple, kw: dict, label: str) -> dict:
    """One mLSTM layer's kernel output and its plain version, on the
    inputs its layer handed the kernel, against the f64 result: for each,
    (max abs error, elements outside MLSTM_ATOL + MLSTM_RTOL rel, |f64| at
    the worst); logged.  The outputs reach |h| ~ 1e4 where the normalizer
    cancels, so two f32 summation orders part by more than that band."""
    got, want = (fn(*args, **kw) for fn in (kernels.mlstm_chunk, kernels.ref.mlstm_chunk_ref))
    exact = kernels.ref.mlstm_chunk_ref(*(a.double() for a in args), **kw)
    band = MLSTM_ATOL + MLSTM_RTOL * exact.abs()
    stats = {"finite": bool(torch.isfinite(got).all())}
    for name, x in (("kernel", got), ("plain", want)):
        e = (x.double() - exact).abs()
        worst = e.argmax()
        stats[name] = (e.max().item(), (e > band).sum().item(),
                       exact.flatten()[worst].abs().item())
    kp = (got - want).abs().max().item()
    log(f"   {label} layer, mlstm_chunk {tuple(args[0].shape)} {args[0].dtype} on "
        f"its own inputs: kernel vs plain max abs {kp:.3g}; against f64 (max abs "
        f"error, elements outside {MLSTM_ATOL} + {MLSTM_RTOL} rel of "
        f"{exact.numel()}, |f64| at the worst): kernel {stats['kernel']}, plain "
        f"{stats['plain']}; max |h| {exact.abs().max().item():.3g}")
    return stats


def check_recurrent(arch: str, n_layers: int, seed: int, smi: str) -> None:
    """Full width, one pattern group (``n_layers``), random weights.  f32:
    the kernel path's logits over 4096 tokens against the plain path's;
    prefill of 2560 tokens plus 128 decode steps against ``forward`` over
    2688 (past the 2048 window); the paged engine's greedy tokens against
    the fixed-slot engine's (8 requests of 160 + 8 tokens, rings of 2048
    slots in both).  bf16: each RG-LRU, mLSTM and windowed flash kernel on
    the inputs its layer hands it in a kernel-path forward, against its
    plain version.  The mLSTM's outputs there reach |h| ~ 1e4, where the
    normalizer cancels, so two f32 summation orders part by more than
    5e-5 + 5e-4 rel: the kernel is held, as check_forward_flash holds
    gemma's attention, to the f64 result, with no more elements outside
    that band than the plain version leaves; each f32 mLSTM layer of the
    f32 kernel-path forward likewise, with the f32 kernel's launches in
    these checks logged."""
    cfg = get_config(arch).with_(num_layers=n_layers)
    t0 = time.perf_counter()
    params32 = init_params(cfg, seed=seed, device="cuda")
    rng = np.random.default_rng(seed + 4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 4096))).to("cuda")
    opts32 = ModelOptions(compute_dtype="float32")
    plain32 = ModelOptions(compute_dtype="float32", attn_impl="plain")
    seen32 = []  # the f32 mLSTM layers' inputs, held to f64 below
    undo = capture(kernels, "mlstm_chunk", seen32)
    try:
        lk, _ = forward(params32, cfg, tokens, opts=opts32)
    finally:
        undo()
    lp, _ = forward(params32, cfg, tokens, opts=plain32)
    rel = rel_err(lk, lp)
    log(f"== checks: {arch} at {n_layers} layers, full width\n   f32 logits (1, 4096), "
        f"kernel vs plain path: max |diff| / max |logit| = {rel:.3g} (tolerance "
        f"{RECURRENT_F32_RTOL}); argmax agrees on "
        f"{(lk.argmax(-1) == lp.argmax(-1)).float().mean().item():.4f}")
    assert torch.isfinite(lk).all() and rel <= RECURRENT_F32_RTOL, rel
    del lk, lp

    n0, n1 = 2560, 2688
    launched = mlstm_mod.mlstm_chunk.launches  # (capture's window is not in the count)
    decode0 = counts()
    full, _ = forward(params32, cfg, tokens[:, :n1], opts=opts32)
    pre, cache = forward_with_cache(params32, cfg, tokens[:, :n0], max_len=n1,
                                    opts=opts32)
    errs = [(pre[:, -1] - full[:, n0 - 1]).abs().max().item()]
    del pre
    for t in range(n0, n1):
        lg, cache = decode_step(params32, cfg, cache, tokens[:, t], opts32)
        errs.append((lg - full[:, t]).abs().max().item())
    rel = max(errs) / full.abs().max().item()
    log(f"   prefill {n0} + decode {n1 - n0} vs forward, f32: max |diff| / "
        f"max |logit| = {rel:.3g} (tolerance {PREFILL_DECODE_RTOL})")
    assert rel <= PREFILL_DECODE_RTOL, rel
    del full, cache

    trace = [(rid, rng.integers(0, cfg.vocab_size, 160).tolist(), 8)
             for rid in range(8)]
    paged = PagedServeEngine(cfg, params32, num_blocks=128, block_size=16,
                             max_active=8, prefill_chunk=16, opts=opts32)
    drive(paged, trace)
    fixed = ServeEngine(cfg, params32, num_slots=8, max_len=cfg.window or 256,
                        opts=opts32)
    drive(fixed, trace)
    got = {r.rid: r.generated for r in paged.finished}
    want = {r.rid: r.generated for r in fixed.finished}
    log(f"   f32 greedy tokens, paged vs fixed-slot engine: "
        f"{'the same' if got == want else 'DIFFER'} "
        f"({sum(map(len, got.values()))} tokens)")
    assert got == want, (got, want)
    del paged, fixed
    f32_decode = decode_launches_since(decode0)
    log(f"   f32 decode kernel launches in the prefill + decode and the two engines: "
        f"{f32_decode}")
    # (the recurrent families' paged engine keeps its windowed layers in
    # per-slot rings, which the dense kernel reads)
    assert f32_decode["decode_attention"] > 0 or "local" not in cfg.layer_kinds, f32_decode
    if seen32:
        log(f"   f32 mlstm_chunk launches in these checks: {len(seen32)} in the kernel-path "
            f"forward over 4096 tokens, {mlstm_mod.mlstm_chunk.launches - launched} in the "
            "forward over 2688, the prefill + decode and the two engines")
    for args, kw in seen32:
        stats = mlstm_layer_vs_f64(args, kw, "f32")
        # as the bf16 layers: no more elements off f64 than plain
        assert stats["finite"] and stats["kernel"][1] <= stats["plain"][1], stats
    del seen32

    params16 = cast_params(params32, torch.bfloat16)
    del params32
    seen = {"rglru_scan": [], "mlstm_chunk": [], "flash_attention_train": []}
    undo = [capture(kernels, "rglru_scan", seen["rglru_scan"]),
            capture(kernels, "mlstm_chunk", seen["mlstm_chunk"]),
            capture(layers, "flash_attention_train", seen["flash_attention_train"])]
    try:
        lk, _ = forward(params16, cfg, tokens, opts=ModelOptions(compute_dtype="bfloat16"))
    finally:
        for fn in undo:
            fn()
    assert torch.isfinite(lk).all()
    del lk
    for (log_a, b), _kw in seen["rglru_scan"]:
        err = abs_rel_err(kernels.rglru_scan(log_a, b),
                          kernels.ref.rglru_scan_ref(log_a, b), RGLRU_TOL, RGLRU_TOL,
                          f"{arch} layer rglru_scan")
        log(f"   bf16 layer, rglru_scan {tuple(log_a.shape)} on its own inputs vs "
            f"plain: max abs error {err:.3g} (tolerance {RGLRU_TOL} abs + rel)")
    for args, kw in seen["mlstm_chunk"]:
        stats = mlstm_layer_vs_f64(args, kw, "bf16")
        # as check_forward_flash: held to f64, no more elements off than plain
        assert stats["finite"] and stats["kernel"][1] <= stats["plain"][1], stats
    for (q, k, v), kw in seen["flash_attention_train"]:
        window = kw["window"]
        got = kernels.flash_attention(q, k, v, window=window)
        want = kernels.ref.causal_attention_ref(q, k, v, window=window)
        rel = rel_err(got.float(), want.float())
        log(f"   bf16 layer, windowed flash {tuple(q.shape)} window {window} on its own "
            f"inputs vs plain: max |diff| / max |plain| = {rel:.3g} (tolerance "
            f"{WINDOW_BF16_REL})")
        assert torch.isfinite(got).all() and rel <= WINDOW_BF16_REL, rel
    kinds = cfg.layer_kinds
    assert (len(seen["rglru_scan"]), len(seen["mlstm_chunk"]),
            len(seen["flash_attention_train"])) == (
        kinds.count("rglru"), kinds.count("mlstm"), kinds.count("local")), seen.keys()
    del seen, params16
    torch.cuda.empty_cache()
    log(f"   {arch} checks: {time.perf_counter() - t0:.1f} s ({smi})")


# -------------------------------------------------------------------- train


def leaf_names(tree) -> list:
    """A label for each leaf, in ``leaves`` order: its index and dict key."""
    keys = []
    map_params(lambda k, _t: keys.append(k), tree)
    return [f"{i}:{k}" for i, k in enumerate(keys)]


def clone_params(params):
    return map_params(lambda _k, p: p.detach().clone(), params)


def train_grads(params, cfg, batch, opts) -> tuple:
    """Loss and every parameter's gradient of ``loss_fn`` (remat on), as the
    train step computes them."""
    params = clone_params(params)
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, _ = loss_fn(params, cfg, batch, opts, remat=True)
    loss.backward()
    missing = [i for i, p in enumerate(flat) if p.grad is None]
    assert not missing, f"leaves {missing} got no gradient ({opts.attn_impl})"
    return loss.item(), [p.grad for p in flat]


def leaf_rel(got: list, want: list, names: list) -> tuple:
    """The largest over leaves of max |got - want| / max |want|, and that
    leaf's name."""
    rel = [((g - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
           for g, w in zip(got, want)]
    worst = max(range(len(rel)), key=rel.__getitem__)
    return rel[worst], names[worst]


def clip_factor(grads: list, ocfg: OptimizerConfig) -> torch.Tensor:
    """The factor ``clip_by_global_norm`` scales ``grads`` by."""
    return torch.clamp(ocfg.clip_norm / torch.clamp(global_norm(grads), min=1e-12),
                       max=1.0)


def adam_dir(g, ocfg: OptimizerConfig):
    """The first AdamW step's direction, before decay, for the clipped
    gradient ``g``: from zero moments the bias-corrected m and v are g and
    g squared."""
    return g / (g.abs() + ocfg.eps)


@contextlib.contextmanager
def routing_log(replay=None):
    """Record each ``_route`` call's expert choices, in call order (``replay``
    None; yields the list), or route each call by the recorded choices
    (yields, per call, the positions whose own choice differed).  Replayed
    gates are this call's probabilities at the recorded experts, so the
    gradients flow as usual."""
    real = moe_mod._route
    seen: list = []
    recorded = iter(replay) if replay is not None else None

    def route(params, xg, m):
        gates, idx, probs = real(params, xg, m)
        if recorded is None:
            seen.append(idx)
            return gates, idx, probs
        want = next(recorded)
        seen.append(int((idx.sort(-1).values != want.sort(-1).values).any(-1).sum()))
        return probs.gather(-1, want), want, probs

    moe_mod._route = route
    try:
        yield seen
    finally:
        moe_mod._route = real


def check_train_step(cfg_n, params32, batch, dtype, tol: dict, smi: str,
                     held: bool = True) -> None:
    """One train step from the same state and batch.  The loss and each
    gradient leaf: kernel path against the plain path; with MoE layers, the
    plain path routed as the kernel path was (``routing_log``: in f32 a
    position whose expert set flips between two correct paths moves its
    expert gradients by more than the tolerance).  The kernel path's
    ``make_train_step``: its clipped gradient (its first moment over 1 -
    b1) against the kernel gradients clipped, and each leaf's change
    against the first AdamW step in closed form, -lr * (g / (|g| + eps) +
    decay * p).  The same closed form from the two paths' gradients is
    logged, not held: it parts wherever |g| is near eps.  With ``held``
    False the kernel path's loss and gradients against the plain path's
    are logged, not held."""
    opts = {impl: ModelOptions(compute_dtype=dtype, attn_impl=impl)
            for impl in ("kernel", "plain")}
    ocfg, tcfg = TRAIN_CHECK_OPT, TrainConfig(optimizer=TRAIN_CHECK_OPT)
    names = leaf_names(params32)
    p0 = leaves(params32)
    kernels.reset_launch_counts()
    with routing_log() as routes:
        loss_k, grads_k = train_grads(params32, cfg_n, batch, opts["kernel"])
    assert kernels.flash_attention_bwd.launches == cfg_n.num_layers
    with routing_log(routes) as flips:
        loss_p, grads_p = train_grads(params32, cfg_n, batch, opts["plain"])
    if routes:
        log(f"   the plain path routed as the kernel path: its own expert sets differed at "
            f"{sum(flips)} of {sum(r.shape[0] * r.shape[1] for r in routes)} routed "
            f"positions over {len(routes)} routings (forward and remat)")
    g_rel, g_at = leaf_rel(grads_k, grads_p, names)
    fk, fp = clip_factor(grads_k, ocfg), clip_factor(grads_p, ocfg)
    u_rel, u_at = leaf_rel([adam_dir(g * fk, ocfg) for g in grads_k],
                           [adam_dir(g * fp, ocfg) for g in grads_p], names)
    near = [((g * fp).abs() < 100 * ocfg.eps).sum().item() for g in grads_p]
    zero_start = [i for i, p in enumerate(p0) if not p.any()]
    del grads_p

    state = init_train_state(cfg_n, tcfg, params=clone_params(params32))
    state, _ = make_train_step(cfg_n, tcfg, opts["kernel"])(state, batch)
    g_step = [m / (1 - ocfg.b1) for m in leaves(state["opt"]["m"])]
    s_rel, s_at = leaf_rel(g_step, [g * fk for g in grads_k], names)
    del grads_k
    lr = lr_schedule(ocfg, 0)
    d_rel, d_at = leaf_rel(
        [p1.detach() - p for p, p1 in zip(p0, leaves(state["params"]))],
        [-lr * (adam_dir(g, ocfg) + ocfg.weight_decay * p) for g, p in zip(g_step, p0)],
        names)
    del state, g_step
    l_rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"   train step, {dtype}, {cfg_n.num_layers} layer(s), {tuple(batch['tokens'].shape)} "
        f"tokens, kernels vs plain: loss {loss_k:.6f} vs {loss_p:.6f} (rel {l_rel:.3g}, "
        f"tolerance {tol['loss']}); gradients {g_rel:.3g} of the leaf's largest entry "
        f"(worst {g_at}; tolerance {tol['leaf']}{'' if held else '; NOT HELD here'}) ({smi})")
    log(f"   the kernel path's step (lr {lr:g}) against the first AdamW step in closed "
        f"form: clipped gradient {s_rel:.3g} (worst {s_at}), each leaf's change "
        f"{d_rel:.3g} (worst {d_at}) of the leaf's largest (tolerance {tol['leaf']})")
    log(f"   not held: that closed form's direction from the kernel and the plain "
        f"gradients parts by {u_rel:.3g} of the leaf's largest (worst {u_at}); "
        f"entries with |clipped g| < 100 eps: {sum(near)} of "
        f"{sum(p.numel() for p in p0)}, {sum(near[i] for i in zero_start)} of them in "
        f"the {len(zero_start)} leaves that start at zero "
        f"({', '.join(names[i] for i in zero_start)})")
    assert not held or (l_rel <= tol["loss"] and g_rel <= tol["leaf"]), (l_rel, g_rel)
    assert s_rel <= tol["leaf"] and d_rel <= tol["leaf"], (s_rel, d_rel)


# ------------------------------------------------------------ MoE, frontends


MOE_RANGES = ("moe.layer", "moe.route", "moe.experts", "moe.shared")


@contextlib.contextmanager
def moe_ranges():
    """Profiler ranges around the MoE layer's parts: the whole layer
    (``moe_apply``, where the model calls it), routing (``_route``), the
    routed experts' products (``_run_experts``) and the shared experts
    (``mlp_apply`` inside ``models.moe``).  Dispatch and combine are the
    layer less the other three."""
    from torch.profiler import record_function

    def ranged(label, fn):
        def wrap(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return wrap

    sites = [(lm_mod, "moe_apply", "moe.layer"),
             (moe_mod, "_route", "moe.route"), (moe_mod, "_run_experts", "moe.experts"),
             (moe_mod, "mlp_apply", "moe.shared")]
    real = [getattr(mod, name) for mod, name, _ in sites]
    for (mod, name, label), fn in zip(sites, real):
        setattr(mod, name, ranged(label, fn))
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(sites, real):
            setattr(mod, name, fn)


def log_moe_breakdown(p: dict, smi: str) -> None:
    """Routing, dispatch and combine, expert products, shared experts and
    attention (the flash and decode kernels) of a profiled run, device ms."""
    r = {k: v[0] for k, v in p["ranges"].items()}
    layer = r.get("moe.layer", 0.0)
    parts = {"routing": r.get("moe.route", 0.0), "experts": r.get("moe.experts", 0.0),
             "shared experts": r.get("moe.shared", 0.0)}
    parts["dispatch + combine"] = layer - sum(parts.values())
    attn = sum(ms for name, ms, _n in p["port"]
               if "flash" in name or "decode" in name)
    log(f"   MoE breakdown, device ms: " + "; ".join(
        f"{k} {v:.3f}" for k, v in parts.items())
        + f"; MoE layers in all {layer:.3f} ({p['ranges'].get('moe.layer', (0, 0))[1]} "
        f"calls); attention kernels {attn:.3f}; of {p['device_ms']:.3f} ms ({smi})")


def routing_flips(cfg, params, tokens, opts_a, opts_b):
    """Forward under two options; per MoE layer, the share of positions
    whose top-k expert set differs, and the logits' error over the positions
    whose sets agree in every MoE layer, relative to the largest logit."""
    outs = []
    for opts in (opts_a, opts_b):
        with routing_log() as seen:
            logits, _ = forward(params, cfg, tokens, opts=opts)
        outs.append((logits, [idx.reshape(-1, idx.shape[-1]).sort(-1).values
                              for idx in seen]))
    (la, sa), (lb, sb) = outs
    differ = [(a != b).any(dim=-1) for a, b in zip(sa, sb)]
    shares = [d.float().mean().item() for d in differ]
    agree = ~torch.stack(differ).any(dim=0)
    err = (la - lb).abs().amax(-1).flatten()[agree]
    rel = (err.max() / lb.abs().max()).item() if err.numel() else 0.0
    return shares, rel, err.numel()


def moe_f64_same_routing(args):
    """The MoE layer in f64 (weights, input, every product) on the routing
    that the f32 layer chose: ``_route``'s f32 gates and expert indices,
    widened."""
    params, x, m, act = args
    gates, idx, probs = moe_mod._route(params, x.reshape(-1, min(m.group_size, x.shape[0]
                                                               * x.shape[1]), x.shape[-1]), m)
    real = moe_mod._route
    moe_mod._route = lambda *_a, **_k: (gates.double(), idx, probs.double())
    try:
        wide = map_params(lambda _k, t: t.double(), params)
        out, _ = moe_mod.moe_apply(wide, x.double(), m, act)
    finally:
        moe_mod._route = real
    return out


def build_bf16(arch: str, seed: int, smi: str, num_layers: int = 0):
    """Full-width ``arch`` (full depth unless ``num_layers``) in bf16, drawn
    in f32 and cast layer by layer (``init_params(dtype=bf16)``): the f32
    tree and its bf16 copy are never on the card together."""
    cfg = get_config(arch)
    if num_layers:
        cfg = cfg.with_(num_layers=num_layers)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()  # what earlier phases left allocated
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in leaves(params))
    log(f"== {arch} bf16, {cfg.num_layers} layers, {cfg.param_count() / 1e9:.3f} B "
        f"params: drawn in f32 and cast layer by layer in {time.perf_counter() - t0:.1f} s; "
        f"weights {weights / 2**30:.2f} GiB, {(torch.cuda.memory_allocated() - base) / 2**30:.2f} "
        f"GiB allocated, peak {(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB while "
        f"drawing (f32 tree {4 * cfg.param_count() / 2**30:.1f} GiB, never whole; "
        f"{base / 2**30:.2f} GiB left by earlier phases not counted) ({smi})")
    return cfg, params, base, weights


def moe_phase(arch: str, seed: int, smi: str) -> dict:
    """Full-width, full-depth MoE family in bf16: prefill of (1, 2048) and
    16 decode steps with exact launch counts and peak memory, one profiled
    prefill and decode step with the MoE breakdown; then serving at half
    depth (its first layers: the engines' ticks are host-bound, so their
    wall follows the layers): deepseek-moe-16b through ``PagedServeEngine``
    (gemma-2b's trace: block 16, 8 active, chunk 16, prefix cache),
    qwen2-moe-a2.7b through ``ServeEngine`` (4 slots, max_len 256, 8
    requests of 47-49 + 32).  Returns the prefill run's launch counts."""
    cfg, params, base, weights = build_bf16(arch, seed, smi)
    opts = ModelOptions(compute_dtype="bfloat16")
    S, n_decode = 2048, 16
    rng = np.random.default_rng(seed + 5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S))).to("cuda")
    prefill_then_decode(cfg, params, opts, tokens[:, :128], 1)  # warm
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    last, prefill_ms, decode_ms = prefill_then_decode(cfg, params, opts, tokens, n_decode)
    got = counts()
    peak = torch.cuda.max_memory_allocated() - base
    assert last.shape == (1, cfg.padded_vocab) and torch.isfinite(last).all()
    log(f"   (1, {S}) tokens through make_prefill_step: wall {prefill_ms:.3f} ms; then "
        f"{n_decode} decode steps: wall {decode_ms:.3f} ms ({decode_ms / n_decode:.3f} ms a "
        f"step); peak memory {peak / 2**30:.2f} GiB = weights {weights / 2**30:.2f} + "
        f"{(peak - weights) / 2**30:.2f} GiB (cache, logits, one layer's transients; "
        f"earlier phases' {base / 2**30:.2f} GiB not counted) ({smi})")
    log(f"   launches {got}")
    L = cfg.num_layers
    want = {"rmsnorm": norm_sites(cfg) * (1 + n_decode), "paged_decode_attention": 0,
            "decode_attention": L * n_decode, "flash_attention": L,
            "flash_attention_bwd": 0, "rglru_scan": 0, "mlstm_chunk": 0,
            "rglru_scan_bwd": 0, "mlstm_chunk_bwd": 0, "merge_partials": 0}
    assert got == want, (got, want)
    # the logits (0.78 GiB for deepseek) and the cache (0.45 GiB) are the
    # largest; one MoE layer's dispatch tensors are a few hundred MB
    assert peak - weights < 4 * 2**30, (peak - weights) / 2**30
    prefill = make_prefill_step(cfg, opts, max_len=S + 1)
    step = make_decode_step(cfg, opts)
    with moe_ranges():
        p = profiled(lambda: prefill(params, {"tokens": tokens}), ranges=MOE_RANGES)
        log_profile(f"prefill ({S} tokens x {L} layers)", p, smi)
        log_moe_breakdown(p, smi)
        _, cache = prefill(params, {"tokens": tokens})
        p = profiled(lambda: step(params, cache, tokens[:, 0].to(torch.int32)),
                     ranges=MOE_RANGES)
        log_profile(f"decode step (context {S})", p, smi)
        log_moe_breakdown(p, smi)
    del cache

    cfg, params = half_depth(cfg, params)
    L = cfg.num_layers
    if arch == "deepseek-moe-16b":
        trace = serve_trace(cfg.vocab_size, seed)
        make = functools.partial(PagedServeEngine, cfg, params, num_blocks=256,
                                 block_size=16, max_active=8, prefill_chunk=16, opts=opts)
        label = "PagedServeEngine, block 16, 8 active, prefill chunk 16, prefix cache"
    else:
        trace = fixed_trace(cfg.vocab_size, seed)
        make = functools.partial(ServeEngine, cfg, params, num_slots=4, max_len=256,
                                 opts=opts)
        label = "ServeEngine, 4 slots, max_len 256"
    drive(make(), [(0, trace[0][1][:20], 2)])  # warm
    eng = make()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    m = drive(eng, trace)
    served = counts()
    log(f"== serve: {arch} bf16 at {L} layers, {label}, {len(trace)} requests of "
        f"{min(len(p) for _r, p, _n in trace)}-{max(len(p) for _r, p, _n in trace)} "
        f"prompt tokens + {trace[0][2]} new")
    log_serve(m, smi)
    log(f"   launches {served}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB; metrics {eng.metrics()}")
    check_finished(eng, trace, cfg.vocab_size)
    if arch == "deepseek-moe-16b":
        metrics = eng.metrics()
        assert served["paged_decode_attention"] > 0 and served["flash_attention"] == 0
        # per micro-step: every norm site once, every layer's paged attention once
        assert served["rmsnorm"] * L == served["paged_decode_attention"] * norm_sites(cfg)
        assert metrics["prefixHitRate"] > 0 and metrics["cowCopies"] >= 1, metrics
        assert metrics["prefillBacklog"] == 0, metrics
        del eng
        for tick_label, C in (("prefill tick", 16), ("decode tick", 1)):
            log_profile(f"{tick_label} ({C} micro-steps x {L} layers, 8 slots)",
                        profile_tick(cfg, params, opts, trace, C), smi)
    else:
        steps = sum(len(p) for _r, p, _n in trace) + eng.ticks
        assert served["decode_attention"] == L * steps, (served, steps)
        assert served["rmsnorm"] == norm_sites(cfg) * steps, (served, steps)
        del eng
    del params
    torch.cuda.empty_cache()
    return got


def check_moe(arch: str, seed: int, smi: str) -> None:
    """Full width, 2 layers, random f32 weights.  f32: the kernel path's
    logits and cache against the plain path's, ``moe_impl="sort"`` against
    ``"einsum"``, each MoE layer on its own inputs against an f64 MoE on
    the same routing, the paged engine's kernel path against its gather
    path (greedy tokens).  bf16: the kernel path against the plain path,
    with the share of positions whose expert set differs and the logits'
    error over the positions whose sets agree, held for one MoE layer
    alone (the deepseek dense first layer left out) and reported for the
    2 layers."""
    cfg = get_config(arch).with_(num_layers=2)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params32 = init_params(cfg, seed=seed, device="cuda")
    rng = np.random.default_rng(seed + 6)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 1024))).to("cuda")
    opts32 = ModelOptions(compute_dtype="float32")
    plain32 = ModelOptions(compute_dtype="float32", attn_impl="plain")
    lk, ck = forward_with_cache(params32, cfg, tokens, max_len=1024, opts=opts32)
    lp, cp = forward_with_cache(params32, cfg, tokens, max_len=1024, opts=plain32)
    rel = rel_err(lk, lp)
    cache_rel = max(rel_err(a.float(), b.float())
                    for seg in ("prefix", "main", "tail") for ea, eb in zip(ck[seg], cp[seg])
                    for a, b in zip(ea.values(), eb.values()))
    log(f"== checks: {arch} at 2 layers, full width\n   f32 (1, 1024), kernel vs plain "
        f"path: logits max |diff| / max |logit| = {rel:.3g}, cache {cache_rel:.3g} "
        f"(tolerance {MOE_F32_RTOL}); argmax agrees on "
        f"{(lk.argmax(-1) == lp.argmax(-1)).float().mean().item():.4f}")
    assert torch.isfinite(lk).all() and rel <= MOE_F32_RTOL and cache_rel <= MOE_F32_RTOL
    del lp, ck, cp
    ls, _ = forward(params32, cfg, tokens,
                    opts=ModelOptions(compute_dtype="float32", moe_impl="sort"))
    rel = rel_err(ls, lk)
    log(f"   f32 logits, moe_impl sort vs einsum: max |diff| / max |logit| = {rel:.3g} "
        f"(tolerance {MOE_F32_RTOL})")
    assert rel <= MOE_F32_RTOL, rel
    del ls, lk

    seen = []
    undo = capture(lm_mod, "moe_apply", seen)
    try:
        forward(params32, cfg, tokens, opts=opts32)
    finally:
        undo()
    for i, (args, _kw) in enumerate(seen):
        got, _ = moe_mod.moe_apply(*args)
        want = moe_f64_same_routing(args)
        err = (got.double() - want).abs().max().item()
        scale = want.abs().max().item()
        log(f"   MoE layer {i} (f32, {tuple(args[1].shape)}) on its own inputs vs f64 on the "
            f"same routing: max abs error {err:.3g} of max |out| {scale:.3g} (tolerance "
            f"{TOL['torch.float32']} of it)")
        assert torch.isfinite(got).all() and err <= TOL["torch.float32"] * scale, (err, scale)
        # the sort path on the card: the same bits in two calls
        sort_m = replace(args[2], impl="sort")
        a, _ = moe_mod.moe_apply(args[0], args[1], sort_m, args[3])
        b, _ = moe_mod.moe_apply(args[0], args[1], sort_m, args[3])
        assert torch.equal(a, b), "the sort dispatch is not deterministic"
    del seen

    trace = serve_trace(cfg.vocab_size, seed)
    tokens_by = {}
    for impl in ("kernel", "gather"):
        e = PagedServeEngine(cfg, params32, num_blocks=256, block_size=16, max_active=8,
                             prefill_chunk=16, opts=opts32, attn_impl=impl)
        drive(e, [(r, p, 8) for r, p, _n in trace])
        tokens_by[impl] = {r.rid: r.generated for r in e.finished}
    log(f"   f32 greedy tokens, paged engine kernel vs gather path: "
        f"{'the same' if tokens_by['kernel'] == tokens_by['gather'] else 'DIFFER'} "
        f"({sum(map(len, tokens_by['kernel'].values()))} tokens)")
    assert tokens_by["kernel"] == tokens_by["gather"], "f32 paged tokens differ"
    del e

    # bf16: at 2 layers the second layer's nearly hard attention parts two
    # correct paths (check_forward_flash), so that is reported; one MoE
    # layer alone (attention and MoE) is held, as gemma's 1-layer logits
    params16 = cast_params(params32, torch.bfloat16)
    del params32
    bf16 = (ModelOptions(compute_dtype="bfloat16"),
            ModelOptions(compute_dtype="bfloat16", attn_impl="plain"))
    cfg1 = cfg.with_(num_layers=1, first_dense=0)
    params1 = {**take_layers(params16, 1), "prefix": [], "tail": []}
    for c, p, held in ((cfg, params16, False), (cfg1, params1, True)):
        shares, rel, n = routing_flips(c, p, tokens, *bf16)
        log(f"   bf16 (1, 1024), {c.num_layers} layer(s), kernel vs plain path: positions "
            f"whose top-{c.moe.top_k} expert set differs, per MoE layer: "
            f"{', '.join(f'{x:.4f}' for x in shares)}; logits over the {n} positions whose "
            f"sets agree in every layer: max |diff| / max |logit| = {rel:.3g} "
            + (f"(tolerance {LOGITS_BF16_RTOL})" if held else "(not held: 2 layers)"))
        assert not held or rel <= LOGITS_BF16_RTOL, rel
    del params16, params1
    torch.cuda.empty_cache()
    log(f"   {arch} checks: {time.perf_counter() - t0:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")


def train_steps(step, state, src, n: int) -> list:
    """``n`` steps on the source's batches 0..n-1; per step the loss, aux
    loss, grad norm and host wall (which ends in reading the loss)."""
    out = []
    for i in range(n):
        batch = src.batch_at(i)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        rec = {k: float(m[k]) for k in ("loss", "aux_loss", "grad_norm")}
        rec["wall_s"] = time.perf_counter() - t0
        assert all(math.isfinite(v) for v in rec.values()), rec
        out.append(rec)
    return out


def log_train(records: list, tokens: int, smi: str) -> None:
    timed = [r["wall_s"] for r in records[1:]] or [records[0]["wall_s"]]
    wall = sum(timed) / len(timed)
    log(f"   per step (loss, aux loss, grad norm, wall s): " + "; ".join(
        f"{r['loss']:.4f} {r['aux_loss']:.4f} {r['grad_norm']:.4f} {r['wall_s']:.3f}"
        for r in records))
    log(f"   step wall {wall * 1e3:.3f} ms (mean after the first), {tokens / wall:.1f} "
        f"training tokens/s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB ({smi})")


def remat_flash_launches(cfg) -> int:
    """Flash forward launches of one train step under remat: prefix and tail
    layers once, main-group layers twice (forward, and again in backward)."""
    plan = stack_plan(cfg)
    once = sum(s.kind in ("attn", "local") for s in plan.prefix + plan.tail)
    main = sum(s.kind in ("attn", "local") for s in plan.pattern) * plan.num_groups
    return once + 2 * main


def check_train_f64(cfg, params32, batch, smi: str) -> None:
    """An MoE family's first f32 train step, the kernel path and the plain
    path each held to the plain path in f64 (``f64_plain``), all three on
    the kernel path's routing (``held_to_f64``)."""
    names = leaf_names(params32)
    with routing_log() as routes:
        _, grads_k = train_grads(params32, cfg, batch, ModelOptions(compute_dtype="float32"))
    with routing_log(routes):
        _, grads_p = train_grads(params32, cfg, batch,
                                 ModelOptions(compute_dtype="float32", attn_impl="plain"))
    _, grads_64 = f64_grads(params32, cfg, batch, routes)
    held = held_to_f64(grads_k, grads_p, grads_64, names)
    log_f64(held, len(names), f"the same step at {cfg.num_layers} layers, on the same routing,",
            smi)
    assert not held["failed"], held["failed"]
    del grads_k, grads_p, grads_64


def train_moe_frontends(seed: int, smi: str) -> None:
    """deepseek-moe-16b at full width and 3 layers (the dense first layer +
    2 MoE), musicgen-large at full depth through the launcher, and
    internvl2-26b at full width and 4 layers: f32 parameters and moments,
    bf16 compute, remat.  deepseek's first step's gradients, kernel path
    against plain path in f32 (``check_train_step``), are held at 2 layers
    and logged at 3; its bf16 routing flips are reported."""
    t_all = time.perf_counter()
    opts = ModelOptions(compute_dtype="bfloat16")
    tcfg = TrainConfig(remat=True)

    cfg = get_config("deepseek-moe-16b").with_(num_layers=3)
    src = StreamSource(vocab_size=cfg.vocab_size, batch=2, seq_len=1024, seed=seed)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, tcfg, seed=seed, device="cuda")
    step = make_train_step(cfg, tcfg, opts)
    kernels.reset_launch_counts()
    log(f"== train: deepseek-moe-16b, full width, 3 layers ({cfg.param_count() / 1e9:.3f} B "
        "params), 4 steps of 2 x 1024 tokens, f32 params and moments, bf16 compute, remat")
    records = train_steps(step, state, src, 4)
    got = counts()
    log_train(records, 2 * 1024, smi)
    log(f"   launches {got}")
    assert got["flash_attention"] == 4 * remat_flash_launches(cfg), got
    assert got["flash_attention_bwd"] == 4 * cfg.num_layers, got
    assert all(r["aux_loss"] > 0 for r in records), records
    del state, step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    mcfg = get_config("musicgen-large")
    log(f"== train: musicgen-large through repro_torch.launch.train.main, full depth "
        f"({mcfg.param_count() / 1e9:.3f} B params), 4 steps of 2 x (64 frontend + 960) "
        "tokens, f32 params and moments, bf16 compute, remat")
    records = train_launcher.main(["--arch", "musicgen-large", "--steps", "4",
                                   "--batch", "2", "--seq", "960"])
    got = counts()
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in records)
    log_train([{**r, "aux_loss": 0.0} for r in records], 2 * 1024, smi)
    log(f"   launches {got}")
    assert got["flash_attention"] == 4 * remat_flash_launches(mcfg), got
    assert got["flash_attention_bwd"] == 4 * mcfg.num_layers, got
    torch.cuda.empty_cache()

    icfg = get_config("internvl2-26b").with_(num_layers=4)
    torch.cuda.reset_peak_memory_stats()
    isrc = StreamSource(vocab_size=icfg.vocab_size, batch=1, seq_len=768, seed=seed,
                        frontend_len=icfg.frontend_len, frontend_dim=icfg.frontend_dim)
    state = init_train_state(icfg, tcfg, seed=seed, device="cuda")
    batch = {k: v.to("cuda") for k, v in isrc.batch_at(0).items()}
    with torch.no_grad():
        logits, _ = forward(state["params"], icfg, batch["tokens"], batch["frontend_embeds"],
                            opts)
    assert logits.shape == (1, 256 + 768, icfg.padded_vocab) and torch.isfinite(logits).all()
    del logits
    log(f"== internvl2-26b, full width, 4 layers ({icfg.param_count() / 1e9:.3f} B params): "
        f"forward of (1, 256 frontend + 768) in bf16: logits finite, shape (1, 1024, "
        f"{icfg.padded_vocab}); 2 train steps of that shape")
    records = train_steps(make_train_step(icfg, tcfg, opts), state, isrc, 2)
    log_train(records, 1024, smi)
    del state
    torch.cuda.empty_cache()
    # deepseek's first step, kernels against plain, f32: held at 2 layers
    # (the dense first layer + 1 MoE), as gemma-2b's; at 3 layers the
    # nearly hard attention of the reference's init carries the two paths'
    # f32 differences past the tolerance, so there each path is held to the
    # plain path in f64 on the same routing (check_train_f64)
    params32 = init_params(cfg, seed=seed, device="cuda")
    tb = {k: v.to("cuda") for k, v in src.batch_at(7).items()}
    check_train_step(cfg, params32, tb, "float32", TRAIN_F32, smi, held=False)
    check_train_f64(cfg, params32, tb, smi)
    check_train_step(cfg.with_(num_layers=2), take_layers(params32, 1), tb, "float32",
                     TRAIN_F32, smi)
    shares, rel, n = routing_flips(cfg, cast_params(params32, torch.bfloat16), tb["tokens"],
                                   opts,
                                   ModelOptions(compute_dtype="bfloat16", attn_impl="plain"))
    log(f"   bf16 train batch forward, kernel vs plain path: positions whose expert set "
        f"differs, per MoE layer: {', '.join(f'{x:.4f}' for x in shares)}; logits over the "
        f"{n} positions whose sets agree: max |diff| / max |logit| = {rel:.3g} (not held: "
        "3 layers of the reference's init)")
    del params32
    torch.cuda.empty_cache()
    log(f"   MoE and frontend training: {time.perf_counter() - t_all:.1f} s")


# ------------------------------------------------------ recurrent training


def remat_step_launches(cfg) -> dict:
    """Each kernel's launches in one train step under remat: a forward
    kernel once for a prefix or tail layer and twice for a main-group layer
    (forward, and again in backward), RMSNorm likewise at every norm site
    and once for the final norm, each backward kernel once a layer."""
    plan = stack_plan(cfg)
    once, main = plan.prefix + plan.tail, plan.pattern * plan.num_groups

    def fwd(fn):
        return sum(map(fn, once)) + 2 * sum(map(fn, main))

    def per_layer(fn):
        return sum(map(fn, once + main))

    def norms(spec):
        return (1 + (spec.d_ff > 0 or spec.use_moe)
                + {"mlstm": 1, "slstm": 2}.get(spec.kind, 0))

    def attn(spec):
        return spec.kind in ("attn", "local")

    return {"rmsnorm": 1 + fwd(norms), "paged_decode_attention": 0,
            "decode_attention": 0, "flash_attention": fwd(attn),
            "flash_attention_bwd": per_layer(attn),
            "rglru_scan": fwd(lambda sp: sp.kind == "rglru"),
            "rglru_scan_bwd": per_layer(lambda sp: sp.kind == "rglru"),
            "mlstm_chunk": fwd(lambda sp: sp.kind == "mlstm"),
            "mlstm_chunk_bwd": per_layer(lambda sp: sp.kind == "mlstm"), "merge_partials": 0}


def recurrent_train_phase(arch: str, n_layers, batch: int, seq: int, seed: int,
                          smi: str) -> dict:
    """``arch`` at full width (``n_layers`` of it, or full depth with None):
    f32 parameters and AdamW moments, bf16 compute, remat, the lcg stream.
    2 warm-up and 3 timed steps with every kernel's launches counted exactly
    per step, then one step profiled on the device.  Returns the five
    steps' launches."""
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.with_(num_layers=n_layers)
    opts = ModelOptions(compute_dtype="bfloat16")
    tcfg = TrainConfig(remat=True)
    src = StreamSource(vocab_size=cfg.vocab_size, batch=batch, seq_len=seq, seed=seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, tcfg, seed=seed, device="cuda")
    step = make_train_step(cfg, tcfg, opts)
    log(f"== train: {arch}, full width, {cfg.num_layers} layers "
        f"({cfg.param_count() / 1e9:.3f} B params), 5 steps (2 warm-up) of {batch} x "
        f"{seq} tokens, f32 params and moments, bf16 compute, remat")
    kernels.reset_launch_counts()
    records = train_steps(step, state, src, 5)
    got = counts()
    per_step = remat_step_launches(cfg)
    log_train(records[1:], batch * seq, smi)
    log(f"   launches over the 5 steps {got}")
    assert got == {k: 5 * v for k, v in per_step.items()}, (got, per_step)
    log_profile(f"train step ({batch} x {seq} tokens x {cfg.num_layers} layers, remat)",
                profiled(lambda: step(state, src.batch_at(5)), by_op=arch != "xlstm-125m",
                         device_only=arch == "xlstm-125m"), smi)  # its loops' 1e5 host ops
    del state, step
    torch.cuda.empty_cache()
    return got


@contextlib.contextmanager
def f64_plain():
    """The plain path in f64, an exact run to hold two f32 runs against:
    every ``.float()`` of the port leaves an f64 tensor f64 (as the JAX
    tests' f64 runs widen the reference's f32 casts), and RMSNorm, whose
    kernel takes no f64, runs its plain version.  Kernels are not touched:
    use it with ``attn_impl="plain"``."""
    real_float, real_norm = torch.Tensor.float, layers.rmsnorm_kernel

    def wide(self, *args, **kw):
        return self if self.dtype == torch.float64 else real_float(self, *args, **kw)

    torch.Tensor.float = wide
    layers.rmsnorm_kernel = kernels.ref.rmsnorm_ref
    try:
        yield
    finally:
        torch.Tensor.float = real_float
        layers.rmsnorm_kernel = real_norm


def f64_grads(params, cfg, batch, routes=None) -> tuple:
    """Loss and gradients of the plain path in f64 from the weights in
    ``params`` (f32, or already f64: then no copy is made), routed as
    ``routes`` records for an MoE."""
    params64 = map_params(lambda _k, p: p.detach().double().requires_grad_(True), params)
    ctx = routing_log(routes) if routes is not None else contextlib.nullcontext()
    with f64_plain(), ctx:
        loss, _ = loss_fn(params64, cfg, batch,
                          ModelOptions(compute_dtype="float64", attn_impl="plain"),
                          remat=True)
        loss.backward()
    return loss.item(), [p.grad for p in leaves(params64)]


def held_to_f64(grads_k, grads_p, grads_64, names) -> dict:
    """Per leaf, the kernel path's and the plain path's distance from the
    f64 gradient, relative to its largest entry.  A leaf is held if the
    kernel path lies within TRAIN_F32's leaf tolerance of the f64 gradient
    or within twice the plain path's distance (two f32 runs each carry
    their own rounding, which the stack amplifies alike: the bound of
    their sum); a kernel path much farther than the plain path fails it."""
    out = {"failed": [], "farther": 0, "ratio": (0.0, ""), "worst_k": (0.0, ""),
           "worst_p": 0.0}
    for gk, gp, g64, name in zip(grads_k, grads_p, grads_64, names):
        gk, gp = gk.to(g64.device), gp.to(g64.device)  # one leaf at a time from the host
        scale = g64.abs().max().clamp(min=1e-300)
        ek = ((gk.double() - g64).abs().max() / scale).item()
        ep = ((gp.double() - g64).abs().max() / scale).item()
        if ek > max(TRAIN_F32["leaf"], 2 * ep):
            out["failed"].append((name, ek, ep))
        out["farther"] += ek > ep
        out["ratio"] = max(out["ratio"], (ek / max(ep, 1e-300), name))
        out["worst_k"] = max(out["worst_k"], (ek, name))
        out["worst_p"] = max(out["worst_p"], ep)
    return out


def log_f64(held: dict, n: int, what: str, smi: str) -> None:
    log(f"   {what} held to the plain path in f64: kernel path at most "
        f"{held['worst_k'][0]:.4g} of the leaf's largest entry (at {held['worst_k'][1]}), "
        f"plain path at most {held['worst_p']:.4g}; the kernel path farther than the plain "
        f"path on {held['farther']} of {n} leaves, by at most x{held['ratio'][0]:.4f} (at "
        f"{held['ratio'][1]}); past both {TRAIN_F32['leaf']} and twice the plain path's "
        f"distance: {held['failed']} ({smi})")


def check_recurrent_train(arch: str, n_layers: int, batch: int, seq: int, seed: int,
                          smi: str) -> None:
    """The first train step of ``arch`` at full width and ``n_layers`` (one
    pattern group: deep random stacks are chaotic in f32, and at
    xlstm-125m's full depth both paths' f32 gradients part from the f64
    ones by more than half a leaf's largest entry) in f32 from one state
    and batch, the kernel path (every backward kernel) against the plain
    path: the loss within TRAIN_F32's, each gradient leaf within TRAIN_F32's
    of its largest entry; the leaves past it are held to the plain path in
    f64 (``held_to_f64``).  Each backward kernel on the inputs its layer
    handed it there, against its plain version (f32: RG-LRU RGLRU_TOL,
    mLSTM MLSTM_ATOL/RTOL and, against f64, ``mlstm_bwd_near_f64``;
    windowed flash BWD_F32_*); the windowed flash in
    bf16 on a bf16 step's inputs (BWD_BF16_REL); two bf16 kernel-path
    steps from one state, bit for bit."""
    cfg = get_config(arch).with_(num_layers=n_layers)
    t0 = time.perf_counter()
    params32 = init_params(cfg, seed=seed, device="cuda")
    src = StreamSource(vocab_size=cfg.vocab_size, batch=batch, seq_len=seq, seed=seed)
    tb = {k: v.to("cuda") for k, v in src.batch_at(7).items()}
    names = leaf_names(params32)
    seen = {"rglru_scan_bwd": [], "mlstm_chunk_bwd": [], "flash_attention_bwd": []}
    undo = [capture(rglru_mod, "rglru_scan_bwd", seen["rglru_scan_bwd"]),
            capture(mlstm_mod, "mlstm_chunk_bwd", seen["mlstm_chunk_bwd"]),
            capture(flash_mod, "flash_attention_bwd", seen["flash_attention_bwd"])]
    launched = mlstm_mod.mlstm_chunk.launches
    try:
        loss_k, grads_k = train_grads(params32, cfg, tb, ModelOptions(compute_dtype="float32"))
    finally:
        for fn in undo:
            fn()
    log(f"== checks: {arch} training at full width, {cfg.num_layers} layers, "
        f"{tuple(tb['tokens'].shape)} tokens")
    if seen["mlstm_chunk_bwd"]:
        log(f"   f32 kernel-path step (remat): mlstm_chunk launched "
            f"{mlstm_mod.mlstm_chunk.launches - launched} times, mlstm_chunk_bwd "
            f"{len(seen['mlstm_chunk_bwd'])}")
    for args, kw in seen["rglru_scan_bwd"]:
        got = kernels.rglru_scan_bwd(*args)
        want = kernels.ref.rglru_scan_bwd_ref(*args)
        err = max(abs_rel_err(g, w, RGLRU_TOL, RGLRU_TOL, f"{arch} layer rglru_scan_bwd")
                  for g, w in zip(got, want))
        log(f"   f32 layer, rglru_scan_bwd {tuple(args[0].shape)} on its own inputs vs "
            f"plain: max abs error {err:.3g} (tolerance {RGLRU_TOL} abs + rel)")
    for args, kw in seen["mlstm_chunk_bwd"]:
        got = kernels.mlstm_chunk_bwd(*args, **kw)
        q, k, v, log_i, log_f, _ws, _den, _h, dh = args
        want = kernels.ref.mlstm_chunk_bwd_ref(q, k, v, log_i, log_f, dh, **kw)
        err = mlstm_bwd_close(got, want, q.dtype, f"{arch} layer mlstm_chunk_bwd")
        near = mlstm_bwd_near_f64(args, got, want, kw, f"{arch} layer mlstm_chunk_bwd")
        log(f"   f32 layer, mlstm_chunk_bwd {tuple(q.shape)} on its own inputs vs plain: "
            f"max abs error {err:.3g} (tolerance {MLSTM_ATOL} + {MLSTM_RTOL} of the "
            "largest entry); off its equations in f64 from the same forward state, over "
            "the largest entry, kernel / plain f32: "
            + ", ".join(f"{n} {d[0]:.3g} / {d[1]:.3g}" for n, d in near.items())
            + f" (held: at most twice plain, or {MLSTM_BWD_F64_FLOOR:g}); end to end off "
            "mlstm_chunk_bwd_ref in f64, kernel path / plain autograd: "
            + ", ".join(f"{n} {d[2]:.3g} / {d[3]:.3g}" for n, d in near.items()))
        del got, want
    windowed = [(a, kw) for a, kw in seen["flash_attention_bwd"] if kw.get("window")]
    for args, kw in windowed:
        got = kernels.flash_attention_bwd(*args, **kw)
        want = kernels.ref.flash_attention_bwd_ref(*args, kw["causal"], kw["window"])
        err = max(abs_rel_err(g, w, BWD_F32_ATOL, BWD_F32_RTOL,
                              f"{arch} layer windowed flash_attention_bwd")
                  for g, w in zip(got, want))
        log(f"   f32 layer, windowed flash_attention_bwd {tuple(args[0].shape)} window "
            f"{kw['window']} on its own inputs vs plain: max abs error {err:.3g} "
            f"(tolerance {BWD_F32_ATOL} + {BWD_F32_RTOL} rel)")
        del got, want
    kinds = cfg.layer_kinds
    assert (len(seen["rglru_scan_bwd"]), len(seen["mlstm_chunk_bwd"]), len(windowed)) == (
        kinds.count("rglru"), kinds.count("mlstm"), kinds.count("local")), seen.keys()
    del seen, windowed

    loss_p, grads_p = train_grads(params32, cfg, tb,
                                  ModelOptions(compute_dtype="float32", attn_impl="plain"))
    g_rel, g_at = leaf_rel(grads_k, grads_p, names)
    l_rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"   first step, f32, kernels vs plain: loss {loss_k:.6f} vs {loss_p:.6f} (rel "
        f"{l_rel:.3g}, tolerance {TRAIN_F32['loss']}); gradients {g_rel:.3g} of the leaf's "
        f"largest entry (worst {g_at}; tolerance {TRAIN_F32['leaf']}) ({smi})")
    assert l_rel <= TRAIN_F32["loss"], l_rel
    past = [i for i, (gk, gp) in enumerate(zip(grads_k, grads_p))
            if ((gk - gp).abs().max() / gp.abs().max().clamp(min=1e-30)).item()
            > TRAIN_F32["leaf"]]
    grads_k, grads_p = [grads_k[i] for i in past], [grads_p[i] for i in past]

    # bf16: two kernel-path steps from one state, bit for bit; the first
    # one's windowed flash backwards on their own inputs
    opts = ModelOptions(compute_dtype="bfloat16")
    runs, seen16 = [], []
    for i in range(2):
        state = init_train_state(cfg, params=clone_params(params32))
        undo = capture(flash_mod, "flash_attention_bwd", seen16) if i == 0 else None
        try:
            state, m = make_train_step(cfg, TrainConfig(), opts)(state, tb)
        finally:
            if undo:
                undo()
        runs.append((m["loss"].item(), leaves(state["params"])))
        del state
    same = runs[0][0] == runs[1][0] and all(
        torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    log(f"   two bf16 train steps from one state: parameters "
        f"{'identical' if same else 'DIFFER'} bit for bit")
    assert same, f"{arch} train step is not deterministic"
    del runs
    for args, kw in seen16:
        if not kw.get("window"):
            continue
        got = kernels.flash_attention_bwd(*args, **kw)
        want = kernels.ref.flash_attention_bwd_ref(*args, kw["causal"], kw["window"])
        rel = max(rel_err(g.float(), w.float()) for g, w in zip(got, want))
        log(f"   bf16 layer, windowed flash_attention_bwd {tuple(args[0].shape)} on its own "
            f"inputs vs plain: max |diff| / max |plain| = {rel:.3g} (tolerance "
            f"{BWD_BF16_REL})")
        assert all(torch.isfinite(g).all() for g in got) and rel <= BWD_BF16_REL, rel
        del got, want
    del seen16

    if past:  # last: the f64 run needs the card's memory
        # the past leaves' f32 gradients wait on the host (the embedding
        # table's are 4.2 GB each at recurrentgemma-9b's width)
        grads_k, grads_p = [g.cpu() for g in grads_k], [g.cpu() for g in grads_p]
        params64 = map_params(lambda _k, p: p.detach().double(), params32)
        del params32
        torch.cuda.empty_cache()
        _, grads_64 = f64_grads(params64, cfg, tb)
        del params64
        grads_64 = [grads_64[i] for i in past]
        held = held_to_f64(grads_k, grads_p, grads_64, [names[i] for i in past])
        log_f64(held, len(past), f"{len(past)} leaves past {TRAIN_F32['leaf']},", smi)
        assert not held["failed"], held["failed"]
        del grads_64
    del grads_k, grads_p
    torch.cuda.empty_cache()
    log(f"   {arch} training checks: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------- the trainer PE


class StandInCollective:
    """A width-1 collective group: the fabric's ``allreduce_mean`` (the sum
    of the ranks' arrays in rank order, over the width) for one rank, the
    arrays handed back as every rank gets them (the trainer copies
    before it scales them)."""

    epoch = 0

    def allreduce_mean(self, key, value, epoch: int, timeout: float = 30.0, rank: int = 0):
        # the mean over one rank is the rank's own f32 arrays, bit for bit
        return [np.asarray(a, dtype=np.float32) for a in value]


class StandInRest:
    """The control plane's side as the trainer PE sees it: the consistent
    region commits a checkpoint as soon as it is notified (width 1) and
    sweeps the older steps; metrics are kept; ``stop_after`` sets the
    stop event once that step's metrics arrive."""

    def __init__(self, ckpt: CheckpointStore, stop_event, stop_after=None,
                 committed: int = -1):
        self.ckpt, self.stop_event, self.stop_after = ckpt, stop_event, stop_after
        self.committed, self.metrics, self.done = committed, [], False

    def get_cr_state(self, job, region):
        return {"lastCommitted": self.committed}

    def notify_checkpoint(self, job, region, pe_id, step):
        self.committed = step
        self.ckpt.sweep(job, region, step)

    def report_metrics(self, job, pe_id, metrics):
        self.metrics.append(metrics)
        if self.stop_after is not None and metrics.get("step") == self.stop_after:
            self.stop_event.set()

    def notify_source_done(self, job, pe_id):
        self.done = True


class StandInRuntime:
    """The PE runtime's surface that ``run_trainer`` uses, for one trainer
    channel of width 1 on the card."""

    def __init__(self, app: dict, interval: int, rest: StandInRest):
        self.job, self.pe_id, self._drain, self.emitted = "smoke", 0, None, []
        self.meta = {"operators": [{"name": "trainer", "kind": "trainer", "channel": 0,
                                    "config": app}],
                     "widths": {"dp": 1},
                     "consistentRegion": {"name": "dp", "interval": interval}}
        self.stop_event, self.rest = rest.stop_event, rest
        self.fabric = type("Fabric", (), {
            "collective": staticmethod(lambda job, region, width: StandInCollective())})()

    def _cr(self):
        return self.meta["consistentRegion"]

    def _emit(self, port, item, partition=None):
        self.emitted.append(item)

    def _flush_all(self):
        pass

    def load_metrics(self, extra=None):
        return dict(extra or {})


def checkpoint_digest(store: CheckpointStore, step: int) -> str:
    """The content digest the store wrote beside a committed shard (SHA-256
    over its arrays' keys, dtypes, shapes and bytes)."""
    d = store._dir("smoke", "dp", step)
    with open(os.path.join(d, "params.json")) as f:
        assert json.load(f) == {"step": step}
    with open(os.path.join(d, "params.npz.sha256")) as f:
        return f.read()


def trainer_pe_phase(seed: int, smi: str) -> dict:
    """The port's trainer PE (``repro_torch.platform.run_trainer``) on a
    stand-in runtime: full-width gemma-2b at 2 layers, f32, 8 steps of 2 x
    512 tokens, checkpoints every 4 steps through the port's
    ``CheckpointStore``.  An uninterrupted run, then a run stopped after
    step 6 and restarted from the committed step 4: both must end at the
    same checkpoint bytes (the uninterrupted run checkpoints only at step
    8).  Returns the launches of the uninterrupted run."""
    import shutil
    import tempfile
    import threading

    cfg = get_config("gemma-2b").with_(num_layers=2)
    app = {"arch": cfg, "steps": 8, "batch_per_shard": 2, "seq_len": 512, "lr": 1e-3,
           "param_seed": seed + 7, "data_seed": seed, "device": "cuda"}
    root = tempfile.mkdtemp(prefix="smoke-ckpt-")
    t0 = time.perf_counter()
    try:
        def run(name, stop_after=None, store=None, committed=-1, interval=4):
            store = store or CheckpointStore(os.path.join(root, name))
            rest = StandInRest(store, threading.Event(), stop_after, committed)
            rt = StandInRuntime(app, interval, rest)
            t = time.perf_counter()
            run_trainer(rt)
            torch.cuda.synchronize()
            return store, rt, time.perf_counter() - t

        # the uninterrupted run checkpoints only its end (the interval
        # moves no parameter bit; a 9 GB checkpoint takes ~25 s)
        kernels.reset_launch_counts()
        whole, rt, wall = run("whole", interval=8)
        got = counts()
        steps = [m["step"] for m in rt.rest.metrics]
        step_s = [m["stepTime"] for m in rt.rest.metrics]
        losses = ", ".join(f"{x['loss']:.4f}" for x in rt.emitted)
        assert steps == list(range(1, 9)) and rt.rest.done and rt.rest.committed == 8, steps
        assert all(math.isfinite(x["loss"]) for x in rt.emitted), rt.emitted
        log(f"== trainer PE: repro_torch.platform.run_trainer on a stand-in runtime, "
            f"gemma-2b full width at 2 layers ({cfg.param_count() / 1e9:.3f} B params), f32, "
            f"8 steps of 2 x 512 tokens, checkpoints every 4 steps (the uninterrupted "
            f"run's at step 8 only) ({smi})\n"
            f"   uninterrupted: {wall:.1f} s, step time {min(step_s):.3f}-{max(step_s):.3f} s "
            f"(checkpoint steps included); losses {losses}; launches {got}")
        assert got["flash_attention"] == 8 * 2 and got["flash_attention_bwd"] == 8 * 2, got
        want = checkpoint_digest(whole, 8)
        shutil.rmtree(os.path.join(root, "whole"), ignore_errors=True)

        kernels.reset_launch_counts()
        store, rt, wall1 = run("stopped", stop_after=6)
        steps = [m["step"] for m in rt.rest.metrics]
        assert steps == list(range(1, 7)) and not rt.rest.done and rt.rest.committed == 4
        _, rt2, wall2 = run("resumed", store=store, committed=rt.rest.committed)
        steps2 = [m["step"] for m in rt2.rest.metrics]
        assert steps2 == [5, 6, 7, 8] and rt2.rest.done and rt2.rest.committed == 8, steps2
        got_digest = checkpoint_digest(store, 8)
        got2 = counts()  # the stopped and the resumed run: 6 + 4 steps of 2 layers
        assert got2["flash_attention"] == 10 * 2 and got2["flash_attention_bwd"] == 10 * 2, got2
        log(f"   stopped after step 6 ({wall1:.1f} s), restarted from the committed step 4 "
            f"({wall2:.1f} s, steps {steps2}; launches of both {got2}): step 8's checkpoint "
            f"{'equals' if got_digest == want else 'DIFFERS from'} the uninterrupted run's "
            f"bit for bit (sha256 {want[:16]})")
        assert got_digest == want, (got_digest, want)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"   trainer PE phase: {time.perf_counter() - t0:.1f} s")
    return got


# ------------------------------------------------------------- the mesh step


def snapshot(state) -> dict:
    """Copies of a train state's tensors (params, moments, EF buffers)."""
    return {k: [t.detach().clone() for t in leaves(state[k])]
            for k in ("params", "opt", "ef") if k in state}


def same_bits(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        len(a[k]) == len(b[k]) and all(torch.equal(x, y) for x, y in zip(a[k], b[k]))
        for k in a)


def run_steps(step, state, batches) -> tuple:
    """Each step's (loss, grad norm) and launch counts, and the final state."""
    out = []
    for b in batches:
        kernels.reset_launch_counts()
        state, m = step(state, b)
        out.append(((m["loss"].item(), m["grad_norm"].item()), counts()))
    return out, state


def plain_compressed_step(cfg, tcfg, opts):
    """The one-device gradients through the plain ``ef_quantize_mean`` (one
    pod), clipping and AdamW: what the compressed mesh step must equal."""
    ocfg = tcfg.optimizer

    def step(state, batch):
        params = state["params"]
        for p in leaves(params):
            p.grad = None
        loss, _ = loss_fn(params, cfg, batch, opts, remat=tcfg.remat)
        loss.backward()
        grads = map_params(lambda _k, p: p.grad[None], params)
        mean, state["ef"] = ef_quantize_mean(grads, state["ef"])
        mean, gnorm = clip_by_global_norm(mean, ocfg.clip_norm)
        adamw_update(ocfg, params, mean, state["opt"], state["step"])
        for p in leaves(params):
            p.grad = None
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def mesh_phase(seed: int, smi: str, phase7: dict) -> dict:
    """The mesh train step at world size 1 over NCCL, bit for bit against
    the one-device step and the plain compressed composition; full-depth
    gemma-2b through the launcher's ``--mesh 1,1,1`` beside phase 7; the
    compressed combine's cost.  Returns the launches of the launcher run."""
    t0 = time.perf_counter()
    # phase 7 ran without deterministic algorithms (the trainer PE turned
    # them on): compare like with like
    torch.use_deterministic_algorithms(False)
    cfg = get_config("gemma-2b")
    cfg2 = cfg.with_(num_layers=2)
    opts = ModelOptions(compute_dtype="bfloat16")
    params32 = init_params(cfg2, seed=seed, device="cuda")
    src = StreamSource(vocab_size=cfg.vocab_size, batch=2, seq_len=1024, seed=seed)
    batches = [{k: v.to("cuda") for k, v in src.batch_at(i).items()} for i in range(2)]
    mesh = make_mesh((1, 1, 1), device="cuda")
    try:
        log(f"== mesh: world size 1 over {torch.distributed.get_backend()}, mesh "
            f"{mesh.shape}; gemma-2b full width at 2 layers "
            f"({cfg2.param_count() / 1e9:.3f} B params), f32 parameters, bf16 compute, "
            f"remat, 2 steps of 2 x 1024 ({smi})")
        for compress in (False, True):
            tcfg = TrainConfig(compress_pod_grads=compress)
            state = init_train_state(cfg2, tcfg, params=clone_params(params32))
            one = (plain_compressed_step(cfg2, tcfg, opts) if compress
                   else make_train_step(cfg2, tcfg, opts))
            want, state = run_steps(one, state, batches)
            want_bits = snapshot(state)
            del state
            state = init_train_state(cfg2, tcfg, params=clone_params(params32), mesh=mesh)
            step = make_train_step(cfg2, tcfg, opts, mesh=mesh, act_rules=activation_rules())
            got, state = run_steps(step, state, batches)
            got_bits = snapshot(state)
            del state
            same = [g[0] for g in got] == [w[0] for w in want] and same_bits(got_bits,
                                                                             want_bits)
            what = ("compressed (num_pods 1) vs the plain ef_quantize_mean, clipping and "
                    "AdamW" if compress else "mesh step vs the one-device step")
            log(f"   {what}: (loss, grad norm) {[g[0] for g in got]}; parameters, "
                f"moments{' and EF buffers' if compress else ''} "
                f"{'identical' if same else 'DIFFER'} bit for bit; launches per step "
                f"{[g[1] for g in got]} (one-device {[w[1] for w in want]})")
            assert same, (what, got, want)
            for (_, g), (_, w) in zip(got, want):
                for name in ("rmsnorm", "flash_attention", "flash_attention_bwd"):
                    assert g[name] == w[name] > 0, (name, g, w)
            del got_bits, want_bits
        torch.cuda.synchronize()

        # the compressed combine's cost: EF state and int8 payload of the
        # 2-layer model, and its time at world size 1 (no wire), on random
        # gradients and zero buffers
        n = sum(p.numel() for p in leaves(params32))
        gen = torch.Generator(device="cuda").manual_seed(seed)
        grads = map_params(lambda _k, p: torch.randn(p.shape, generator=gen, device="cuda"),
                           params32)
        ef = map_params(lambda _k, p: torch.zeros_like(p), params32)
        compressed_mean_over_axis(grads, ef, None)  # warm
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            compressed_mean_over_axis(grads, ef, None)
        end.record()
        torch.cuda.synchronize()
        combine_ms = start.elapsed_time(end) / 5
        moved = 17 * n  # read g and e, write the mean and the new e (f32), the int8 payload
        log(f"   compressed combine over {n / 1e9:.3f} B parameters: EF state "
            f"{4 * n / 1e9:.3f} GB, int8 payload {n / 1e9:.3f} GB "
            f"(+ {4 * len(leaves(params32))} B of scales) a pod; {combine_ms:.3f} ms a "
            f"combine at world size 1 (mean of 5), bound {moved / HBM_BYTES_PER_S * 1e3:.3f} "
            f"ms ({moved / 1e9:.2f} GB at 3.35 TB/s) ({smi})")
        del grads, ef, params32
    finally:
        mesh.close()
    torch.cuda.empty_cache()

    # full depth through the launcher, as phase 7, on a mesh of one rank
    steps, warmup = 8, 2
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    records = train_launcher.main(["--arch", "gemma-2b", "--steps", str(steps),
                                   "--batch", "2", "--seq", "1024", "--mesh", "1,1,1"])
    launches = counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    assert not torch.distributed.is_initialized(), "the launcher left its world running"
    assert len(records) == steps and all(
        math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in records)
    timed = [r["wall_s"] for r in records[warmup:]]
    wall = sum(timed) / len(timed)
    log(f"   launcher --mesh 1,1,1, full depth: step wall {wall * 1e3:.3f} ms (mean of "
        f"{len(timed)}; phase 7: {phase7['wall'] * 1e3:.3f}), {2 * 1024 / wall:.1f} "
        f"training tokens/s (phase 7: {2 * 1024 / phase7['wall']:.1f}), peak memory "
        f"{peak_gib:.2f} GiB (phase 7: {phase7['peak_gib']:.2f}) ({smi})")
    log("   per step (loss, grad norm, wall s): " + "; ".join(
        f"{r['loss']:.4f} {r['grad_norm']:.4f} {r['wall_s']:.3f}" for r in records))
    log(f"   launches {launches} (phase 7: {phase7['launches']})")
    same = [(r["loss"], r["grad_norm"]) for r in records] == phase7["records"]
    log(f"   its losses and grad norms {'equal' if same else 'differ from'} phase 7's "
        "(not held: full depth)")
    for name in ("rmsnorm", "flash_attention", "flash_attention_bwd"):
        assert launches[name] == phase7["launches"][name], (name, launches)
    assert abs(peak_gib - phase7["peak_gib"]) <= MESH_PEAK_RTOL * phase7["peak_gib"], \
        (peak_gib, phase7["peak_gib"])
    log(f"   mesh phase: {time.perf_counter() - t0:.1f} s")
    return launches


def tp_setup(job: str, seed: int) -> tuple:
    """A tensor-parallel job's model, options, step config and batches (on
    the card): the same in the parent and in each rank."""
    batch, seq, layers = TP_JOBS[job]
    cfg2 = get_config(job_arch(job)[0]).with_(num_layers=layers)
    opts = ModelOptions(compute_dtype="float32")
    tcfg = TrainConfig(optimizer=TRAIN_CHECK_OPT)
    src = StreamSource(vocab_size=cfg2.vocab_size, batch=batch, seq_len=seq, seed=seed)
    batches = [{k: v.to("cuda") for k, v in src.batch_at(i).items()} for i in range(2)]
    return cfg2, opts, tcfg, batches


def tp_worker(rank: int, port: int, out: str, seed: int, jobs: tuple) -> None:
    """One rank of the tensor-parallel sub-phase (``--tp-rank``): each of
    ``jobs`` (train jobs of ``TP_JOBS``, then serving jobs of
    ``TP_SERVE_JOBS``, as "serve:" + name) in turn on one mesh
    (``tp_job``, ``tp_serve_job``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(TP_MESH, device="cuda", backend="gloo",
                     init_method=f"tcp://127.0.0.1:{port}", rank=rank)
    try:
        for job in jobs:
            if job.startswith("serve:"):
                tp_serve_job(job[len("serve:"):], mesh, rank, out, seed)
            else:
                tp_job(job, mesh, rank, out, seed)
    finally:
        mesh.close()


def tp_job(job: str, mesh, rank: int, out: str, seed: int) -> None:
    """One job on one rank: its two steps' metrics and launches, its block of
    the first step's mean gradient and of the parameters after both steps
    (on the host), the first step's routes of an MoE (``routing_log``, in
    call order: forward, then remat's recompute), and a third step counted
    in kernel mode (``launch.op_analysis``)."""
    cfg2, opts, tcfg, batches = tp_setup(job, seed)
    params = init_params(cfg2, seed=seed, device="cuda")
    state = init_train_state(cfg2, tcfg, params=params, mesh=mesh)
    del params
    step = make_train_step(cfg2, tcfg, opts, mesh=mesh,
                           act_rules=activation_rules(**job_arch(job)[1]))
    seen = {}
    real_clip = step_mod.clip_by_global_norm

    def clip(grads, c, **kw):  # the mean gradient, before clipping
        seen.setdefault("grads", [g.detach().cpu() for g in leaves(grads)])
        return real_clip(grads, c, **kw)

    step_mod.clip_by_global_norm = clip
    torch.cuda.reset_peak_memory_stats()
    records = []
    for i, b in enumerate(batches):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with routing_log() if i == 0 else contextlib.nullcontext([]) as routes:
            state, m = step(state, b)
        torch.cuda.synchronize()
        records.append({"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                        "wall_s": time.perf_counter() - t0, "launches": counts()})
        if i == 0:
            seen["routes"] = [r.cpu() for r in routes]
    step_mod.clip_by_global_norm = real_clip
    peak = torch.cuda.max_memory_allocated()
    res = {"records": records, "peak_bytes": peak, "grads": seen["grads"],
           "routes": seen["routes"],
           "params": [p.detach().cpu() for p in leaves(state["params"])]}
    _, totals = count_ops(step, state, batches[0])
    res["count"] = {k: getattr(totals, k) for k in ("flops", "bytes", "by_kernel",
                                                     "coll_by_key")}
    torch.save(res, os.path.join(out, f"{job}.rank{rank}.pt"))
    del state, step, res, seen
    torch.cuda.empty_cache()


def tp_serve_setup(job: str, seed: int) -> tuple:
    """A serving job's model, options, prompt (on the card), decode steps
    and max_len: the same in the parent and in each rank."""
    prompt, steps, layers = TP_SERVE_JOBS[job]
    cfg2 = get_config(job_arch(job)[0]).with_(num_layers=layers)
    rng = np.random.default_rng(seed + 17)
    tokens = torch.from_numpy(rng.integers(0, cfg2.vocab_size, (1, prompt))).to("cuda")
    return cfg2, ModelOptions(compute_dtype="float32"), tokens, steps, prompt + steps


def serve_greedy(prefill, step, params, tokens, steps: int, whole=lambda x: x,
                 feed=None) -> tuple:
    """A prefill of ``tokens``, then ``steps`` greedy decode steps (or steps
    fed ``feed``'s tokens): each step's logits (the prefill's last row
    first; ``whole`` gathers a rank's vocab block) on the host, the tokens
    fed, and the cache."""
    logits, cache = prefill(params, {"tokens": tokens})
    out = [whole(logits[:, -1]).cpu()]
    del logits
    fed = []
    for t in range(steps):
        nxt = (out[-1].argmax(-1) if feed is None else feed[t]).to("cuda", torch.int32)
        fed.append(nxt.cpu())
        lg, cache = step(params, cache, nxt)
        out.append(whole(lg).cpu())
    return torch.stack(out), torch.stack(fed), cache


def tp_serve_job(job: str, mesh, rank: int, out: str, seed: int) -> None:
    """One serving job on one rank: the sharded prefill and greedy decode
    steps on this rank's shards (``local_params``), the logits gathered
    over the vocabulary, the launches of the run, the cache's shapes, and
    a prefill and a decode step counted in kernel mode (phase 18)."""
    cfg2, opts, tokens, steps, max_len = tp_serve_setup(job, seed)
    params = init_params(cfg2, seed=seed, device="cuda")
    local = local_params(params, mesh)
    del params
    rules = activation_rules(data_axes=data_axes_for(mesh, tokens.shape[0]), **job_arch(job)[1])
    prefill = make_prefill_step(cfg2, opts, max_len=max_len, mesh=mesh, act_rules=rules)
    step = make_decode_step(cfg2, opts, mesh=mesh, act_rules=rules)
    group, n = mesh.group(("model",)), mesh.shape["model"]

    def whole(lg):
        return torch.cat(gather_stack(lg, group, n).unbind(0), -1)

    with torch.no_grad():
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, fed, cache = serve_greedy(prefill, step, local, tokens, steps, whole)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        shapes = cache_leaf_shapes(cache)
        _, pre = count_ops(prefill, local, {"tokens": tokens})
        _, dec = count_ops(step, local, cache, fed[-1].to("cuda"))
    res = {"logits": logits, "tokens": fed, "launches": launches, "wall_s": wall,
           "cache_shapes": shapes, "peak_bytes": torch.cuda.max_memory_allocated(),
           "count": {name: {k: getattr(t, k) for k in ("flops", "bytes", "by_kernel",
                                                       "coll_by_key")}
                     for name, t in (("prefill", pre), ("decode", dec))}}
    torch.save(res, os.path.join(out, f"serve-{job}.rank{rank}.pt"))
    del local, cache, res
    torch.cuda.empty_cache()


def cache_leaf_shapes(cache) -> dict:
    """Each leaf's shape of a decode cache, by segment, layer and name."""
    return {f"{seg}/{i}/{k}": tuple(x.shape) for seg in ("prefix", "main", "tail")
            for i, e in enumerate(cache[seg]) for k, x in e.items()}


def placed_cache_shapes(cfg2, B: int, max_len: int, options: dict) -> dict:
    """A rank's cache leaves' shapes on the abstract (1, 1, 2) mesh, as the
    reference's ``cache_specs`` places the whole cache (``local_cache``)
    under the job's ``options``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh = abstract_mesh(TP_MESH)
    axes = data_axes_for(mesh, B)
    with FakeTensorMode():
        whole = init_cache(cfg2, B, max_len, torch.float32, "cpu")
        local = local_cache(whole, cache_specs(whole, cfg2, mesh, axes, activation_rules(
            data_axes=axes, **options)), mesh)
        return cache_leaf_shapes(local)


def attention_split(cfg2, max_len: int, options: dict) -> tuple:
    """(attention layers, where their caches split over the model axis in
    words, merges a decode step): global attention over ``max_len``
    positions, a local layer over its ring."""
    cache_seq = options.get("shard_cache_seq", False)
    splits = [kv_split(cfg2, min(cfg2.window, max_len) if k == "local" else max_len,
                       TP_MESH[2], cache_seq) for k in cfg2.layer_kinds if k in ("attn", "local")]
    return len(splits), ", ".join(sorted(set(splits))) or "none", splits.count("sequence")


def tp_serve_check(job: str, seed: int, smi: str, out: str) -> dict:
    """A serving job against the one-device f32 steps: every rank's logits
    (the same bits on both) within SERVE_TP_RTOL of the largest logit of
    the one-device run, or else both runs held to the plain path in f64 fed
    the same tokens; the same greedy tokens; the rank's cache placed as
    ``cache_specs`` places the whole; every kernel launched as often as on
    one device (a decode kernel per attention layer and step, the flash
    kernel per attention layer and the recurrent kernels per layer in the
    prefill), and one merge per attention layer and step whose cache
    splits over the sequence."""
    t0 = time.perf_counter()
    cfg2, opts, tokens, steps, max_len = tp_serve_setup(job, seed)
    options = job_arch(job)[1]
    ranks = []
    for r in range(2):
        path = os.path.join(out, f"serve-{job}.rank{r}.pt")
        ranks.append(torch.load(path, weights_only=False))
        os.remove(path)
    got = ranks[0]
    assert torch.equal(ranks[1]["logits"], got["logits"]), f"{job}: the ranks' logits differ"
    params32 = init_params(cfg2, seed=seed, device="cuda")
    with torch.no_grad():
        kernels.reset_launch_counts()
        want, fed, _ = serve_greedy(make_prefill_step(cfg2, opts, max_len=max_len),
                                    make_decode_step(cfg2, opts), params32, tokens, steps)
        one_launches = counts()
    scale = want.abs().max().item()
    rel = ((got["logits"] - want).abs().max() / scale).item()
    same = torch.equal(got["tokens"], fed)
    n_attn, split, merges_a_step = attention_split(cfg2, max_len, options)
    placed = placed_cache_shapes(cfg2, tokens.shape[0], max_len, options)
    log(f"   {job} serving (prefill of {tuple(tokens.shape)}, {steps} greedy decode steps, "
        f"max_len {max_len}; attention caches over {split}; a rank's cache leaves "
        f"{sorted(set(got['cache_shapes'].values()))}): logits rel {rel:.3g} of the largest "
        f"(tolerance {SERVE_TP_RTOL}), greedy tokens {'equal' if same else 'DIFFER'}; rank-0 wall "
        f"{got['wall_s']:.3f} s (host clock, gloo on one shared card); peak memory a rank "
        f"{ranks[0]['peak_bytes'] / 2**30:.2f} / {ranks[1]['peak_bytes'] / 2**30:.2f} GiB "
        f"({smi})")
    assert same, (got["tokens"].tolist(), fed.tolist())
    assert torch.isfinite(got["logits"]).all()
    if rel > SERVE_TP_RTOL:  # both held to the plain path in f64, fed the same tokens
        params64 = map_params(lambda _k, p: p.double(), params32)
        o64 = ModelOptions(compute_dtype="float64", attn_impl="plain")
        with f64_plain(), torch.no_grad():
            want64, _, _ = serve_greedy(make_prefill_step(cfg2, o64, max_len=max_len),
                                        make_decode_step(cfg2, o64), params64, tokens, steps,
                                        feed=fed)
        s64 = want64.abs().max()
        e_tp = ((got["logits"].double() - want64).abs().max() / s64).item()
        e_one = ((want.double() - want64).abs().max() / s64).item()
        log(f"   {job} serving held to the plain path in f64: tensor-parallel {e_tp:.4g} "
            f"of the largest logit, one device {e_one:.4g} (held: within "
            f"{SERVE_TP_RTOL} or twice the one-device distance) ({smi})")
        assert e_tp <= max(SERVE_TP_RTOL, 2 * e_one), (e_tp, e_one)
        del params64, want64
    merges = merges_a_step * steps
    used = {"rmsnorm"} | ({"decode_attention", "flash_attention"} if n_attn else set()) | {
        name for kind, name in (("rglru", "rglru_scan"), ("mlstm", "mlstm_chunk"))
        if kind in cfg2.layer_kinds}
    for r in ranks:
        lr = r["launches"]
        assert r["cache_shapes"] == placed, (r["cache_shapes"], placed)
        assert lr["decode_attention"] == n_attn * steps, lr
        assert lr["merge_partials"] == merges, (lr, merges)
        assert lr["flash_attention"] == n_attn, lr
        assert {k: v for k, v in lr.items() if k != "merge_partials"} == {
            k: v for k, v in one_launches.items() if k != "merge_partials"}, (lr, one_launches)
        assert all(lr[name] > 0 for name in used), (lr, used)
    log(f"   launches a rank {got['launches']} (one device {one_launches}); "
        f"{job} serving checked in {time.perf_counter() - t0:.1f} s")
    del params32
    torch.cuda.empty_cache()
    return {"count": got["count"], "cfg": cfg2, "opts": opts, "tokens": tuple(tokens.shape),
            "max_len": max_len, "launches": got["launches"], "job": job, "options": options}


def kv_split(cfg, positions: int, n: int, cache_seq: bool = False) -> str:
    """Where the reference's placement splits an attention cache of
    ``positions`` over n ranks, in words (the sequence first with
    ``cache_seq``)."""
    return {"kv": "KV heads", "seq": "sequence", "whole": "whole"}[
        kv_cache_split(positions, cfg.num_kv_heads, n, cache_seq)]


def tp_serve_fake_count(job: dict) -> dict:
    """Rank 0's kernel-mode count of a serving job's prefill and decode
    step on fake tensors of an abstract (1, 1, 2) mesh: rank 0's parameter
    shards and its block of the cache (``cache_specs``, ``local_cache``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg2, opts, max_len = job["cfg"], job["opts"], job["max_len"]
    mesh = abstract_mesh(TP_MESH)
    B = job["tokens"][0]
    rules = activation_rules(data_axes=data_axes_for(mesh, B), **job["options"])
    fake = FakeTensorMode()
    with fake:
        params = local_params(init_params(cfg2, device="cpu"), mesh)
        tokens = torch.empty(job["tokens"], dtype=torch.int64)
        whole = init_cache(cfg2, B, max_len, torch.float32, "cpu")
        cache = local_cache(whole, cache_specs(whole, cfg2, mesh, data_axes_for(mesh, B),
                                               rules), mesh)
        del whole
        nxt = torch.empty((B,), dtype=torch.int32)
        prefill = make_prefill_step(cfg2, opts, max_len=max_len, mesh=mesh, act_rules=rules)
        step = make_decode_step(cfg2, opts, mesh=mesh, act_rules=rules)
        with torch.no_grad():
            _, pre = count_ops(prefill, params, {"tokens": tokens}, shapes_only=True)
            _, dec = count_ops(step, params, cache, nxt, shapes_only=True)
    return {name: {k: getattr(t, k) for k in ("flops", "bytes", "by_kernel", "coll_by_key")}
            for name, t in (("prefill", pre), ("decode", dec))}


def tp_whole(blocks: list, spec: tuple, name: str) -> torch.Tensor:
    """A leaf whole from the ranks' blocks (``spec`` splits at most one dim
    over ``model``); a leaf the ranks hold whole must be equal on every
    rank, bit for bit."""
    dims = [d for d, part in enumerate(spec) if part == "model"]
    if not dims:
        assert all(torch.equal(b, blocks[0]) for b in blocks), f"{name} differs across ranks"
        return blocks[0]
    return torch.cat(blocks, dims[0])


def tp_phase(seed: int, smi: str, train_jobs=tuple(TP_JOBS),
             serve_jobs=tuple(TP_SERVE_JOBS)) -> dict:
    """Phase 17's tensor-parallel sub-phase: a (1, 1, 2) mesh of two
    processes on this card over gloo (NCCL refuses two ranks on one GPU),
    running ``train_jobs`` of ``TP_JOBS`` and ``serve_jobs`` of
    ``TP_SERVE_JOBS`` (all by default); each job is then held to the
    one-device f32 steps (``tp_check``, ``tp_serve_check``).  Returns each
    job's rank-0 counts and config, for phase 18."""
    t0 = time.perf_counter()
    log(f"== tensor-parallel: mesh {TP_MESH} (pod, data, model) of two processes on this "
        f"card over gloo; " + ", ".join(f"{a} ({TP_JOBS[a][0]} x {TP_JOBS[a][1]}, "
                                        f"{TP_JOBS[a][2]} layers)" for a in train_jobs)
        + f" at full width, f32, {TRAIN_CHECK_OPT}, two steps each, against the one-device "
        f"f32 step ({smi})")
    # the ranks share the card with this process: hand back what its
    # allocator keeps cached from earlier phases (the launcher run's 46 GiB)
    torch.cuda.empty_cache()
    log(f"   this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"({torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved) as the ranks start")
    out = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    port = free_port()
    me = os.path.abspath(__file__)
    jobs = ",".join([*train_jobs, *(f"serve:{j}" for j in serve_jobs)])
    procs = [subprocess.Popen([sys.executable, me, "--seed", str(seed), "--tp-rank", str(r),
                               "--tp-port", str(port), "--tp-dir", out, "--tp-jobs", jobs])
             for r in range(2)]
    try:
        rcs = [p.wait(timeout=TP_WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert rcs == [0, 0], f"tensor-parallel ranks exited with {rcs}"
    log(f"   the ranks' jobs: {time.perf_counter() - t0:.1f} s")
    jobs = {"train": [tp_check(job, seed, smi, out) for job in train_jobs],
            "serve": [tp_serve_check(job, seed, smi, out) for job in serve_jobs]}
    os.rmdir(out)
    log(f"   tensor-parallel sub-phase: {time.perf_counter() - t0:.1f} s")
    return jobs


def tp_check(job: str, seed: int, smi: str, out: str) -> dict:
    """A tensor-parallel job against the one-device f32 step: the first
    step's loss and gradients (an MoE's one-device run routed as rank 0
    routed; both ranks must have routed alike), the leaves held whole equal
    on both ranks, equal launch counts (every kernel the arch's layers use
    launched), and the flash and recurrent kernels' counted work that of
    the local heads and channels."""
    t0 = time.perf_counter()
    cfg2, opts, tcfg, batches = tp_setup(job, seed)
    ranks = []
    for r in range(2):
        path = os.path.join(out, f"{job}.rank{r}.pt")
        ranks.append(torch.load(path, weights_only=False))
        os.remove(path)
    params32 = init_params(cfg2, seed=seed, device="cuda")
    names = leaf_names(params32)
    routes = [r.to("cuda") for r in ranks[0]["routes"]] or None
    assert len(ranks[1]["routes"]) == len(ranks[0]["routes"]) and all(
        torch.equal(a, b) for a, b in zip(*(r["routes"] for r in ranks))), \
        "the ranks routed differently"
    # the one-device reference: the first step's loss and gradients (routed
    # as rank 0 routed), and both steps' metrics and launches
    with routing_log(routes) if routes else contextlib.nullcontext([]) as flips:
        loss1, grads1 = train_grads(params32, cfg2, batches[0], opts)
    if routes:
        log(f"   {job}: the one-device step routed as rank 0 routed (both ranks alike): "
            f"its own expert sets differed at {sum(flips)} of "
            f"{sum(r.shape[0] * r.shape[1] for r in routes)} routed positions over "
            f"{len(routes)} routings (forward and remat)")
    state = init_train_state(cfg2, tcfg, params=clone_params(params32))
    one = make_train_step(cfg2, tcfg, opts)
    want = []
    for b in batches:
        kernels.reset_launch_counts()
        state, m = one(state, b)
        want.append({"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                     "launches": counts()})
    params2 = [p.detach() for p in leaves(state["params"])]
    del state, one
    torch.cuda.empty_cache()
    specs = train_state_specs(abstract_train_state(cfg2, tcfg), dict(zip(
        ("pod", "data", "model"), TP_MESH)))["params"]
    spec_list = []  # one spec per leaf, in leaves order
    zip_params(lambda _p, s: spec_list.append(s), params32, specs)
    tp_grads = [tp_whole([r["grads"][i] for r in ranks], s, n).to("cuda")
                for i, (s, n) in enumerate(zip(spec_list, names))]
    tp_params = [tp_whole([r["params"][i] for r in ranks], s, n).to("cuda")
                 for i, (s, n) in enumerate(zip(spec_list, names))]
    got = ranks[0]["records"]
    g_rel, g_at = leaf_rel(tp_grads, grads1, names)
    l_rel = abs(got[0]["loss"] - loss1) / abs(loss1)
    rels = [(abs(g["loss"] - w["loss"]) / abs(w["loss"]),
             abs(g["grad_norm"] - w["grad_norm"]) / abs(w["grad_norm"]))
            for g, w in zip(got, want)]
    p0 = leaves(params32)
    c_rel, c_at = leaf_rel([p - q for p, q in zip(tp_params, p0)],
                           [p - q for p, q in zip(params2, p0)], names)
    log(f"   {job}: per step (loss, grad norm, wall s), rank 0: " + "; ".join(
        f"{r['loss']:.6f} {r['grad_norm']:.6f} {r['wall_s']:.3f}" for r in got)
        + "; one device: " + "; ".join(f"{w['loss']:.6f} {w['grad_norm']:.6f}" for w in want))
    log(f"   first step: loss rel {l_rel:.3g} (tolerance {TRAIN_F32['loss']}), gradients "
        f"{g_rel:.3g} of the leaf's largest entry (worst {g_at}; tolerance "
        f"{TRAIN_F32['leaf']}); not held: (loss, grad norm) rel {rels} by step, each leaf's "
        f"change after both steps {c_rel:.3g} of the largest (worst {c_at}); peak memory a "
        f"rank {ranks[0]['peak_bytes'] / 2**30:.2f} / {ranks[1]['peak_bytes'] / 2**30:.2f} "
        f"GiB; the gloo collectives on CUDA tensors, none staged by the port ({smi})")
    if g_rel > TRAIN_F32["leaf"]:
        # the init's chaos: hold both runs to the plain path in f64
        _, grads64 = f64_grads(params32, cfg2, batches[0], routes)
        held = held_to_f64(tp_grads, grads1, grads64, names)
        log_f64(held, len(names), f"{job}: tensor-parallel first-step gradients (the "
                "one-device step's as the plain path)", smi)
        assert not held["failed"], held["failed"]
        del grads64
    assert l_rel <= TRAIN_F32["loss"], l_rel
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in got), got
    kinds = set(cfg2.layer_kinds)
    used = {"rmsnorm"} | {name for kind, pair in (
        ("attn", ("flash_attention", "flash_attention_bwd")),
        ("local", ("flash_attention", "flash_attention_bwd")),
        ("rglru", ("rglru_scan", "rglru_scan_bwd")),
        ("mlstm", ("mlstm_chunk", "mlstm_chunk_bwd"))) if kind in kinds for name in pair}
    for r in ranks:
        for g, w in zip(r["records"], want):
            assert g["launches"] == w["launches"], (g, w)
            assert all(g["launches"][name] > 0 for name in used), (used, g)
    # the flash and recurrent kernels ran at the local heads and channels:
    # their counted work is that of the local query heads and the KV heads
    # they read, of the rank's RG-LRU channels and of its mLSTM heads
    card = ranks[0]["count"]
    B, S = batches[0]["tokens"].shape
    n = TP_MESH[2]
    local = cfg2.num_heads // n
    kv = max(1, cfg2.num_kv_heads * local // cfg2.num_heads)
    costs = {"flash_attention": flash_attention_cost(
        B, S, local, kv, cfg2.head_dim, torch.float32, lse=True,
        window=cfg2.window if "local" in kinds else 0),
        "flash_attention_bwd": flash_attention_bwd_cost(
            B, S, local, kv, cfg2.head_dim, torch.float32,
            window=cfg2.window if "local" in kinds else 0),
        "rglru_scan": rglru_scan_cost(B * S * (cfg2.d_rnn or cfg2.d_model) // n),
        "rglru_scan_bwd": rglru_scan_bwd_cost(B * S * (cfg2.d_rnn or cfg2.d_model) // n),
        "mlstm_chunk": mlstm_chunk_cost(B, S, local, 2 * cfg2.d_model // cfg2.num_heads,
                                        torch.float32, chunk=opts.mlstm_chunk),
        "mlstm_chunk_bwd": mlstm_chunk_bwd_cost(B, S, local, 2 * cfg2.d_model // cfg2.num_heads,
                                                torch.float32, chunk=opts.mlstm_chunk)}
    for name in used - {"rmsnorm"}:
        k = card["by_kernel"][name]
        assert k["flops"] == k["calls"] * costs[name].flops, (name, k, costs[name])
    log(f"   launches a step {got[0]['launches']} (one device {want[0]['launches']}); the "
        f"counted work of {', '.join(sorted(used - {'rmsnorm'}))} that of {local} local query "
        f"head(s) and {kv} KV head(s), {(cfg2.d_rnn or cfg2.d_model) // n} RG-LRU channels; "
        f"{job} checked in {time.perf_counter() - t0:.1f} s")
    del tp_grads, tp_params, grads1, params2, params32, ranks
    torch.cuda.empty_cache()
    return {"count": card, "cfg": cfg2, "opts": opts, "tcfg": tcfg,
            "batch": tuple(batches[0]["tokens"].shape), "launches": got[0]["launches"],
            "job": job, "options": job_arch(job)[1]}


def tp_fake_count(tp: dict) -> dict:
    """Rank 0's kernel-mode count of a tensor-parallel job's step on fake
    tensors, on an abstract (1, 1, 2) mesh (as the dry-run counts)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg2, tcfg = tp["cfg"], tp["tcfg"]
    mesh = abstract_mesh(TP_MESH)
    fake = FakeTensorMode()
    with fake:
        state = init_train_state(cfg2, tcfg, device="cpu", mesh=mesh)
        batch = {k: torch.empty(tp["batch"], dtype=torch.int32) for k in ("tokens", "labels")}
    state["step"] = 0  # a fake 0-dim step cannot be read on the host
    step = make_train_step(cfg2, tcfg, tp["opts"], mesh=mesh,
                           act_rules=activation_rules(**tp["options"]))
    with fake:
        _, totals = count_ops(step, state, batch, shapes_only=True)
    return {k: getattr(totals, k) for k in ("flops", "bytes", "by_kernel", "coll_by_key")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # one rank of phase 17's tensor-parallel sub-phase (the phase starts them)
    ap.add_argument("--tp-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-jobs", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tp_rank is not None:
        tp_worker(args.tp_rank, args.tp_port, args.tp_dir, args.seed,
                  tuple(args.tp_jobs.split(",")))
        return 0
    t_run = time.perf_counter()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"== device: torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{kind}, count {torch.cuda.device_count()}; nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"== build: {time.perf_counter() - t0:.2f} s -> {lib_path}")
    for line in ptxas_summary((lib_path.parent / "build.log").read_text()):
        log("   ", line)

    # 3. kernels at the serving and prefill paths' shapes (gemma-2b first:
    # its bf16 row is the one in the kernels line)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = {name: [] for name in WHERE}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in RMSNORM_SHAPES:
            results["rmsnorm"].append(check_rmsnorm(gen, shape, dtype))
        for B, H, KV, D in ((8, 8, 1, 256), (8, 40, 8, 128)):
            results["paged_decode_attention"].append(check_paged(
                gen, B, H, KV, D, 16, 1024, dtype))
            results["decode_attention"].append(check_decode(
                gen, B, H, KV, D, 1024, dtype))
        for B, S, H, KV, D in ((1, 1024, 8, 1, 256), (1, 2048, 40, 8, 128),
                               (1, 1000, 8, 1, 256)):
            results["flash_attention"].append(check_flash(
                gen, B, S, H, KV, D, dtype))
            results["flash_attention_bwd"].append(check_flash_bwd(
                gen, B, S, H, KV, D, dtype))
    # the trainer PE's attention, f32 as its model runs: gemma-2b's heads
    # over 2 x 512 tokens
    results["flash_attention"].append(check_flash(gen, 2, 512, 8, 1, 256, torch.float32))
    results["flash_attention_bwd"].append(check_flash_bwd(gen, 2, 512, 8, 1, 256,
                                                          torch.float32))
    # f32 flash at scores in the hundreds, against f64: gemma-2b's heads,
    # the trainer PE's batch, recurrentgemma-9b's heads with a window
    near_hard = [check_flash_near_hard(gen, *shape) for shape in (
        (1, 1024, 8, 1, 256), (2, 512, 8, 1, 256), (1, 1024, 16, 1, 256, 256))]
    # dense decode at the serving paths' shapes, bf16: the fixed-slot serve
    # (4 slots of 256), decode after the 1024-token prefill, and
    # recurrentgemma-9b's local ring (16 heads, 2048 slots)
    for B, H, Smax in ((4, 8, 256), (1, 8, 1024), (1, 16, 2048)):
        results["decode_attention"].append(check_decode(
            gen, B, H, 1, 256, Smax, torch.bfloat16))
    # and f32 at recurrentgemma-9b's ring: the f32 decode of check_recurrent
    results["decode_attention"].append(check_decode(gen, 1, 16, 1, 256, 2048,
                                                    torch.float32))
    # the recurrent families' prefill shapes: recurrentgemma-9b (d_rnn 4096;
    # 16 heads, MQA, head_dim 256, window 2048 over 4096 tokens), xlstm-125m
    # (4 heads of dk 384, chunk 128, 2048 tokens; bf16 first: the model's)
    results["rglru_scan"].append(check_rglru(gen, 1, 4096, 4096))
    # and a batch, a long sequence, a sequence off the kernel's stages
    for B, S in ((4, 1024), (1, 16384), (1, 1000)):
        results["rglru_scan"].append(check_rglru(gen, B, S, 4096))
    for dtype in (torch.bfloat16, torch.float32):
        results["mlstm_chunk"].append(check_mlstm(gen, 1, 2048, 4, 384, 128, dtype))
    windowed = [check_flash(gen, 1, 4096, 16, 1, 256, dtype, window=2048)
                for dtype in (torch.bfloat16, torch.float32)]
    # the recurrent families' training shapes (bf16 first: the model's):
    # recurrentgemma-9b's local layers and RG-LRU over 1 x 4096 tokens,
    # xlstm-125m's mLSTM over 2 x 1024
    for dtype in (torch.bfloat16, torch.float32):
        results["flash_attention_bwd_window"].append(check_flash_bwd(
            gen, 1, 4096, 16, 1, 256, dtype, window=2048))
    results["rglru_scan_bwd"].append(check_rglru_bwd(gen, 1, 4096, 4096))
    for dtype in (torch.bfloat16, torch.float32):
        results["mlstm_chunk_bwd"].append(check_mlstm_bwd(gen, 2, 1024, 4, 384, 128,
                                                          dtype))
    # the MoE and frontend families' attention, bf16: MHA at D 128
    # (deepseek-moe-16b, qwen2-moe-a2.7b: H = KV = 16, G = 1; prefill of
    # 2048, paged serving, fixed-slot serving) and at D 64 (musicgen-large:
    # 32 heads, its train step's 1024 positions)
    mha = {name: [] for name in ("flash_attention", "flash_attention_bwd",
                                 "paged_decode_attention", "decode_attention")}
    for B, S, H, KV, D in ((1, 2048, 16, 16, 128), (1, 1024, 32, 32, 64)):
        mha["flash_attention"].append(check_flash(gen, B, S, H, KV, D, torch.bfloat16))
        mha["flash_attention_bwd"].append(check_flash_bwd(gen, B, S, H, KV, D,
                                                          torch.bfloat16))
    mha["paged_decode_attention"].append(check_paged(gen, 8, 16, 16, 128, 16, 1024,
                                                     torch.bfloat16))
    mha["decode_attention"].append(check_decode(gen, 4, 16, 16, 128, 256, torch.bfloat16))
    # the dense decode kernel's log-sum-exp and the rank-ordered merge of a
    # sequence-split decode's partials, at rows 3, 3q and 3s's shapes in
    # both types: the merge over the production meshes' 16 ranks and the
    # (1, 1, 2) mesh's 2 (gemma-2b's bf16 row first: the kernels line's)
    lse_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for B, H, KV, D, Smax in ((8, 8, 1, 256, 1024), (8, 40, 8, 128, 1024),
                                  (4, 8, 1, 256, 256), (1, 8, 1, 256, 1024),
                                  (1, 16, 1, 256, 2048)):
            lse_rows.append(check_decode_lse(gen, B, H, KV, D, Smax, dtype))
            for n in (16, 2):
                results["merge_partials"].append(check_merge(gen, n, B, H, KV, D, Smax,
                                                             dtype))
    log(f"== kernels ({smi}; {time.perf_counter() - t0:.1f} s)")
    for name, rows in [*results.items(), ("flash_attention (window)", windowed),
                       *((f"{k} (MHA)", v) for k, v in mha.items())]:
        for r in rows:
            lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            tf32 = (f", {r['bound_split_tf32_ms']:.4f} ms as split TF32"
                    if r.get("bound_split_tf32_ms") is not None else "")
            log(f"   {name} {r['shape']} {r['dtype']}"
                + (f" [{r['route']}]" if "route" in r else "") + ": max_abs_err "
                f"{r['max_abs_err']:.3g}, kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, library {lib}, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}{tf32})"
                + (f"; {r['plan']}" if "plan" in r else ""))
    for r in lse_rows:
        log(f"   decode_attention with lse {r['shape']} {r['dtype']}: max_abs_err "
            f"{r['max_abs_err']:.3g}, lse {r['lse_err']:.3g}; output bits as without it; "
            f"kernel {r['ms']:.4f} ms with the lse store, {r['ms_without']:.4f} ms without")
    for r in near_hard:
        log(f"   flash f32 at scores in the hundreds {r['shape']}, max error over the "
            f"largest f64 entry: out {r['out']:.3g}, lse {r['lse']:.3g}; backward on "
            f"the tensor cores / on the CUDA cores: "
            + ", ".join(f"{n} {r[n]['tensor-cores']:.3g} / {r[n]['cuda-cores']:.3g}"
                        for n in ("dq", "dk", "dv"))
            + f" (held: no more than {NEAR_HARD_MARGIN:g} farther)")

    log(f"-- {time.perf_counter() - t_run:.1f} s into the run")
    # 4. paged serve: full-width gemma-2b in bf16
    cfg = get_config("gemma-2b")
    opts = ModelOptions(compute_dtype="bfloat16")
    t0 = time.perf_counter()
    eng = PagedServeEngine(cfg, init_params(cfg, seed=args.seed, device="cuda"),
                           num_blocks=256, block_size=16, max_active=8,
                           prefill_chunk=16, opts=opts)
    params = eng.params  # bf16 matrices, f32 norm scales: shared below
    torch.cuda.synchronize()
    log(f"== paged serve: gemma-2b bf16, {cfg.param_count() / 1e9:.3f} B params, "
        f"weights and engine ready in {time.perf_counter() - t0:.1f} s")
    trace = serve_trace(cfg.vocab_size, args.seed)
    # warm-up (CUDA context, cuBLAS handles) on a small engine, same weights
    warm = PagedServeEngine(cfg, params, num_blocks=8, block_size=16,
                            max_active=2, prefill_chunk=16, opts=opts)
    drive(warm, [(0, trace[0][1][:20], 2)])
    del warm
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()
    m = drive(eng, trace)
    paged_launches = counts()
    metrics = eng.metrics()
    log_serve(m, smi)
    log(f"   launches {paged_launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; metrics {metrics}")
    check_finished(eng, trace, cfg.vocab_size)
    assert paged_launches["rmsnorm"] > 0 and paged_launches["paged_decode_attention"] > 0
    # 2 norms per layer + the final norm, one attention per layer, per micro-step
    per_step = 2 * cfg.num_layers + 1
    assert paged_launches["rmsnorm"] * cfg.num_layers == \
        paged_launches["paged_decode_attention"] * per_step, paged_launches
    assert metrics["prefixHitRate"] > 0, metrics
    assert metrics["cowCopies"] >= 1, metrics
    assert metrics["prefillBacklog"] == 0, metrics
    assert metrics["blocksFree"] + metrics["blocksCached"] == metrics["blocksTotal"]
    eng.cache.evict(eng.alloc.capacity)
    eng.alloc.check()
    assert eng.alloc.blocks_free == eng.alloc.capacity, "blocks leaked"
    del eng

    # where one tick's time goes, at full depth: a prefill tick (16
    # micro-steps) and a decode tick (1), each on a fresh pool
    for label, C in (("prefill tick", 16), ("decode tick", 1)):
        p = profile_tick(cfg, params, opts, trace, C)
        log_profile(f"{label} ({C} micro-steps x {cfg.num_layers} layers, "
                    f"8 slots)", p, smi)

    log(f"-- {time.perf_counter() - t_run:.1f} s into the run")
    # 5. fixed-slot serve: 8 requests on 4 slots (admission queues)
    ftrace = fixed_trace(cfg.vocab_size, args.seed)
    warm = ServeEngine(cfg, params, num_slots=1, max_len=16, opts=opts)
    drive(warm, [(0, ftrace[0][1][:4], 2)])
    del warm
    fixed = ServeEngine(cfg, params, num_slots=4, max_len=256, opts=opts)
    kernels.reset_launch_counts()
    m = drive(fixed, ftrace)
    fixed_launches = counts()
    log("== fixed-slot serve: gemma-2b bf16, 4 slots, max_len 256, "
        f"{len(ftrace)} requests of {min(len(p) for _r, p, _n in ftrace)}-"
        f"{max(len(p) for _r, p, _n in ftrace)} prompt tokens")
    log_serve(m, smi)
    # one decode step per admitted prompt token and one per tick; every
    # step runs the dense decode kernel once per layer, and no prefill runs
    steps = sum(len(p) for _r, p, _n in ftrace) + fixed.ticks
    log(f"   launches {fixed_launches}; {steps} decode steps; metrics "
        f"{fixed.metrics()}")
    check_finished(fixed, ftrace, cfg.vocab_size)
    assert fixed_launches["decode_attention"] == cfg.num_layers * steps, \
        (fixed_launches, steps)
    assert fixed_launches["flash_attention"] == 0, fixed_launches
    assert fixed_launches["rmsnorm"] == (2 * cfg.num_layers + 1) * steps
    del fixed

    log(f"-- {time.perf_counter() - t_run:.1f} s into the run")
    # 6. prefill 1024 tokens through make_prefill_step, then 16 decode steps
    S, n_decode = 1024, 16
    rng = np.random.default_rng(args.seed + 2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S))).to("cuda")
    prefill_then_decode(cfg, params, opts, tokens[:, :64], 1)  # warm
    kernels.reset_launch_counts()
    last, prefill_ms, decode_ms = prefill_then_decode(cfg, params, opts,
                                                      tokens, n_decode)
    prefill_launches = counts()
    assert last.shape == (1, cfg.padded_vocab) and torch.isfinite(last).all()
    log(f"== prefill: gemma-2b bf16, (1, {S}) tokens through make_prefill_step: "
        f"wall {prefill_ms:.3f} ms; then {n_decode} decode steps: wall "
        f"{decode_ms:.3f} ms ({decode_ms / n_decode:.3f} ms a step) ({smi})")
    log(f"   launches {prefill_launches}")
    assert prefill_launches["flash_attention"] == cfg.num_layers, prefill_launches
    assert prefill_launches["decode_attention"] == cfg.num_layers * n_decode, \
        prefill_launches
    prefill = make_prefill_step(cfg, opts, max_len=S)
    log_profile(f"prefill ({S} tokens x {cfg.num_layers} layers)",
                profiled(lambda: prefill(params, {"tokens": tokens})), smi)
    # the prefill counted on the card for phase 18
    analysis = {"prefill": card_count(prefill, params, {"tokens": tokens})}
    _, cache = prefill(params, {"tokens": tokens[:, :S - 1]})
    step = make_decode_step(cfg, opts)
    log_profile(f"decode step (context {S - 1})",
                profiled(lambda: step(params, cache, tokens[:, S - 1].to(torch.int32))),
                smi)
    del cache, params

    log(f"-- {time.perf_counter() - t_run:.1f} s into the run")
    # 7. train: full-width, full-depth gemma-2b through the launcher
    steps, warmup, batch, seq = 8, 2, 2, 1024
    t_train = time.perf_counter()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    log(f"== train: gemma-2b through repro_torch.launch.train.main, {steps} steps "
        f"({warmup} warm-up) of {batch} x {seq} tokens, f32 params and moments, "
        "bf16 compute, remat")
    records = train_launcher.main(["--arch", "gemma-2b", "--steps", str(steps),
                                   "--batch", str(batch), "--seq", str(seq)])
    train_launches = counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    assert len(records) == steps
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in records), records
    timed = [r["wall_s"] for r in records[warmup:]]
    wall = sum(timed) / len(timed)
    log(f"   step wall {wall * 1e3:.3f} ms (mean of {len(timed)}; min "
        f"{min(timed) * 1e3:.3f}, max {max(timed) * 1e3:.3f}), "
        f"{batch * seq / wall:.1f} training tokens/s, peak memory {peak_gib:.2f} GiB "
        f"({smi})")
    log("   per step (loss, grad norm, wall s): " + "; ".join(
        f"{r['loss']:.4f} {r['grad_norm']:.4f} {r['wall_s']:.3f}" for r in records))
    log(f"   launches {train_launches}")
    # under remat every layer's forward runs twice (forward, recompute in
    # backward): flash forward 2 per layer, RMSNorm 2 per layer twice plus
    # the final norm once; the backward kernel once per layer
    L = cfg.num_layers
    phase7 = {"wall": wall, "peak_gib": peak_gib, "launches": train_launches,
              "records": [(r["loss"], r["grad_norm"]) for r in records]}
    assert train_launches["flash_attention"] == 2 * L * steps, train_launches
    assert train_launches["flash_attention_bwd"] == L * steps, train_launches
    assert train_launches["rmsnorm"] == (4 * L + 1) * steps, train_launches

    # one step of a fresh state, profiled; every parameter leaf must move
    tcfg = TrainConfig(remat=True)
    state = init_train_state(cfg, tcfg, seed=args.seed, device="cuda")
    step = make_train_step(cfg, tcfg, opts)
    src = StreamSource(vocab_size=cfg.vocab_size, batch=batch, seq_len=seq,
                       seed=args.seed)
    before = [p.detach().flatten()[:4096].clone() for p in leaves(state["params"])]
    state, _ = step(state, src.batch_at(0))
    still = [i for i, (p, b) in enumerate(zip(leaves(state["params"]), before))
             if torch.equal(p.detach().flatten()[:4096], b)]
    assert not still, f"parameter leaves {still} did not move"
    del before
    log_profile(f"train step ({batch} x {seq} tokens x {L} layers, remat)",
                profiled(lambda: step(state, src.batch_at(1)), by_op=True), smi)
    # one step counted on the card for phase 18
    analysis["train"] = card_count(step, state, src.batch_at(2))
    del state, step
    log(f"   train phase: {time.perf_counter() - t_train:.1f} s")

    log(f"-- {time.perf_counter() - t_run:.1f} s into the run")
    # 8. checks at full width and 2 layers.  The random network is chaotic
    # with depth (the reference's init gives nearly hard attention), so at
    # 18 layers two correct attention implementations part ways; 2 layers
    # keeps the comparison about them
    cfg2 = cfg.with_(num_layers=2)
    params32 = init_params(cfg2, seed=args.seed, device="cuda")
    params16 = cast_params(params32, opts.dtype)
    lk = first_tick_logits(cfg2, params16, opts, trace, 16, "kernel")
    lg = first_tick_logits(cfg2, params16, opts, trace, 16, "gather")
    assert lk.shape == (8, cfg.padded_vocab) and torch.isfinite(lk).all()
    rel = rel_err(lk, lg)
    log(f"== checks at 2 layers, full width\n   paged first-tick logits, bf16, "
        f"kernel vs gather: max |diff| / max |logit| = {rel:.3g} (tolerance "
        f"{LOGITS_BF16_RTOL}); argmax agrees on "
        f"{(lk.argmax(-1) == lg.argmax(-1)).sum().item()}/8 rows")
    assert rel <= LOGITS_BF16_RTOL, rel
    del lk, lg

    check_forward_flash(cfg2, params16, tokens, opts)
    del params16

    # prefill + decode against forward over the whole sequence, f32
    opts32 = ModelOptions(compute_dtype="float32")
    n0, n1 = 256, 320
    decode0 = counts()
    full, _ = forward(params32, cfg2, tokens[:, :n1], opts=opts32)
    pre, cache = forward_with_cache(params32, cfg2, tokens[:, :n0], max_len=n1,
                                    opts=opts32)
    errs = [(pre[:, -1] - full[:, n0 - 1]).abs().max().item()]
    del pre
    for t in range(n0, n1):
        lg, cache = decode_step(params32, cfg2, cache, tokens[:, t], opts32)
        errs.append((lg - full[:, t]).abs().max().item())
    rel = max(errs) / full.abs().max().item()
    log(f"   prefill {n0} + decode {n1 - n0} vs forward, f32: max |diff| / "
        f"max |logit| = {rel:.3g} (tolerance {PREFILL_DECODE_RTOL})")
    assert rel <= PREFILL_DECODE_RTOL, rel
    del full, cache

    # greedy tokens, f32: paged kernel path, paged gather path, fixed slot
    tokens_by = {}
    for impl in ("kernel", "gather"):
        e = PagedServeEngine(cfg2, params32, num_blocks=256, block_size=16,
                             max_active=8, prefill_chunk=16, opts=opts32,
                             attn_impl=impl)
        drive(e, [(r, p, 8) for r, p, _n in trace])
        tokens_by[impl] = {r.rid: r.generated for r in e.finished}
    e = ServeEngine(cfg2, params32, num_slots=8, max_len=256, opts=opts32)
    drive(e, [(r, p, 8) for r, p, _n in trace])
    tokens_by["fixed"] = {r.rid: r.generated for r in e.finished}
    assert tokens_by["kernel"] == tokens_by["gather"], "f32 paged tokens differ"
    assert tokens_by["fixed"] == tokens_by["kernel"], \
        "f32 fixed-slot and paged tokens differ"
    log(f"   f32 greedy tokens: paged kernel path, paged gather path and the "
        f"fixed-slot engine give the same "
        f"{sum(map(len, tokens_by['kernel'].values()))} tokens")
    del e
    f32_decode = decode_launches_since(decode0)
    log(f"   f32 decode kernel launches in the prefill + decode and the engines: "
        f"{f32_decode}")
    assert all(n > 0 for n in f32_decode.values()), f32_decode

    # one train step, kernels vs plain: f32 at 2 layers, bf16 at 1; then two
    # kernel-path steps from one state, bit for bit (bf16, 2 layers)
    tb = StreamSource(vocab_size=cfg.vocab_size, batch=batch, seq_len=seq,
                      seed=args.seed).batch_at(7)
    tb = {k: v.to("cuda") for k, v in tb.items()}
    check_train_step(cfg2, params32, tb, "float32", TRAIN_F32, smi)
    cfg1 = cfg2.with_(num_layers=1)
    check_train_step(cfg1, take_layers(params32, 1), tb, "bfloat16", TRAIN_BF16, smi)
    runs = []
    for _ in range(2):
        state = init_train_state(cfg2, params=clone_params(params32))
        state, m = make_train_step(cfg2, TrainConfig(), opts)(state, tb)
        runs.append((m["loss"].item(), leaves(state["params"])))
        del state
    same = runs[0][0] == runs[1][0] and all(
        torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    log(f"   two bf16 train steps from one state, 2 layers: parameters "
        f"{'identical' if same else 'DIFFER'} bit for bit")
    assert same, "train step is not deterministic"
    del runs, params32

    log(f"-- {time.perf_counter() - t_run:.1f} s into the run")
    # 9-10. the recurrent families at full width and depth, bf16
    rg_launches = recurrent_phase("recurrentgemma-9b", 4096, args.seed, smi)
    xl_launches = recurrent_phase("xlstm-125m", 2048, args.seed, smi)

    log(f"-- {time.perf_counter() - t_run:.1f} s into the run")
    # 11. checks of both families at full width and one pattern group
    for arch, n_layers in (("recurrentgemma-9b", 3), ("xlstm-125m", 4)):
        check_recurrent(arch, n_layers, args.seed, smi)

    log(f"-- {time.perf_counter() - t_run:.1f} s into the run")
    # 12-13. the MoE families at full width and depth, bf16, then their
    # checks at full width and 2 layers
    for arch in ("deepseek-moe-16b", "qwen2-moe-a2.7b"):
        moe_phase(arch, args.seed, smi)
    for arch in ("deepseek-moe-16b", "qwen2-moe-a2.7b"):
        check_moe(arch, args.seed, smi)

    log(f"-- {time.perf_counter() - t_run:.1f} s into the run")
    # 14. training the MoE and frontend families
    train_moe_frontends(args.seed, smi)

    log(f"-- {time.perf_counter() - t_run:.1f} s into the run")
    # 15. training the recurrent families at full width: recurrentgemma-9b
    # at one pattern group (3 layers; its 38 do not fit in f32 with AdamW)
    # over 1 x 4096 tokens, twice its window; xlstm-125m at two pattern
    # groups (8 of its 12 layers: its host-bound sLSTM loops' wall follows
    # the layers) over 2 x 1024; then their checks
    rg_train = recurrent_train_phase("recurrentgemma-9b", 3, 1, 4096, args.seed, smi)
    xl_train = recurrent_train_phase("xlstm-125m", 8, 2, 1024, args.seed, smi)
    check_recurrent_train("recurrentgemma-9b", 3, 1, 4096, args.seed, smi)
    check_recurrent_train("xlstm-125m", 4, 2, 1024, args.seed, smi)

    log(f"-- {time.perf_counter() - t_run:.1f} s into the run")
    # 16. the port's trainer PE with a stop and a resume (last: it turns on
    # deterministic algorithms for the rest of the process)
    trainer_pe_phase(args.seed, smi)

    log(f"-- {time.perf_counter() - t_run:.1f} s into the run")
    # 17. the mesh train step at world size 1 over NCCL, then tensor-parallel
    # on a (1, 1, 2) mesh of two processes over gloo
    mesh_phase(args.seed, smi, phase7)
    tp = tp_phase(args.seed, smi)

    log(f"-- {time.perf_counter() - t_run:.1f} s into the run")
    # 18. analysis: the dry-run on fake tensors, and the card's counts of
    # phases 6 and 7 against the same steps' fake counts
    analysis_phase(analysis, cfg, opts, tokens, batch, seq, smi, tp)

    log(f"-- {time.perf_counter() - t_run:.1f} s into the run")
    # 19. the kernels line, the card, the result.  Each kernel's launches are
    # those of the path that runs it: the paged serve run (RMSNorm, paged
    # decode), the recurrent train run's windowed flash backward
    # (recurrentgemma-9b's; the windowed flash is logged with its prefill
    # phase), the recurrent kernels forward and backward rank 0's in the
    # first step of phase 17's tensor-parallel recurrentgemma-9b and
    # xlstm-125m jobs, and since the reference's mesh options: the flash
    # forward and backward rank 0's in the first step of phase 17's
    # sequence-parallel gemma-2b job, the dense decode and the merge rank
    # 0's in its qwen3-14b serving job with the cache over the sequence (the
    # fixed-slot run's, the prefill's and the train run's own launches are
    # asserted in their phases and logged here)
    tp_train = {job["job"]: job["launches"] for job in tp["train"]}
    tp_serve = {job["job"]: job["launches"] for job in tp["serve"]}
    launches = {"rmsnorm": paged_launches["rmsnorm"],
                "paged_decode_attention": paged_launches["paged_decode_attention"],
                "decode_attention": tp_serve["qwen3-14b+cache-seq"]["decode_attention"],
                "flash_attention": tp_train["gemma-2b+sp"]["flash_attention"],
                "flash_attention_bwd": tp_train["gemma-2b+sp"]["flash_attention_bwd"],
                "rglru_scan": tp_train["recurrentgemma-9b"]["rglru_scan"],
                "mlstm_chunk": tp_train["xlstm-125m"]["mlstm_chunk"],
                "flash_attention_bwd_window": rg_train["flash_attention_bwd"],
                "rglru_scan_bwd": tp_train["recurrentgemma-9b"]["rglru_scan_bwd"],
                "mlstm_chunk_bwd": tp_train["xlstm-125m"]["mlstm_chunk_bwd"],
                "merge_partials": tp_serve["qwen3-14b+cache-seq"]["merge_partials"]}
    log(f"   the recurrent prefills' launches (phases 9-10) {rg_launches} and {xl_launches}; "
        f"the recurrent train runs' (phase 15) {rg_train} and {xl_train}; the fixed-slot "
        f"run's dense decode {fixed_launches['decode_attention']}, the prefill's flash "
        f"{prefill_launches['flash_attention']}, the train run's flash backward "
        f"{train_launches['flash_attention_bwd']}")
    assert all(n > 0 for n in launches.values()), launches
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": WHERE[name][0],
         "replaces": WHERE[name][1], "launches": launches[name],
         **{k: results[name][0][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}}
        for name in WHERE]}
    log(json.dumps(line))
    log(f"== wall: {time.perf_counter() - t_run:.1f} s")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
