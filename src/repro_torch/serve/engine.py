"""Serving: prefill and decode steps and the continuous-batching engines,
ported from ``repro/serve/engine.py``.

``make_prefill_step`` / ``make_decode_step`` wrap ``forward_with_cache``
and ``decode_step``; given a mesh (``launch.mesh``) and activation rules,
as the reference's take them, they run tensor-parallel over its ``model``
axis, on this rank's shards of the parameters and its block of the cache.
The engines take no mesh, as the reference's do not.

``ServeEngine`` is the fixed-slot driver: every slot
owns a dense cache row of ``max_len`` positions, and a prompt is admitted
token by token through the batched decode step with only the admitted row
advancing (the reference's ``_merge_slot``, without copying the cache).

``PagedServeEngine``: KV lives in fixed-size blocks handed out by a
free-list allocator (``paging.py``), so admission capacity scales with
tokens actually held; prompts prefill in chunks inside the regular mixed
tick (``paged_model.py``); committed prompt blocks are shared across
requests through a refcounted prefix cache with copy-on-write on
divergence.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..convert import cast_params
from ..device import resolve_device
from ..models.lm import ModelOptions, decode_step, forward_with_cache, init_cache
from ..sharding.ctx import tensor_axis, use_rules
from ..sharding.specs import PARAM_RULES, spec_axes
from ..train.step import batch_sharding, compute_gather
from .paged_model import (
    all_attention,
    init_paged_state,
    make_copy_block,
    make_paged_tick,
    make_reset_slot,
)
from .paging import BlockAllocator, OutOfBlocks, PrefixCache, SequenceBlocks


@dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int
    generated: list = field(default_factory=list)
    done: bool = False


def _mesh_binding(cfg: ArchConfig, mesh, act_rules: dict, param_rules: dict):
    """(gather, rows, bind) of a serving step on ``mesh``: ``gather(params)``
    the tree the model computes on from this rank's shards (gathered over
    the batch axes, and over ``model`` for the leaves tensor-parallel
    compute does not split: ``train.step.compute_gather``), ``rows(x)``
    this rank's rows of a global batch tensor (split over the axes
    ``act_rules["batch"]`` names), and ``bind()`` the binding the model
    reads."""
    batch_axes = tuple(a for a in spec_axes(act_rules.get("batch")) if a in mesh.axis_names)
    gather = compute_gather(cfg, mesh, tensor_axis(act_rules, mesh, batch_axes), param_rules)

    def rows(x):
        return None if x is None else batch_sharding(mesh, {"x": x}, batch_axes)["x"]

    return gather, rows, lambda: use_rules(mesh, act_rules, batch_axes)


def make_prefill_step(cfg: ArchConfig, opts: ModelOptions = ModelOptions(),
                      max_len: int = 0, mesh=None, act_rules=None,
                      param_rules: dict = PARAM_RULES):
    """``prefill(params, batch) -> (logits, cache)``: ``forward_with_cache``
    over ``batch["tokens"]`` (B,S), the cache padded to ``max(max_len, S)``.

    With a ``mesh`` and ``act_rules`` (``sharding.activation_rules``, its
    ``batch`` the axes the rows split over: ``sharding.ctx.data_axes_for``)
    ``params`` are this rank's shards (``sharding.specs.local_params`` by
    ``param_rules``) and ``batch`` the global batch: the step takes this
    rank's rows and returns their logits (this rank's vocab block where the
    head splits it) and this rank's cache, placed as
    ``sharding.specs.cache_specs`` places it.  Without them it is the
    one-device step."""
    def prefill(params, batch):
        return forward_with_cache(params, cfg, batch["tokens"],
                                  batch.get("frontend_embeds"),
                                  max_len=max_len, opts=opts)

    if mesh is None or not act_rules:
        return prefill
    gather, rows, bind = _mesh_binding(cfg, mesh, act_rules, param_rules)

    def mesh_prefill(params, batch):
        with bind():
            return prefill(gather(params), {k: rows(v) for k, v in batch.items()})

    return mesh_prefill


def make_decode_step(cfg: ArchConfig, opts: ModelOptions = ModelOptions(),
                     mesh=None, act_rules=None, param_rules: dict = PARAM_RULES):
    """``step(params, cache, tokens, advance=None) -> (logits, cache)``:
    ``decode_step``, the cache updated in place.  With a ``mesh`` and
    ``act_rules`` (as ``make_prefill_step``) ``params`` are this rank's
    shards, ``cache`` this rank's block (``sharding.specs.local_cache``, or
    the sharded prefill's), and ``tokens`` and ``advance`` the global
    batch's, of which the step takes this rank's rows."""
    def step(params, cache, tokens, advance=None):
        return decode_step(params, cfg, cache, tokens, opts, advance)

    if mesh is None or not act_rules:
        return step
    gather, rows, bind = _mesh_binding(cfg, mesh, act_rules, param_rules)

    def mesh_step(params, cache, tokens, advance=None):
        with bind():
            return step(gather(params), cache, rows(tokens), rows(advance))

    return mesh_step


class ServeEngine:
    """Continuous batching over a fixed slot count (single-device driver).

    Each slot is a batch row of one dense cache padded to ``max_len``.
    Admission zeroes the row and feeds the prompt one token at a time
    through the batched decode step, with only that row advancing; then
    every tick decodes one token for all slots (empty ones too, as in the
    reference).  Greedy decoding; per-slot lengths.

    ``params`` are the port's parameters; the engine casts matrices and the
    embedding table to the compute dtype once, here, and keeps norm scales
    in f32.  The cache is kept in the compute dtype.  It runs on CUDA
    unless ``device="cpu"`` is passed.
    """

    def __init__(self, cfg: ArchConfig, params, num_slots: int, max_len: int,
                 opts: ModelOptions = ModelOptions(), device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.opts = opts
        self.params = cast_params(params, opts.dtype, self.device)
        self.num_slots = num_slots
        self.max_len = max_len
        self.cache = init_cache(cfg, num_slots, max_len, opts.dtype,
                                self.device)
        self.slots: list = [None] * num_slots
        self.queue: deque = deque()
        self.finished: list = []
        self._decode = make_decode_step(cfg, opts)
        self._next_token = torch.zeros((num_slots,), dtype=torch.int32,
                                       device=self.device)
        self.ticks = 0
        self.tokens_generated = 0
        self.slots_busy = 0
        self._busy_ticks = 0
        self.on_metrics: Optional[Callable[[dict], None]] = None

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.num_slots):
            if self.slots[slot] is None and self.queue:
                req = self.queue.popleft()
                self.slots[slot] = req
                self.slots_busy += 1
                _reset_slot(self.cache, slot)
                only = torch.zeros((self.num_slots,), dtype=torch.bool,
                                   device=self.device)
                only[slot] = True
                tok = self._next_token.clone()
                for t in req.prompt:
                    tok[slot] = t
                    logits, self.cache = self._decode(self.params, self.cache,
                                                      tok, only)
                self._next_token[slot] = torch.argmax(logits[slot])

    def metrics(self) -> dict:
        """Slot occupancy + queue state: the engine's scaling signals."""
        busy = self.slots_busy
        return {
            "numSlots": self.num_slots, "slotsBusy": busy,
            "occupancy": busy / self.num_slots,
            "meanOccupancy": (self._busy_ticks / (self.ticks * self.num_slots)
                              if self.ticks else 0.0),
            "queueDepth": len(self.queue),
            "backpressure": min(1.0, len(self.queue) / self.num_slots),
            "ticks": self.ticks, "tokensGenerated": self.tokens_generated,
            "finished": len(self.finished),
        }

    def step(self) -> list:
        """One engine tick: admit, decode one token for all slots."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        self.ticks += 1
        self._busy_ticks += len(active)
        if self.on_metrics is not None:
            self.on_metrics(self.metrics())
        if not active:
            return []
        logits, self.cache = self._decode(self.params, self.cache,
                                          self._next_token)
        # greedy on the device (first maximum, as np.argmax); B ints cross
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        host = nxt.cpu().tolist()
        out = []
        for i in active:
            req = self.slots[i]
            tok = host[i]
            req.generated.append(tok)
            if len(req.generated) >= req.max_new_tokens:
                req.done = True
                self.finished.append(req)
                self.slots[i] = None
                self.slots_busy -= 1
            out.append((req.rid, tok))
        self.tokens_generated += len(out)
        self._next_token = nxt
        return out

    def run_until_drained(self, max_ticks: int = 10000) -> list:
        ticks = 0
        while (self.queue or self.slots_busy) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.finished


def _reset_slot(cache, slot: int) -> None:
    """Zero one slot's cache row and length, in place (main-group leaves
    carry the group axis first, so their batch axis is 1)."""
    for seg in ("prefix", "tail"):
        for entry in cache[seg]:
            for t in entry.values():
                t[slot] = 0
    for entry in cache["main"]:
        for t in entry.values():
            t[:, slot] = 0
    cache["len"][slot] = 0


@dataclass
class _PagedSlot:
    """One active request's engine-side bookkeeping."""

    req: Request
    seq: SequenceBlocks
    pos: int  # prompt tokens fed so far (== cached tokens at admission)
    next_token: int = 0  # next decode feed once prefill completed
    reserved: int = 0  # future block demand still counted in the reserve


class PagedServeEngine:
    """Continuous batching over a paged KV cache (single-device driver).

    Admission allocates blocks for the request's actual length, after
    consulting the prefix cache for committed prompt blocks it can share
    (refcounted; copy-on-write on the first divergent write into a shared
    tail block).  Prompts prefill in chunks of ``prefill_chunk`` tokens
    inside the regular batched tick, so a long admission delays running
    decodes by at most ``prefill_chunk - 1`` masked micro-steps.  Greedy
    decoding.

    ``params`` are the port's parameters (``models.init_params`` or
    ``convert.params_from_numpy``); the engine casts matrices and the
    embedding table to the compute dtype once, here, and keeps norm scales
    in f32.  It runs on CUDA unless ``device="cpu"`` is passed.
    ``attn_impl`` is ``"kernel"`` (the paged CUDA kernel) or ``"gather"``
    (the plain path that tests compare against).
    """

    def __init__(self, cfg: ArchConfig, params, *, num_blocks: int,
                 block_size: int = 16, max_active: int = 8,
                 prefill_chunk: int = 8, opts: ModelOptions = ModelOptions(),
                 attn_impl: str = "kernel", prefix_cache: bool = True,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.opts = opts
        self.max_active = max_active
        self.prefill_chunk = max(1, prefill_chunk)
        self._tick = make_paged_tick(cfg, opts, attn_impl=attn_impl)
        self.params = cast_params(params, opts.dtype, self.device)
        self.alloc = BlockAllocator(num_blocks, block_size)
        # prefix sharing needs every layer's state to be reconstructable
        # from shared KV blocks: only true for pure global attention
        self.cache = (PrefixCache(self.alloc)
                      if prefix_cache and all_attention(cfg) else None)
        self.state = init_paged_state(cfg, max_active, num_blocks,
                                      block_size, opts.dtype, self.device)
        self._tables = np.zeros((max_active, self.alloc.capacity), np.int32)
        self._copy = make_copy_block(cfg)
        self._reset = make_reset_slot(cfg)
        self.slots: list = [None] * max_active
        self.queue: deque = deque()
        self.finished: list = []
        # incremental signal counters (metrics() never rescans)
        self.ticks = 0
        self.tokens_generated = 0
        self.slots_busy = 0
        self._busy_ticks = 0
        self._reserved = 0  # future block demand of active slots
        self._prefill_backlog = 0  # prompt tokens submitted, not yet fed
        self._prompt_tokens = 0  # admitted prompt tokens (hit-rate denom)
        self._cached_tokens = 0  # admitted via prefix cache (hit-rate num)
        self.cow_copies = 0
        self.peak_active = 0
        self.on_metrics: Optional[Callable[[dict], None]] = None

    # ----------------------------------------------------------- admission

    def submit(self, req: Request) -> None:
        need = self.alloc.blocks_for_tokens(
            len(req.prompt) + req.max_new_tokens)
        if need > self.alloc.capacity:
            raise ValueError(
                f"request {req.rid} needs {need} blocks; pool holds "
                f"{self.alloc.capacity}")
        self.queue.append(req)
        self._prefill_backlog += len(req.prompt)

    def _admit(self) -> None:
        while self.queue:
            slot = next((i for i, s in enumerate(self.slots) if s is None),
                        None)
            if slot is None:
                return
            req = self.queue[0]
            prompt = list(req.prompt)
            blocks, n, tail_shared = ([], 0, False)
            if self.cache is not None:
                blocks, n, tail_shared = self.cache.match(prompt)
            # banker's admission: reserve the request's entire footprint
            # (prompt + worst-case decode; a shared tail costs one extra,
            # its copy-on-write replacement) against free blocks minus the
            # outstanding reservations of running requests, so growth
            # during decode can never deadlock the pool
            required = (self.alloc.blocks_for_tokens(
                len(prompt) + req.max_new_tokens)
                - len(blocks) + (1 if tail_shared else 0))
            short = required + self._reserved - self.alloc.blocks_free
            if short > 0 and self.cache is not None:
                self.cache.evict(short)
            if required + self._reserved > self.alloc.blocks_free:
                for b in blocks:  # memory-aware admission control: wait
                    self.alloc.decref(b)
                return
            self.queue.popleft()
            seq = SequenceBlocks(self.alloc)
            seq.adopt(blocks, n)
            self.slots[slot] = _PagedSlot(req=req, seq=seq, pos=n,
                                          reserved=required)
            self._reserved += required
            self.slots_busy += 1
            self.peak_active = max(self.peak_active, self.slots_busy)
            self._prompt_tokens += len(prompt)
            self._cached_tokens += n
            self._prefill_backlog -= n  # cached tokens are never fed
            self._table_row(slot)
            self.state = self._reset(self.state, slot, n)

    def _table_row(self, slot: int) -> None:
        blocks = self.slots[slot].seq.blocks
        self._tables[slot, :len(blocks)] = blocks
        self._tables[slot, len(blocks):] = BlockAllocator.SCRATCH

    def _retire(self, slot: int) -> None:
        s = self.slots[slot]
        self._reserved -= s.reserved  # release any unused reservation
        s.seq.free()
        self._tables[slot, :] = BlockAllocator.SCRATCH
        self.state["len"][slot] = 0
        self.slots[slot] = None
        self.slots_busy -= 1

    # ---------------------------------------------------------------- tick

    def _spend(self, s: _PagedSlot, n_blocks: int) -> None:
        take = min(s.reserved, n_blocks)
        s.reserved -= take
        self._reserved -= take

    def _grow(self, s: _PagedSlot, n_tokens: int) -> bool:
        """CoW guard + capacity for the next ``n_tokens`` writes; evicts
        cache blocks under pressure.  False => stall this slot one tick.
        Every block actually allocated drains the slot's admission-time
        reservation, keeping the banker's ledger exact."""
        seq = s.seq
        try:
            dst, src = seq.ensure_writable()
        except OutOfBlocks:
            if self.cache is None or not self.cache.evict(1):
                return False
            dst, src = seq.ensure_writable()
        if src is not None:
            self.state = self._copy(self.state, src, dst)
            self.cow_copies += 1
            self._spend(s, 1)
        try:
            self._spend(s, len(seq.ensure_capacity(n_tokens)))
        except OutOfBlocks:
            need = self.alloc.blocks_for_tokens(seq.length + n_tokens) \
                - len(seq.blocks)
            if self.cache is None or \
                    not self.cache.evict(need - self.alloc.blocks_free):
                return False
            try:
                self._spend(s, len(seq.ensure_capacity(n_tokens)))
            except OutOfBlocks:
                return False
        return True

    def step(self) -> list:
        """One engine tick: admit, then one mixed prefill/decode program."""
        self._admit()
        active_idx = [i for i, s in enumerate(self.slots) if s is not None]
        self.ticks += 1
        self._busy_ticks += len(active_idx)
        if self.on_metrics is not None:
            self.on_metrics(self.metrics())
        if not active_idx:
            return []
        prefilling = [i for i in active_idx
                      if self.slots[i].pos < len(self.slots[i].req.prompt)]
        C = self.prefill_chunk if prefilling else 1
        feed = np.zeros((self.max_active, C), np.int32)
        counts = np.zeros((self.max_active,), np.int32)
        active = np.zeros((self.max_active,), bool)
        issued: dict = {}
        for i in active_idx:
            s = self.slots[i]
            P = len(s.req.prompt)
            toks = (s.req.prompt[s.pos:s.pos + C] if s.pos < P
                    else [s.next_token])
            if not self._grow(s, len(toks)):
                continue  # pool exhausted: the slot stalls this tick
            self._table_row(i)
            feed[i, :len(toks)] = toks
            counts[i] = len(toks)
            active[i] = True
            issued[i] = len(toks)
            s.seq.length += len(toks)
        if not issued:
            return []
        dev = self.device
        logits, self.state = self._tick(
            self.params, self.state, torch.from_numpy(self._tables).to(dev),
            torch.from_numpy(feed).to(dev), torch.from_numpy(counts).to(dev),
            torch.from_numpy(active).to(dev))
        # greedy sampling on the device: torch.argmax, like np.argmax,
        # returns the first maximum, and only B ints cross to the host
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()

        out = []
        for i, n in issued.items():
            s = self.slots[i]
            P = len(s.req.prompt)
            if s.pos < P:  # was prefilling
                s.pos += n
                self._prefill_backlog -= n
                if s.pos == P:
                    # prompt complete: sample the first token (fed next
                    # tick) and publish the prompt's blocks for reuse
                    s.next_token = int(nxt[i])
                    if self.cache is not None:
                        self.cache.insert(s.req.prompt, s.seq.blocks, P)
            else:
                tok = int(nxt[i])
                s.req.generated.append(tok)
                s.next_token = tok
                out.append((s.req.rid, tok))
                self.tokens_generated += 1
                if len(s.req.generated) >= s.req.max_new_tokens:
                    s.req.done = True
                    self.finished.append(s.req)
                    self._retire(i)
        return out

    def run_until_drained(self, max_ticks: int = 10000) -> list:
        ticks = 0
        while (self.queue or self.slots_busy) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.finished

    # ------------------------------------------------------------- signals

    def metrics(self) -> dict:
        """Occupancy signals plus the paged engine's own: ``blocksFree`` /
        ``blocksCached`` (allocator + prefix-cache state), ``prefixHitRate``
        (admitted prompt tokens served from cache), ``prefillBacklog``
        (prompt tokens waiting to be fed)."""
        return {
            "numSlots": self.max_active, "slotsBusy": self.slots_busy,
            "occupancy": self.slots_busy / self.max_active,
            "meanOccupancy": (self._busy_ticks
                              / (self.ticks * self.max_active)
                              if self.ticks else 0.0),
            "queueDepth": len(self.queue),
            "backpressure": min(1.0, len(self.queue) / self.max_active),
            "ticks": self.ticks, "tokensGenerated": self.tokens_generated,
            "finished": len(self.finished),
            "blocksTotal": self.alloc.capacity,
            "blocksFree": self.alloc.blocks_free,
            "blocksReserved": self._reserved,
            "blocksCached": (self.cache.blocks_cached
                             if self.cache is not None else 0),
            "prefixHitRate": (self._cached_tokens / self._prompt_tokens
                              if self._prompt_tokens else 0.0),
            "prefillBacklog": self._prefill_backlog,
            "cowCopies": self.cow_copies,
        }
