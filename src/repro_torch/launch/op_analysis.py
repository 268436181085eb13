"""Count what a step computes, moves and holds: the port's counterpart of
``repro/launch/hlo_analysis.py``.

There is no compiled module to walk, so ``OpCounter`` watches the aten ops
as the step runs them: a ``TorchDispatchMode``, on fake tensors (the
dry-run: nothing is drawn or allocated, ``repro_torch.launch.cells``) or
on real ones (the card).  ``Totals`` carries the reference's fields, per
rank and per execution:

- ``flops``: matmul and conv FLOPs by the formulas of
  ``torch.utils.flop_counter`` (its ``flop_registry``: ``mm``, ``bmm``,
  ``addmm``, convolutions, ...), plus, in kernel mode, each kernel call's;
- ``bytes``: what the matmuls (their inputs and outputs) and the kernels
  (their ``Cost``) read and write, the HBM traffic of the work that
  dominates a step;
- ``bytes_raw``: every op's inputs plus outputs (views excepted), an upper
  bound: a fused or cached step moves less;
- ``coll_bytes`` and ``coll_by_key``: the bytes each rank receives over
  the mesh's collectives (``record_collective``, from every collective of
  ``sharding.collectives``, over an abstract mesh's groups or real ones),
  keyed as ``ordered_sum/model/g16`` (the kind, the mesh axes, the group
  size);
- ``peak_bytes``: the high-water mark of live storage, the storages alive
  when the count began (``argument_bytes``) plus those the step made (each
  tracked from the op that made it to a weakref finalizer on its storage);
  ``output_bytes``: the result's storages that were not arguments;
- ``by_kernel``: each kernel's calls, flops and bytes, from the wrappers'
  hook (``kernels._build.counted``).

Two modes.  ``plain`` counts the ops as they run: on CPU tensors the
wrappers run their plain versions, whose ops count.  ``kernel`` counts each
wrapper call by its kernel's ``Cost`` and sets aside the ops run within it
(the plain version's on CPU or fake tensors, which still runs, so shapes
flow on; the wrapper's own small ops around a launch on the card), and
storages made within a call count from its end, as its outputs: the plain
version's temporaries (an S x S score matrix) are not the kernel's.  The
same hook fires on a real launch, so a step counted on the card and the
same step counted on fake tensors give the same ``flops``, ``bytes`` and
``by_kernel``.  The dry-run counts with ``shapes_only``: the wrappers of
the recurrences skip their plain versions' loops over time, and the
sLSTM's loop over time runs one step, counted as all of them
(``kernels._build.repeated``).  On real CPU tensors, kernel mode counts the
mLSTM's backward as the plain version's autograd ops (the card runs its
backward kernel).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import _build

MODES = ("plain", "kernel")


@dataclass
class Totals:
    flops: float = 0.0
    bytes: float = 0.0
    bytes_raw: float = 0.0
    coll_bytes: float = 0.0
    coll_by_key: dict = field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0
    by_kernel: dict = field(default_factory=dict)


def _tensors(tree) -> list:
    """The tensors of nested tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


class OpCounter(TorchDispatchMode):
    """Counts the ops run under it into ``self.totals`` (see the module's
    docstring).  Enter it inside the ``FakeTensorMode`` of fake inputs."""

    def __init__(self, mode: str = "kernel", shapes_only: bool = False):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if shapes_only and mode != "kernel":
            raise ValueError("shapes_only counts kernels by their cost: kernel mode")
        self.mode = mode
        self.shapes_only = shapes_only
        self.scale = 1.0  # how many like steps the ops run now stand for
        self.totals = Totals()
        self._depth = 0  # kernel calls open (within each other)
        self._live = 0  # bytes of the storages the step made, alive now
        self._held = {}  # id(storage) of those -> bytes
        self._made_within = []  # weakrefs to storages made within a kernel call

    # ------------------------------------------------------------ the mode

    def __enter__(self):
        _build.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.COUNTERS.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self._track(ins, outs)
        if not outs or (self.mode == "kernel" and self._depth):
            return out  # a query of metadata, or an op within a kernel call
        io = self.scale * (sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))
        if not getattr(func, "is_view", False):
            self.totals.bytes_raw += io
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            # the out_dtype overloads (mm.dtype, bmm.dtype) take the dtype
            # positionally, where some formulas have no room for it
            shapes = [a for a in args if not isinstance(a, torch.dtype)]
            self.totals.flops += self.scale * formula(*shapes, **kwargs, out_val=out)
            self.totals.bytes += io
        return out

    # ------------------------------------------------------------- storage

    def _track(self, ins: list, outs: list) -> None:
        """Tally the storages an op made (those of its outputs that no input
        shares: not a view, not an in-place result)."""
        have = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if id(st) in have or id(st) in self._held:
                continue
            have.add(id(st))
            if self.mode == "kernel" and self._depth:
                self._made_within.append(weakref.ref(st))
            else:
                self._hold(st)

    def _hold(self, st) -> None:
        n = st.nbytes()
        self._held[id(st)] = n
        self._live += n
        weakref.finalize(st, self._release, id(st))
        self.totals.peak_bytes = max(self.totals.peak_bytes,
                                     self.totals.argument_bytes + self._live)

    def _release(self, key: int) -> None:
        self._live -= self._held.pop(key, 0)

    # ------------------------------------------------- the wrappers' hook

    def enter_kernel(self, name: str, cost) -> None:
        if self._depth == 0:
            k = self.totals.by_kernel.setdefault(name, {"calls": 0, "flops": 0.0,
                                                        "bytes": 0.0})
            k["calls"] += round(self.scale)
            k["flops"] += self.scale * cost.flops
            k["bytes"] += self.scale * cost.bytes
            if self.mode == "kernel":
                self.totals.flops += self.scale * cost.flops
                self.totals.bytes += self.scale * cost.bytes
                self.totals.bytes_raw += self.scale * cost.bytes
        self._depth += 1

    def exit_kernel(self, name: str) -> None:
        self._depth -= 1
        if self._depth == 0 and self._made_within:
            made, self._made_within = self._made_within, []
            for ref in made:
                st = ref()
                if st is not None and id(st) not in self._held:
                    self._hold(st)

    # ---------------------------------------------------------- collectives

    def collective(self, kind: str, axes: tuple, group_size: int,
                   wire_bytes: float) -> None:
        key = f"{kind}/{','.join(axes)}/g{group_size}"
        self.totals.coll_bytes += wire_bytes
        self.totals.coll_by_key[key] = self.totals.coll_by_key.get(key, 0.0) + wire_bytes


def record_collective(kind: str, axes: tuple, group_size: int, wire_bytes: float) -> None:
    """Report one collective's bytes received by this rank to every counter
    that is counting (``sharding.collectives``)."""
    for counter in _build.COUNTERS:
        counter.collective(kind, tuple(axes), group_size, wire_bytes)


def count(fn, *args, mode: str = "kernel", shapes_only: bool = False, **kwargs) -> tuple:
    """``(fn(*args, **kwargs), Totals)``, counted in ``mode``: the
    arguments' storages are live from the start (``argument_bytes``), and
    ``output_bytes`` are the result's storages that were not arguments.
    ``shapes_only`` (kernel mode on fake tensors, whose values nothing
    reads): the wrappers return their outputs' shapes without running
    their plain versions, and loops of like steps run one
    (``kernels._build.shapes_only``)."""
    counter = OpCounter(mode, shapes_only)
    counter.totals.argument_bytes = _storage_bytes((args, kwargs))
    counter.totals.peak_bytes = counter.totals.argument_bytes
    arg_ids = {id(t.untyped_storage()) for t in _tensors((args, kwargs))}
    with counter:
        result = fn(*args, **kwargs)
    seen = {}
    for t in _tensors(result):
        st = t.untyped_storage()
        if id(st) not in arg_ids:
            seen[id(st)] = st.nbytes()
    counter.totals.output_bytes = sum(seen.values())
    return result, counter.totals
