"""Device meshes of ``torch.distributed`` ranks, the counterpart of
``repro/launch/mesh.py``.

A mesh lays the world's ranks out row-major over named axes ``("pod",
"data", "model")`` (or the last ones of them) and holds one process group
per axis, plus the group of the batch axes (``pod`` x ``data``): the
groups the mesh train step gathers parameters, sums tensor-parallel
partials and averages gradients over.  A group is made only where it
joins more than one rank; its description names its axes.

The backend follows the device: NCCL on CUDA, gloo on the CPU (or gloo
on CUDA when asked, for ranks that share one card); a CUDA mesh where NCCL
is missing raises.  ``make_mesh`` joins a world already
started (``torch.distributed`` initialized, e.g. by the launcher), or
starts one from ``init_method`` and ``rank``, from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), or, for a
world of one rank, on a free local port; ``Mesh.close`` ends a world the
mesh started.

``abstract_mesh`` is the dry-run's mesh (``repro_torch.launch.cells``): one
rank's view of a mesh of any size whose groups are ``AbstractGroup``
markers, with no process group behind them; the collectives over them
count the bytes they would move (``sharding.collectives``).
``production_mesh_shape`` names the reference's production meshes and
``HW`` the card's peaks that the roofline divides by.
"""

from __future__ import annotations

import itertools
import math
import os
import socket

import torch
import torch.distributed as dist

from typing import NamedTuple

from ..device import resolve_device

AXES = ("pod", "data", "model")
BATCH_AXES = ("pod", "data")

# one NVIDIA H100 SXM5 80GB: the peaks of NVIDIA's H100 Tensor Core GPU
# datasheet (dense, without sparsity), and the links of a DGX H100 node
HW = {
    "peak_flops_bf16": 989e12,  # BF16 tensor cores, FLOP/s (datasheet)
    "peak_flops_f32": 67e12,  # FP32 CUDA cores, FLOP/s (datasheet)
    "hbm_bw": 3.35e12,  # HBM3, B/s (datasheet)
    "hbm_bytes": 80e9,  # HBM3 capacity, B (datasheet)
    "nvlink_bw": 450e9,  # NVLink 4, B/s each way: 900 GB/s both ways (datasheet)
    # the link between nodes, B/s each way: one 400 Gb/s ConnectX-7
    # InfiniBand NDR port a card (DGX H100 user guide)
    "internode_bw": 50e9,
}


def production_mesh_shape(multi_pod: bool = False) -> tuple:
    """The reference's production meshes: (16, 16) over (data, model), or
    (2, 16, 16) over (pod, data, model)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Mesh:
    """This rank's view of the mesh: ``axis_names``, ``shape`` (axis ->
    size), ``coords`` (axis -> this rank's index), ``rank``, ``device``,
    and ``group(axes)``, the process group of the ranks that differ from
    this one only along ``axes`` (None where that is one rank)."""

    def __init__(self, shape: tuple, axes: tuple, rank: int, device: torch.device,
                 owns_world: bool):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))
        self.rank, self.device, self._owns_world = rank, device, owns_world
        self.world_size = math.prod(shape)
        idx, self.coords = rank, {}
        for a in reversed(axes):
            self.coords[a] = idx % self.shape[a]
            idx //= self.shape[a]
        self._groups = {}
        batch = tuple(a for a in BATCH_AXES if a in axes)
        for key in [(a,) for a in axes] + ([batch] if len(batch) > 1 else []):
            self._make_groups(key)

    def _make_groups(self, key: tuple) -> None:
        """Every group along ``key`` (each rank must make all of them, in
        the same order); keep the one this rank is in."""
        if self.size(key) == 1:
            return
        others = [a for a in self.axis_names if a not in key]
        for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
            at = dict(zip(others, fixed))
            ranks = []
            for moving in itertools.product(*(range(self.shape[a]) for a in key)):
                at.update(zip(key, moving))
                ranks.append(self._rank_at(at))
            # the description names the axes, for the collectives' byte counts
            group = dist.new_group(ranks, group_desc=",".join(key))
            if self.rank in ranks:
                self._groups[key] = group

    def _rank_at(self, coords: dict) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def size(self, axes: tuple) -> int:
        """The ranks along ``axes``; an axis the mesh lacks counts as one."""
        return math.prod(self.shape.get(a, 1) for a in axes)

    def index(self, axes: tuple) -> int:
        """This rank's block index over ``axes``, the first axis major."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes: tuple):
        return self._groups.get(tuple(axes)) if self.size(axes) > 1 else None

    def close(self) -> None:
        """End the world, if this mesh started it."""
        if self._owns_world and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_world = False


class AbstractGroup(NamedTuple):
    """The group of the ``size`` ranks along ``axes`` in an abstract mesh: a
    marker, with no process group behind it."""

    axes: tuple
    size: int


class AbstractMesh(Mesh):
    """A ``Mesh`` on the CPU whose groups are ``AbstractGroup`` markers,
    over any axes; it starts and joins no world."""

    def _make_groups(self, key: tuple) -> None:
        pass

    def group(self, axes: tuple):
        axes = tuple(axes)
        return AbstractGroup(axes, self.size(axes)) if self.size(axes) > 1 else None


def abstract_mesh(shape, axes=None, rank: int = 0) -> AbstractMesh:
    """Rank ``rank``'s view of a mesh of ``prod(shape)`` ranks (axes as in
    ``make_mesh``), for counting a step without running its world."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes) if axes is not None else AXES[-len(shape):]
    if len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    return AbstractMesh(shape, axes, rank, torch.device("cpu"), owns_world=False)


def make_mesh(shape, axes=None, *, device=None, init_method=None,
              rank=None, backend=None) -> Mesh:
    """A mesh of ``prod(shape)`` ranks on ``device`` (CUDA unless the caller
    asks for the CPU).  ``axes`` default to the last ``len(shape)`` of
    ``("pod", "data", "model")``, as the reference's launcher names them.
    ``backend`` defaults to the device's (NCCL on CUDA, gloo on the CPU);
    ``"gloo"`` on CUDA lets several ranks share one card, which NCCL
    refuses."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes) if axes is not None else AXES[-len(shape):]
    if len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    elif backend not in ("nccl", "gloo") or (backend == "nccl" and dev.type != "cuda"):
        raise ValueError(f"backend {backend!r} on {dev.type}: NCCL needs CUDA, or gloo")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("a CUDA mesh needs NCCL, which this torch lacks")
    world = math.prod(shape)
    owns = not dist.is_initialized()
    if owns:
        if init_method is None and "RANK" in os.environ:
            init_method, rank = "env://", int(os.environ["RANK"])
        elif init_method is None and world == 1:
            init_method, rank = f"tcp://127.0.0.1:{free_port()}", 0
        elif init_method is None or rank is None:
            raise ValueError(f"a world of {world} ranks needs init_method and rank, "
                             "or torchrun's environment")
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
    elif dist.get_backend() != backend or dist.get_world_size() != world:
        raise ValueError(f"the running world ({dist.get_backend()}, "
                         f"{dist.get_world_size()} ranks) is not a {backend} "
                         f"mesh of {world}")
    rank = dist.get_rank()
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    mesh = Mesh(shape, axes, rank, dev, owns)
    # one collective over the world, so a broken transport fails here
    dist.all_reduce(torch.zeros(1, device=dev))
    return mesh


def make_smoke_mesh(shape=(2, 2, 2), axes=("pod", "data", "model"), **kw) -> Mesh:
    """Small mesh for real (executing) multi-rank tests on the CPU's gloo."""
    return make_mesh(shape, axes, **kw)
