"""Roofline terms of a counted step: the port's counterpart of
``repro/launch/roofline.py``.

Three terms per (arch x shape x mesh) cell, in seconds, for one card:

  compute    = flops      / peak FLOP/s of the compute dtype
  memory     = bytes      / HBM bandwidth
  collective = coll_bytes / the link between nodes

from the per-rank totals of ``repro_torch.launch.op_analysis`` against the
H100 peaks of ``launch.mesh.HW``.  Every group of the production meshes
spans nodes of eight cards (the 16 ranks of a ``model`` group are two
nodes, a ``data`` or ``pod`` group is one card of each of 16 or 2), so
the collective term takes the link between nodes.
"""

from __future__ import annotations

import torch

from .mesh import HW


def roofline_terms(flops_dev: float, bytes_dev: float, coll_bytes_dev: float,
                   num_devices: int, dtype=torch.bfloat16) -> dict:
    """Per-device totals (one rank's count) -> the three terms, the
    dominant one, and the share of the step that is compute if the
    dominant term hides the others.  The FLOP peak follows ``dtype``, the
    compute dtype (bf16 tensor cores, or the f32 CUDA cores).

    No ``f32_upcast_correction``, as the reference's has: its CPU compile
    widened bf16 to f32, while fake tensors carry the step's own dtypes,
    so the bytes are the card's already.  ``num_devices`` is recorded."""
    peak = HW["peak_flops_bf16"] if dtype == torch.bfloat16 else HW["peak_flops_f32"]
    terms = {
        "flops_per_device": float(flops_dev),
        "bytes_per_device": float(bytes_dev),
        "collective_bytes_per_device": float(coll_bytes_dev),
        "num_devices": num_devices,
        "peak_flops": peak,
        "compute_s": flops_dev / peak,
        "memory_s": bytes_dev / HW["hbm_bw"],
        "collective_s": coll_bytes_dev / HW["internode_bw"],
    }
    dominant = max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    terms["dominant"] = dominant.replace("_s", "")
    total = terms[dominant]
    terms["roofline_fraction_compute"] = terms["compute_s"] / total if total else 0.0
    return terms


def model_flops(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference), N active params."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token each
