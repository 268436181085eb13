"""Multi-pod dry-run: count every (arch x shape x mesh) cell on fake tensors,
the port's counterpart of ``repro/launch/dryrun.py``.

For the single-pod (16, 16) and multi-pod (2, 16, 16) production meshes,
every applicable cell's step runs once as rank 0, on fake CPU tensors
(nothing is drawn or allocated, and no card is needed), under the op
counter of ``launch.op_analysis``; the record holds its FLOPs, bytes,
collective bytes and memory per device against the H100 roofline of
``launch.roofline``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k \
      --both-meshes --sequence-parallel   # or --shard-cache-seq, --tree-attention

Each record: ``status`` (``ok``; ``skipped`` with the reference's reason;
``error`` with its trace), ``kind``, ``tokens``, ``batch_axes``, ``rows``
(this rank's), ``model_axis``, ``memory`` (argument, output and peak bytes
per device, and ``fits`` against the card's 80 GB), ``collectives`` (bytes
received by key), ``roofline`` (with ``model_flops`` and
``model_vs_counted_flops``), ``by_kernel`` and ``count_s``, the count's
wall in place of the reference's ``lower_s`` / ``compile_s``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from .cells import CellOptions, build_cell, run_step, token_count
from .mesh import HW, abstract_mesh, production_mesh_shape
from .roofline import model_flops, roofline_terms


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             opts: CellOptions = CellOptions(), verbose: bool = True) -> dict:
    """Count one cell; return its record (or its skip or error)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "params": cfg.param_count(), "active_params": cfg.active_param_count()}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    mesh = abstract_mesh(*production_mesh_shape(multi_pod))
    t0 = time.time()
    try:
        cell = build_cell(arch, shape_name, mesh, opts)
        _, totals = run_step(cell)
        count_s = time.time() - t0
        terms = roofline_terms(totals.flops, totals.bytes, totals.coll_bytes,
                               mesh.world_size, opts.model.dtype)
        mf = model_flops(cfg, shape, cell.kind)
        counted = terms["flops_per_device"] * mesh.world_size
        terms["model_flops"] = mf
        terms["model_vs_counted_flops"] = mf / counted if counted else 0.0
        rec.update(
            status="ok",
            kind=cell.kind,
            tokens=token_count(cfg, shape),
            batch_axes=list(cell.meta["batch_axes"]),
            rows=cell.meta["rows"],
            model_axis=cell.meta["model_axis"],
            count_s=round(count_s, 1),
            memory={
                "argument_bytes": totals.argument_bytes,
                "output_bytes": totals.output_bytes,
                "peak_bytes": totals.peak_bytes,
                "fits": totals.peak_bytes <= HW["hbm_bytes"],
            },
            collectives=totals.coll_by_key,
            bytes_raw=totals.bytes_raw,
            by_kernel=totals.by_kernel,
            roofline=terms,
        )
        if verbose:
            print(f"[dryrun] {arch} {shape_name} {mesh_name}: OK count={count_s:.1f}s "
                  f"compute={terms['compute_s'] * 1e3:.2f}ms "
                  f"memory={terms['memory_s'] * 1e3:.2f}ms "
                  f"collective={terms['collective_s'] * 1e3:.2f}ms "
                  f"dominant={terms['dominant']} "
                  f"peak={totals.peak_bytes / 1e9:.1f}GB "
                  f"useful={terms['model_vs_counted_flops']:.3f}")
    except Exception as exc:  # noqa: BLE001 - record the failure, keep going
        rec.update(status="error", error=repr(exc),
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[dryrun] {arch} {shape_name} {mesh_name}: FAIL {exc!r}")
    return rec


def all_cells(multi_pod_values=(False, True)):
    for arch in ARCH_IDS:
        for shape_name in SHAPES:
            for mp in multi_pod_values:
                yield arch, shape_name, mp


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true", help="use the 2x16x16 mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--append", action="store_true")
    ap.add_argument("--tree-attention", action="store_true")
    ap.add_argument("--sequence-parallel", action="store_true")
    ap.add_argument("--shard-cache-seq", action="store_true")
    ap.add_argument("--moe-impl", default=None, choices=(None, "einsum", "sort"))
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--dp-layout", action="store_true")
    args = ap.parse_args(argv)

    from ..models.lm import ModelOptions
    from ..train.step import TrainConfig

    opts = CellOptions(model=ModelOptions(tree_attention=args.tree_attention,
                                          moe_impl=args.moe_impl),
                       train=TrainConfig(compress_pod_grads=args.compress_pod_grads),
                       sequence_parallel=args.sequence_parallel,
                       shard_cache_seq=args.shard_cache_seq,
                       dp_layout=args.dp_layout)
    records = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            records = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in records
            if r.get("status") in ("ok", "skipped")}

    meshes = (False, True) if args.both_meshes else (args.multipod,)
    if args.all:
        cells = list(all_cells(meshes))
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape, mp) for mp in meshes]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for arch, shape_name, mp in cells:
        mesh_name = "pod2x16x16" if mp else "pod16x16"
        if (arch, shape_name, mesh_name) in done:
            continue
        rec = run_cell(arch, shape_name, multi_pod=mp, opts=opts)
        records = [r for r in records if (r["arch"], r["shape"], r["mesh"])
                   != (rec["arch"], rec["shape"], rec["mesh"])]
        records.append(rec)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    n = {s: sum(1 for r in records if r.get("status") == s)
         for s in ("ok", "skipped", "error")}
    print(f"[dryrun] done: {n['ok']} ok, {n['skipped']} skipped, {n['error']} errors "
          f"-> {args.out}")
    return records


if __name__ == "__main__":
    main()
