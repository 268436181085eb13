"""Checkpoint storage for consistent regions, the port's own copy of
``repro/ckpt/store.py``.

Paper section 6.5: operator checkpoints go to external storage (the
filesystem here), never into CRDs; the CRD records only which checkpoint id
is committed.  The layout is the reference's, byte for byte in what it
hashes:

    <root>/<job>/<region>/step<N>/<shard>.npz         tensor payloads
    <root>/<job>/<region>/step<N>/<shard>.npz.sha256  payload content digest
    <root>/<job>/<region>/step<N>/<shard>.json        scalars/metadata
    <root>/<job>/<region>/step<N>/.committing         commit-in-flight marker

Writes are atomic (tmp + rename).  Checkpoints are incremental: given a
``base_step`` (the last committed step), a shard whose content digest is
unchanged is hard-linked from the base directory instead of rewritten.  The
``.committing`` marker keeps a concurrent sweep off the step the CRD is
mid-commit on.

Where the reference flattens pytrees with ``jax.tree_util``, the port walks
nested dicts, lists and tuples of torch tensors or numpy arrays itself, in
the order ``jax.tree_util`` gives them (dict keys sorted, sequence items by
index, ``None`` an empty subtree) and with the same ``/``-joined keys, so the
digest is the same bytes for the same tree and a shard written by either
package loads in the other.  numpy has no bfloat16, so a bf16 leaf is
refused rather than stored as something else.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

#: Commit-in-flight marker file name (see ``mark_committing``).
COMMITTING_MARKER = ".committing"


def _leaves_with_keys(tree, prefix=()):
    """(path, leaf) pairs of a nested dict/list/tuple tree in
    ``jax.tree_util``'s order: dict keys sorted, sequences by index."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves_with_keys(tree[key], prefix + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _leaves_with_keys(item, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_numpy(key: str, leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"checkpoint leaf {key!r} is bfloat16, which numpy "
                            "cannot hold; save it as float32")
        return leaf.detach().cpu().numpy()
    arr = np.asarray(leaf)
    if str(arr.dtype) == "bfloat16":
        raise TypeError(f"checkpoint leaf {key!r} is bfloat16, which the "
                        "port's store does not write; save it as float32")
    return arr


def _flatten(tree) -> dict:
    return {key: _to_numpy(key, leaf) for key, leaf in _leaves_with_keys(tree)}


def _unflatten(flat: dict, like, prefix=()):
    """``like``'s structure with each leaf taken from ``flat`` by its key:
    a torch leaf becomes a tensor of its dtype on its device, any other a
    numpy array of its dtype, each of its shape."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(flat, v, prefix + (str(k),)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(flat, v, prefix + (str(i),))
                          for i, v in enumerate(like))
    arr = flat["/".join(prefix)]
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(
            device=like.device, dtype=like.dtype).reshape(like.shape)
    ref = np.asarray(like)
    return arr.astype(ref.dtype).reshape(ref.shape)


def _digest(flat: dict) -> str:
    """Content digest of a flattened shard: keys, dtypes, shapes, bytes."""
    h = hashlib.sha256()
    for key in sorted(flat):
        arr = flat[key]
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


class CheckpointStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _dir(self, job: str, region: str, step: int) -> str:
        return os.path.join(self.root, job, region, f"step{step}")

    # -------------------------------------------------------------- write

    def _put(self, d: str, fname: str, data: bytes) -> None:
        """Atomic write: tmp in the same directory, then rename."""
        tmp = os.path.join(d, f".{fname}.tmp")
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, os.path.join(d, fname))

    def _link_from_base(self, base_dir: str, d: str, fname: str) -> bool:
        """Hard-link ``fname`` from the base step dir (atomically, via a tmp
        link + rename so a crashed link never leaves a partial name)."""
        src = os.path.join(base_dir, fname)
        if not os.path.exists(src):
            return False
        tmp = os.path.join(d, f".{fname}.lnk")
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
            os.link(src, tmp)
            os.replace(tmp, os.path.join(d, fname))
            return True
        except OSError:
            return False

    def save_shard(self, job: str, region: str, step: int, shard: str,
                   arrays=None, meta: dict | None = None,
                   base_step: int | None = None) -> str:
        """Write one shard of checkpoint ``step``.

        With ``base_step`` (the last *committed* step, per the CR CRD), the
        write is incremental: the shard's content digest is compared to the
        base step's recorded digest and an unchanged payload is hard-linked
        from the base directory instead of rewritten — dirty-shard diffing,
        so a steady-state checkpoint writes only the shards that changed.
        """
        d = self._dir(job, region, step)
        os.makedirs(d, exist_ok=True)
        base_dir = (self._dir(job, region, base_step)
                    if base_step is not None and base_step >= 0
                    and base_step != step else None)
        if arrays is not None:
            flat = _flatten(arrays)
            digest = _digest(flat)
            linked = False
            if base_dir is not None \
                    and self._read_digest(base_dir, shard) == digest:
                linked = (self._link_from_base(base_dir, d, f"{shard}.npz")
                          and self._link_from_base(base_dir, d,
                                                   f"{shard}.npz.sha256"))
            if not linked:
                tmp = os.path.join(d, f".{shard}.npz.tmp")
                with open(tmp, "wb") as f:
                    np.savez(f, **flat)
                os.replace(tmp, os.path.join(d, f"{shard}.npz"))
                self._put(d, f"{shard}.npz.sha256", digest.encode())
        if meta is not None:
            blob = json.dumps(meta, sort_keys=True).encode()
            linked = False
            if base_dir is not None \
                    and self._read_bytes(base_dir, f"{shard}.json") == blob:
                linked = self._link_from_base(base_dir, d, f"{shard}.json")
            if not linked:
                self._put(d, f"{shard}.json", blob)
        return d

    @staticmethod
    def _read_digest(d: str, shard: str) -> str | None:
        path = os.path.join(d, f"{shard}.npz.sha256")
        try:
            with open(path, "rb") as f:
                return f.read().decode()
        except OSError:
            return None

    @staticmethod
    def _read_bytes(d: str, fname: str) -> bytes | None:
        try:
            with open(os.path.join(d, fname), "rb") as f:
                return f.read()
        except OSError:
            return None

    # --------------------------------------------------------------- read

    def load_shard(self, job: str, region: str, step: int, shard: str,
                   like=None):
        """Returns (arrays-or-unflattened, meta).  With ``like`` (a tree of
        torch tensors or numpy arrays), the arrays are rebuilt into its
        structure: each leaf in ``like``'s leaf's dtype and shape, and a
        torch leaf on its device."""
        d = self._dir(job, region, step)
        arrays = None
        npz_path = os.path.join(d, f"{shard}.npz")
        if os.path.exists(npz_path):
            with np.load(npz_path) as z:
                flat = {k: z[k] for k in z.files}
            if like is not None:
                arrays = _unflatten(flat, like)
            else:
                arrays = flat
        meta = None
        json_path = os.path.join(d, f"{shard}.json")
        if os.path.exists(json_path):
            with open(json_path) as f:
                meta = json.load(f)
        return arrays, meta

    def load_shard_at_or_before(self, job: str, region: str, step: int,
                                shard: str, like=None):
        """Load ``shard`` at ``step``, falling back to the newest older step
        that has it (a warm standby restored mid-commit, or a shard whose
        writer missed a barrier).  Returns ``(found_step, arrays, meta)``;
        ``(None, None, None)`` when no step at or below ``step`` has it."""
        for s in sorted((x for x in self.steps(job, region) if x <= step),
                        reverse=True):
            if self.has_shard(job, region, s, shard):
                arrays, meta = self.load_shard(job, region, s, shard,
                                               like=like)
                return s, arrays, meta
        return None, None, None

    def has_shard(self, job: str, region: str, step: int, shard: str) -> bool:
        d = self._dir(job, region, step)
        return (os.path.exists(os.path.join(d, f"{shard}.npz"))
                or os.path.exists(os.path.join(d, f"{shard}.json")))

    def steps(self, job: str, region: str) -> list:
        """Step ids present on disk for one region, ascending."""
        base = os.path.join(self.root, job, region)
        if not os.path.isdir(base):
            return []
        out = []
        for name in os.listdir(base):
            if name.startswith("step"):
                try:
                    out.append(int(name[4:]))
                except ValueError:
                    continue
        return sorted(out)

    # ------------------------------------------------------------- commit

    def mark_committing(self, job: str, region: str, step: int) -> None:
        """Stamp the commit-in-flight marker.  Called BEFORE the CRD status
        write: a concurrent sweep must never delete the step the CRD is
        mid-commit on."""
        d = self._dir(job, region, step)
        os.makedirs(d, exist_ok=True)
        self._put(d, COMMITTING_MARKER, b"")

    def clear_committing(self, job: str, region: str, step: int) -> None:
        """Drop the marker once the CRD write landed (idempotent)."""
        try:
            os.remove(os.path.join(self._dir(job, region, step),
                                   COMMITTING_MARKER))
        except OSError:
            pass

    def committing(self, job: str, region: str, step: int) -> bool:
        return os.path.exists(os.path.join(self._dir(job, region, step),
                                           COMMITTING_MARKER))

    def sweep(self, job: str, region: str, committed: int) -> int:
        """Delete strictly-older uncommitted step dirs.

        Only steps *below* ``committed`` are garbage — a newer step may be a
        checkpoint in flight — and a step carrying the ``.committing``
        marker is skipped outright even if older (its CRD write may still
        be racing this sweep).  Run from the failover conductor on commit
        events, not ad hoc from the commit path."""
        base = os.path.join(self.root, job, region)
        removed = 0
        if not os.path.isdir(base):
            return 0
        for name in os.listdir(base):
            if not name.startswith("step"):
                continue
            try:
                step = int(name[4:])
            except ValueError:
                continue
            if step >= committed:
                continue
            if os.path.exists(os.path.join(base, name, COMMITTING_MARKER)):
                continue
            shutil.rmtree(os.path.join(base, name), ignore_errors=True)
            removed += 1
        return removed
