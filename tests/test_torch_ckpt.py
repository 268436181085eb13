"""The port's checkpoint store (``repro_torch.ckpt``) against the
reference's (``repro.ckpt``): the reference store's behaviours on torch
trees, and shards that cross between the two packages bit for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointStore as JaxStore
from repro.configs import reduced_config as jax_reduced_config
from repro.models import init_params as jax_init_params
from repro_torch.ckpt import CheckpointStore
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.train.optim import leaves


def test_ckpt_roundtrip_and_sweep(tmp_path):
    store = CheckpointStore(str(tmp_path))
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32)}}
    store.save_shard("job", "r", 10, "params", arrays=tree, meta={"step": 10})
    store.save_shard("job", "r", 20, "params", arrays=tree, meta={"step": 20})
    got, meta = store.load_shard("job", "r", 10, "params", like=tree)
    assert torch.equal(got["a"], tree["a"]) and torch.equal(got["b"]["c"], tree["b"]["c"])
    assert meta == {"step": 10}
    assert store.sweep("job", "r", committed=20) == 1
    assert not store.has_shard("job", "r", 10, "params")
    assert store.has_shard("job", "r", 20, "params")


def test_ckpt_atomic_tmp_rename(tmp_path):
    """No tmp residue after a save; a stale tmp of a crashed writer is
    overwritten by the next save."""
    store = CheckpointStore(str(tmp_path))
    tree = {"w": torch.zeros(3)}
    d = store.save_shard("job", "r", 1, "params", arrays=tree, meta={"step": 1})
    names = os.listdir(d)
    assert not any(n.endswith(".tmp") for n in names), names
    assert "params.npz" in names and "params.json" in names
    with open(os.path.join(d, ".params.npz.tmp"), "wb") as f:
        f.write(b"partial garbage")
    store.save_shard("job", "r", 1, "params", arrays=tree, meta={"step": 1})
    got, meta = store.load_shard("job", "r", 1, "params", like=tree)
    assert torch.equal(got["w"], tree["w"]) and meta == {"step": 1}


def test_ckpt_incremental_diff_links_clean_shards(tmp_path):
    """Against ``base_step`` an unchanged shard is hard-linked (one inode)
    and a changed one rewritten."""
    store = CheckpointStore(str(tmp_path))
    clean = {"w": torch.arange(4, dtype=torch.float32)}
    dirty0, dirty1 = {"s": torch.zeros(2)}, {"s": torch.ones(2)}
    store.save_shard("job", "r", 10, "clean", arrays=clean, meta={"step": 10})
    store.save_shard("job", "r", 10, "dirty", arrays=dirty0)
    store.save_shard("job", "r", 20, "clean", arrays=clean, meta={"step": 10},
                     base_step=10)
    store.save_shard("job", "r", 20, "dirty", arrays=dirty1, base_step=10)
    base, cur = store._dir("job", "r", 10), store._dir("job", "r", 20)
    st_base = os.stat(os.path.join(base, "clean.npz"))
    st_cur = os.stat(os.path.join(cur, "clean.npz"))
    assert st_base.st_ino == st_cur.st_ino and st_cur.st_nlink >= 2
    assert (os.stat(os.path.join(base, "clean.json")).st_ino
            == os.stat(os.path.join(cur, "clean.json")).st_ino)
    assert (os.stat(os.path.join(base, "dirty.npz")).st_ino
            != os.stat(os.path.join(cur, "dirty.npz")).st_ino)
    got, _ = store.load_shard("job", "r", 20, "dirty", like=dirty1)
    assert torch.equal(got["s"], dirty1["s"])
    got, meta = store.load_shard("job", "r", 20, "clean", like=clean)
    assert torch.equal(got["w"], clean["w"]) and meta == {"step": 10}


def test_ckpt_load_at_older_step_fallback(tmp_path):
    store = CheckpointStore(str(tmp_path))
    tree = {"w": torch.arange(3, dtype=torch.float32)}
    store.save_shard("job", "r", 5, "pe1", arrays=tree, meta={"offset": 5})
    store.save_shard("job", "r", 9, "other", meta={"offset": 9})
    step, got, meta = store.load_shard_at_or_before("job", "r", 9, "pe1", like=tree)
    assert step == 5 and torch.equal(got["w"], tree["w"]) and meta == {"offset": 5}
    assert store.load_shard_at_or_before("job", "r", 4, "pe1") == (None, None, None)


def test_ckpt_sweep_spares_committing_and_newer_steps(tmp_path):
    store = CheckpointStore(str(tmp_path))
    for step in (10, 20, 30, 40):
        store.save_shard("job", "r", step, "params", meta={"step": step})
    store.mark_committing("job", "r", 20)
    assert store.committing("job", "r", 20)
    assert store.sweep("job", "r", committed=30) == 1
    assert store.steps("job", "r") == [20, 30, 40]
    store.clear_committing("job", "r", 20)
    assert not store.committing("job", "r", 20)
    assert store.sweep("job", "r", committed=30) == 1
    assert store.steps("job", "r") == [30, 40]


def test_ckpt_torch_tree_roundtrip_with_scalar_meta(tmp_path):
    """Mixed-dtype trees of tensors and numpy arrays (dicts, lists, 0-dim
    leaves) round-trip bit-exact beside scalar metadata; ``like`` gives each
    leaf its type, dtype and shape."""
    store = CheckpointStore(str(tmp_path))
    tree = {"params": {"dense": torch.linspace(0, 1, 12).reshape(3, 4),
                       "bias": torch.tensor([-1, 0, 7], dtype=torch.int32)},
            "opt": [torch.full((2, 2), 0.5), np.array(3, np.int32)]}
    meta = {"step": 42, "loss": 0.125, "clean": True, "tag": "warm"}
    store.save_shard("job", "r", 42, "state", arrays=tree, meta=meta)
    got, got_meta = store.load_shard("job", "r", 42, "state", like=tree)
    assert got_meta == meta
    assert isinstance(got["opt"], list) and isinstance(got["opt"][1], np.ndarray)
    for a, b in ((got["params"]["dense"], tree["params"]["dense"]),
                 (got["params"]["bias"], tree["params"]["bias"]),
                 (got["opt"][0], tree["opt"][0])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got["opt"][1].dtype == np.int32 and got["opt"][1] == 3
    flat, _ = store.load_shard("job", "r", 42, "state")
    assert sorted(flat) == ["opt/0", "opt/1", "params/bias", "params/dense"]


def test_ckpt_refuses_bfloat16(tmp_path):
    store = CheckpointStore(str(tmp_path))
    with pytest.raises(TypeError, match="params/w"):
        store.save_shard("job", "r", 1, "s",
                         arrays={"params": {"w": torch.zeros(2, dtype=torch.bfloat16)}})
    assert not store.has_shard("job", "r", 1, "s")


def _reference_state(seed: int = 0):
    """The reference's train state of reduced gemma-2b as numpy, with
    moments that are not zero."""
    cfg = jax_reduced_config("gemma-2b")
    params = jax_init_params(jax.random.key(seed), cfg)
    opt = {"m": jax.tree.map(lambda p: p * 0.5, params),
           "v": jax.tree.map(lambda p: p * p, params)}
    as_np = jax.tree.map(np.asarray, {"params": params, "opt": opt})
    return {**as_np, "step": np.asarray(7, np.int32)}


def test_ckpt_crosses_packages_bit_for_bit(tmp_path):
    """A shard saved by the reference store from
    ``convert.train_state_to_numpy`` loads in the port, and one saved by the
    port loads in the reference, leaf for leaf bit for bit; the same tree
    gets the same ``.sha256`` digest in both."""
    state = train_state_from_numpy(_reference_state(), device="cpu")
    payload = train_state_to_numpy(state)
    jstore, tstore = JaxStore(str(tmp_path / "jax")), CheckpointStore(str(tmp_path / "torch"))
    jstore.save_shard("job", "dp", 10, "params", arrays=payload, meta={"step": 10})
    tstore.save_shard("job", "dp", 10, "params", arrays=payload, meta={"step": 10})
    digest = {name: open(os.path.join(s._dir("job", "dp", 10), "params.npz.sha256")).read()
              for name, s in (("jax", jstore), ("torch", tstore))}
    assert digest["jax"] == digest["torch"]
    like = {"params": state["params"], "opt": state["opt"], "step": state["step"]}
    # reference -> port, as torch tensors shaped like the port's state
    tstore_on_jax = CheckpointStore(str(tmp_path / "jax"))
    got, meta = tstore_on_jax.load_shard("job", "dp", 10, "params", like=like)
    assert meta == {"step": 10}
    for a, b in zip(leaves(got), leaves(like)):
        assert a.dtype == b.dtype and torch.equal(a, b.detach())
    # port -> reference, as numpy shaped like the reference's tree
    jstore_on_torch = JaxStore(str(tmp_path / "torch"))
    jgot, _ = jstore_on_torch.load_shard("job", "dp", 10, "params", like=payload)
    for a, b in zip(jax.tree.leaves(jgot), jax.tree.leaves(payload)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_ckpt_incremental_save_links_across_packages(tmp_path, first):
    """An incremental save by one package against a base written by the
    other links the clean shard (one inode) and rewrites the dirty one."""
    stores = {"jax": JaxStore(str(tmp_path)), "torch": CheckpointStore(str(tmp_path))}
    second = "torch" if first == "jax" else "jax"
    clean = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
             "b": [np.ones(2, np.int32), np.zeros((), np.float32)]}
    stores[first].save_shard("job", "r", 10, "clean", arrays=clean, meta={"step": 10})
    stores[first].save_shard("job", "r", 10, "dirty", arrays={"s": np.zeros(2, np.float32)})
    as_torch = {"w": torch.from_numpy(clean["w"]),
                "b": [torch.from_numpy(clean["b"][0]), torch.zeros(())]}
    tree = as_torch if second == "torch" else {
        "w": jnp.asarray(clean["w"]), "b": [jnp.asarray(x) for x in clean["b"]]}
    stores[second].save_shard("job", "r", 20, "clean", arrays=tree, meta={"step": 10},
                              base_step=10)
    stores[second].save_shard("job", "r", 20, "dirty", arrays={"s": np.ones(2, np.float32)},
                              base_step=10)
    base, cur = stores["jax"]._dir("job", "r", 10), stores["jax"]._dir("job", "r", 20)
    for name in ("clean.npz", "clean.npz.sha256", "clean.json"):
        assert os.stat(os.path.join(base, name)).st_ino == os.stat(os.path.join(cur, name)).st_ino
    assert (os.stat(os.path.join(base, "dirty.npz")).st_ino
            != os.stat(os.path.join(cur, "dirty.npz")).st_ino)
