"""The port's trainer PE inside the JAX package's streaming platform.

The wiring stays out of ``src/repro``: a ``PERuntime`` whose
``_run_trainer`` runs ``repro_torch.platform.run_trainer`` is patched over
``repro.platform.cluster.PERuntime`` (the name the cluster builds its PE
runtimes from), and the port's ``CheckpointStore`` over the one the
``Platform`` builds, so every consistent-region checkpoint goes through the
port's store.  The trainers compute on the CPU (``"device": "cpu"`` in the
app config).  The two tests are the reference's
``tests/test_platform_e2e.py::test_training_survives_pod_kill_bit_exact``
and ``::test_elastic_training_width_change``, at its sizes and timeouts.
"""

import hashlib

import numpy as np
import pytest

import repro.platform
from repro.core import wait_for
from repro.platform import Platform, cluster, crds
from repro_torch.ckpt import CheckpointStore
from repro_torch.platform import run_trainer


class TorchTrainerRuntime(cluster.PERuntime):
    """A PE runtime whose trainer PEs run the port's loop."""

    def _run_trainer(self) -> None:
        run_trainer(self)


@pytest.fixture
def wired(monkeypatch):
    monkeypatch.setattr(cluster, "PERuntime", TorchTrainerRuntime)
    monkeypatch.setattr(repro.platform, "CheckpointStore", CheckpointStore)


@pytest.fixture
def platform(wired, tmp_path):
    p = Platform(num_nodes=4, ckpt_root=str(tmp_path / "ckpt"))
    yield p
    p.shutdown()


TRAIN_SPEC = {
    "app": {"type": "train", "arch": "gemma-2b", "data_parallel": 2,
            "steps": 30, "batch_per_shard": 2, "seq_len": 32, "lr": 1e-3,
            "device": "cpu"},
    "consistentRegion": {"name": "dp", "interval": 10},
}


def _final_params_hash(p, job):
    st = p.rest.get_cr_state(job, "dp")
    payload, meta = p.ckpt.load_shard(job, "dp", st["lastCommitted"], "params")
    digest = hashlib.sha256()
    for key in sorted(payload):  # the reference's leaf order
        digest.update(np.asarray(payload[key]).tobytes())
    return meta["step"], digest.hexdigest()


def test_wiring_runs_the_port(platform):
    assert isinstance(platform.ckpt, CheckpointStore)
    assert cluster.PERuntime is TorchTrainerRuntime


def test_training_survives_pod_kill_bit_exact(platform, tmp_path):
    """Kill a trainer mid-run; the recovered run must end at the same
    checkpoint bytes as an uninterrupted one (replay from the committed
    checkpoint; batches recomputed from (seed, step))."""
    p = platform
    p.submit("t1", TRAIN_SPEC)
    assert p.wait_submitted("t1", 30)
    assert p.wait_cr_committed("t1", "dp", 10, 180)
    trainer_pes = [x.spec["peId"] for x in p.store.list(crds.PE, "default")
                   if "trainer" in str(x.spec.get("operators"))]
    assert p.kill_pod("t1", trainer_pes[0])
    assert p.wait_cr_committed("t1", "dp", 30, 300)
    step1, h1 = _final_params_hash(p, "t1")

    p2 = Platform(num_nodes=4, ckpt_root=str(tmp_path / "ckpt2"))
    try:
        p2.submit("t1", TRAIN_SPEC)
        assert p2.wait_cr_committed("t1", "dp", 30, 300)
        step2, h2 = _final_params_hash(p2, "t1")
    finally:
        p2.delete_job("t1")
        p2.wait_terminated("t1", 20)
        p2.shutdown()
    assert step1 == step2 == 30
    assert h1 == h2  # bit-exact recovery


def test_elastic_training_width_change(platform):
    """Change the data-parallel width mid-run: the trainers restart, reload
    the committed checkpoint and go on at the new width."""
    p = platform
    spec = {
        "app": {"type": "train", "arch": "gemma-2b", "data_parallel": 2,
                "steps": 40, "batch_per_shard": 2, "seq_len": 32, "lr": 1e-3,
                "device": "cpu"},
        "consistentRegion": {"name": "dp", "interval": 10},
    }
    p.submit("et", spec)
    assert p.wait_submitted("et", 30)
    assert p.wait_cr_committed("et", "dp", 10, 240)
    n0 = len(p.pods("et"))
    p.set_width("et", "dp", 3)
    assert wait_for(lambda: len(p.pods("et")) == n0 + 1, 60)
    assert p.wait_cr_committed("et", "dp", 30, 300)
    assert len([x for x in p.store.list(crds.PE, "default")
                if "trainer" in str(x.spec.get("operators"))]) == 3
    st = p.rest.get_cr_state("et", "dp")
    assert st["lastCommitted"] >= 30
