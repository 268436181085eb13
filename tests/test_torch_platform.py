"""The port's trainer PE inside the JAX package's streaming platform.

The wiring stays out of ``src/repro``: a ``PERuntime`` whose
``_run_trainer`` runs ``repro_torch.platform.run_trainer`` is patched over
``repro.platform.cluster.PERuntime`` (the name the cluster builds its PE
runtimes from), and the port's ``CheckpointStore`` over the one the
``Platform`` builds, so every consistent-region checkpoint goes through the
port's store.  The trainers compute on the CPU (``"device": "cpu"`` in the
app config).  The two platform tests are the reference's
``tests/test_platform_e2e.py::test_training_survives_pod_kill_bit_exact``
and ``::test_elastic_training_width_change``, at its sizes and timeouts.

Last, the port's trainer PE is held to the reference's step for step: both
loops run on one width-1 stand-in runtime, the port patched (here, not in
``src``) to the reference's weights and batches.
"""

import hashlib
import threading

import jax
import numpy as np
import pytest
import torch

import repro.platform
from repro.ckpt import CheckpointStore as JaxCheckpointStore
from repro.configs import reduced_config as jax_reduced_config
from repro.core import wait_for
from repro.data import StreamSource as JaxStreamSource
from repro.models import init_params as jax_init_params
from repro.platform import Platform, cluster, crds
from repro_torch.ckpt import CheckpointStore
from repro_torch.convert import params_from_numpy
from repro_torch.platform import run_trainer
from repro_torch.platform import trainer as trainer_mod


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


# ------------------------------------------- against the reference's trainer PE

# each step's loss against the reference's (tests/test_torch_train.py)
STEP_LOSS_TOL = 1e-3


class _WidthOneCollective:
    """The fabric's ``allreduce_mean`` for one rank: its own f32 arrays."""

    epoch = 0

    def allreduce_mean(self, key, value, epoch, timeout=30.0, rank=0):
        return [np.asarray(a, dtype=np.float32) for a in value]


class _StandInRest:
    """The control plane as a trainer sees it: a consistent region that
    commits each checkpoint as soon as it is notified."""

    def __init__(self, ckpt):
        self.ckpt, self.committed, self.metrics, self.done = ckpt, -1, [], False

    def get_cr_state(self, job, region):
        return {"lastCommitted": self.committed}

    def notify_checkpoint(self, job, region, pe_id, step):
        self.committed = step

    def report_metrics(self, job, pe_id, metrics):
        self.metrics.append(metrics)

    def notify_source_done(self, job, pe_id):
        self.done = True


class _StandInRuntime:
    """The PE runtime's surface that both trainer loops use, for one trainer
    channel of width 1."""

    def __init__(self, app, interval, ckpt):
        self.job, self.pe_id, self._drain, self.emitted = "probe", 0, None, []
        self.meta = {"operators": [{"name": "trainer", "kind": "trainer", "channel": 0,
                                    "config": app}],
                     "widths": {"dp": 1},
                     "consistentRegion": {"name": "dp", "interval": interval}}
        self.rest, self.stop_event = _StandInRest(ckpt), threading.Event()
        self.fabric = type("Fabric", (), {"collective": staticmethod(
            lambda job, region, width: _WidthOneCollective())})()

    def _cr(self):
        return self.meta["consistentRegion"]

    def _emit(self, port, item, partition=None):
        self.emitted.append(item)

    def _flush_all(self):
        pass

    def load_metrics(self, extra=None):
        return dict(extra or {})


class _ReferenceBatches:
    """The reference's lcg stream, as the port's trainer reads a source."""

    def __init__(self, vocab_size, batch, seq_len, seed, mode, **_frontend):
        self.src = JaxStreamSource(vocab_size=vocab_size, batch=batch, seq_len=seq_len,
                                   seed=seed, mode=mode)

    def batch_at(self, offset):
        return {k: torch.from_numpy(np.array(v)) for k, v in self.src.batch_at(offset).items()}


@pytest.mark.parametrize("arch", ["gemma-2b", "xlstm-125m", "deepseek-moe-16b"])
def test_trainer_pe_matches_reference_trainer(arch, tmp_path, monkeypatch):
    """6 steps of 2 x 32 tokens with checkpoints every 3: the reference's
    ``PERuntime._run_trainer`` and the port's ``run_trainer`` on the same
    stand-in runtime, the port on the reference's weights
    (``jax.random.key(7)``) and batches; every step's loss within 1e-3, and
    both commit the same checkpoints."""
    app = {"arch": arch, "steps": 6, "batch_per_shard": 2, "seq_len": 32, "lr": 1e-3,
           "device": "cpu"}
    ref = _StandInRuntime(app, 3, JaxCheckpointStore(str(tmp_path / "ref")))
    cluster.PERuntime._run_trainer(ref)

    jax_cfg = jax_reduced_config(arch)
    monkeypatch.setattr(trainer_mod, "init_params", lambda cfg, seed, device: params_from_numpy(
        jax_init_params(jax.random.key(seed), jax_cfg), device=device))
    monkeypatch.setattr(trainer_mod, "StreamSource", _ReferenceBatches)
    port = _StandInRuntime(app, 3, CheckpointStore(str(tmp_path / "port")))
    run_trainer(port)

    for rt in (ref, port):
        assert [m["step"] for m in rt.rest.metrics] == list(range(1, 7))
        assert rt.rest.done and rt.rest.committed == 6
    assert [x["step"] for x in port.emitted] == [x["step"] for x in ref.emitted]
    for got, want in zip(port.emitted, ref.emitted):
        assert abs(got["loss"] - want["loss"]) < STEP_LOSS_TOL, (got, want)
