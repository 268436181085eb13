"""The port's launchers, ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``: each runs end to end on the CPU when
asked to (the trainer also on a mesh of gloo ranks), refuses to start
without a card otherwise, and says what is not ported yet
(``--platform``)."""

import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import serve, train

ROOT = Path(__file__).resolve().parents[1]


def test_serve_smoke_on_cpu(capsys):
    serve.main(["--arch", "gemma-2b", "--smoke", "--requests", "5",
                "--slots", "2", "--max-new", "4", "--max-len", "16",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "on cpu" in out
    assert "5 requests, 20 tokens" in out


@pytest.mark.parametrize("arch", ["xlstm-125m", "recurrentgemma-9b"])
def test_serve_recurrent_smoke_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--requests", "3", "--slots", "2",
                "--max-new", "4", "--max-len", "16", "--device", "cpu"])
    assert "3 requests, 12 tokens" in capsys.readouterr().out


def test_serve_module_runs_as_a_script():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-14b", "--smoke", "--requests", "3", "--max-new", "2",
         "--device", "cpu"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "3 requests, 6 tokens" in proc.stdout


def test_serve_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        serve.main(["--arch", "gemma-2b", "--smoke"])


def test_platform_flag_is_not_ported_yet():
    with pytest.raises(NotImplementedError):
        serve.main(["--arch", "gemma-2b", "--smoke", "--platform",
                    "--device", "cpu"])


def test_train_module_runs_as_a_script():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gemma-2b", "--smoke", "--steps", "2", "--device", "cpu"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [l for l in proc.stdout.splitlines() if l.startswith("step ")]
    assert len(lines) == 2 and "loss" in lines[0] and "gnorm" in lines[0]


def test_train_main_returns_the_step_records(capsys):
    records = train.main(["--arch", "qwen3-14b", "--smoke", "--steps", "3",
                          "--batch", "4", "--seq", "16", "--accum", "2",
                          "--device", "cpu"])
    assert [r["step"] for r in records] == [0, 1, 2]
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               and r["wall_s"] > 0 for r in records)
    assert "on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-125m"])
def test_train_recurrent_families_on_cpu(arch, capsys):
    """The recurrent families train through the launcher on the default
    kernel path (on the CPU the backward kernels' plain versions), 2 x 128
    tokens: past the reduced window of 64, one mLSTM chunk."""
    records = train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
                          "--seq", "128", "--device", "cpu"])
    assert [r["step"] for r in records] == [0, 1]
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               and r["grad_norm"] > 0 for r in records)
    assert "on cpu" in capsys.readouterr().out


def test_train_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        train.main(["--arch", "gemma-2b", "--smoke", "--steps", "1"])


@pytest.mark.parametrize("flag", [["--platform"]])
def test_train_mesh_and_platform_are_not_ported_yet(flag):
    with pytest.raises(NotImplementedError):
        train.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu", *flag])


def _step_losses(*flags) -> list:
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-14b",
         "--smoke", "--steps", "2", "--batch", "8", "--seq", "32", "--device", "cpu",
         *flags],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [float(l.split()[3]) for l in proc.stdout.splitlines() if l.startswith("step ")]


def test_train_mesh_world_matches_one_device():
    """``--mesh 2,2,2`` without torchrun: the launcher starts 8 gloo ranks
    itself, and rank 0's losses are within 1e-3 of the same command
    without a mesh (the bound of tests/test_sharding_multi.py:77)."""
    plain, mesh = _step_losses(), _step_losses("--mesh", "2,2,2")
    assert len(plain) == len(mesh) == 2
    assert all(abs(a - b) < 1e-3 for a, b in zip(plain, mesh)), (plain, mesh)


def test_train_mesh_of_one_rank_runs_in_process(capsys):
    """A world of one rank runs in the launcher's own process (a gloo group
    on a free local port, ended after the run) and gives the one-device
    records' numbers."""
    argv = ["--arch", "gemma-2b", "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "16", "--device", "cpu"]
    plain = train.main(argv)
    mesh = train.main(argv + ["--mesh", "1,1,1"])
    assert not torch.distributed.is_initialized()
    assert [(r["loss"], r["grad_norm"]) for r in mesh] == \
        [(r["loss"], r["grad_norm"]) for r in plain]
    assert "mesh {'pod': 1, 'data': 1, 'model': 1}" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen2-moe-a2.7b",
                                  "musicgen-large", "internvl2-26b"])
def test_moe_and_frontend_families_serve_and_train_on_cpu(arch, capsys):
    """The MoE and frontend families through both launchers (the frontend
    families serve tokens only and train on the stream's frontend
    embeddings)."""
    serve.main(["--arch", arch, "--smoke", "--requests", "3", "--slots", "2",
                "--max-new", "4", "--max-len", "16", "--device", "cpu"])
    assert "3 requests, 12 tokens" in capsys.readouterr().out
    records = train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
                          "--seq", "32", "--device", "cpu"])
    assert len(records) == 2 and all(math.isfinite(r["loss"]) for r in records)
