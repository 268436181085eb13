"""The port's serving launcher, ``python -m repro_torch.launch.serve``: it
serves end to end on the CPU when asked to, refuses to start without a
card otherwise, and says that ``--platform`` is not ported yet."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]


def test_serve_smoke_on_cpu(capsys):
    serve.main(["--arch", "gemma-2b", "--smoke", "--requests", "5",
                "--slots", "2", "--max-new", "4", "--max-len", "16",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "on cpu" in out
    assert "5 requests, 20 tokens" in out


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
