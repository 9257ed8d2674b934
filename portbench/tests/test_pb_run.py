"""The command refuses to run, and prints no result, where it must not
measure: without the program beside it, and without a CUDA card."""
import shutil
import subprocess
import sys

import torch

from portbench.tests.tiny import ROOT

ARGS = ["--workload", "sf1_streams", "--seed", "1", "--seconds", "1",
        "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120)


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        return
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
