"""run.py as the driver calls it, on a machine without a card, and in a
directory that holds only BENCHMARK.json and portbench/: non-zero, and no
result on standard output."""
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ARGS = ["--workload", "bitsage.flickr", "--seed", "3", "--seconds", "1",
        "--trace", "0"]


def call(root):
    return subprocess.run([sys.executable, str(root / "portbench" / "run.py"),
                           *ARGS], cwd=root, capture_output=True, text=True,
                          timeout=300)


def test_without_a_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = call(harness.ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA device" in p.stderr


def test_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = call(tmp_path)
    assert p.returncode != 0 and p.stdout == ""
