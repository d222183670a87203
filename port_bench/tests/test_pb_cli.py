"""The command: no card, no result; on a card, a run of a cell ends in
one JSON line (the ``cuda`` test, which skips here)."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _cmd(*extra):
    return [sys.executable, "port_bench/run.py", "--workload",
            "granite-3-2b.chat", "--seed", str(2 ** 31 + 3), "--seconds", "2",
            "--trace", "0", *extra]


def test_no_card_exits_nonzero_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(_cmd(), cwd=ROOT, capture_output=True, text=True,
                       env=env, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_unknown_workload_exits_nonzero_without_a_result():
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        "nope", "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_card_run_prints_one_result_line(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run(_cmd(), cwd=ROOT, capture_output=True, text=True,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(out)[-1] == "checks" and out["device"]["platform"] == "gpu"
    # without the program beside the harness: no result
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench")
    p = subprocess.run(_cmd(), cwd=tmp_path, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode != 0 and p.stdout.strip() == ""
