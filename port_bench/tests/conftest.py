"""Shared set-up of the benchmark's CPU tests: the harness and the program
on the path, few threads, and a cell cut to the smoke sizes."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parents[1] / "src")]

# the smoke sizes the repository's CPU tests run the configurations at
SMOKE = dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=512,
             head_dim=16)
SMOKE_MOE = dict(n_routed=8, top_k=2, n_shared=1, d_expert=32,
                 capacity_factor=1.5, groups=4)


def smoke_cell(name: str, rows: int = 4):
    """Workload ``name`` of ``BENCHMARK.json`` at smoke widths on a few rows
    with short prompts, a short ramp and a two-round trace slice."""
    import pb_spec
    c = pb_spec.cell(name)
    c.config["model"].update(SMOKE)
    if c.config["model"].get("moe"):
        c.config["model"]["moe"] = dict(SMOKE_MOE)
    c.traffic.update(prompt_tokens={"dist": "log_uniform", "lo": 8, "hi": 40},
                     output_tokens={"dist": "log_uniform", "lo": 4, "hi": 12},
                     block=16)
    c.cell.update(rows=rows, slots=64, ramp_rounds=3,
                  trace_rounds={"skip": 1, "count": 2}, sample_requests=3)
    return c


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
