"""The PyTorch port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, importing the whole port
loads no JAX, and its entry points refuse to fall back to the CPU when no
GPU is present and the CPU was not asked for."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import runtime
from repro_torch.configs import get_smoke
from repro_torch.core.engine import AdaptiveEngine, QuantIndex
from repro_torch.core.profiles import paper_profiles
from repro_torch.models import transformer as T
from repro_torch.serving.engine import AdaptiveServer, ServingConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.resolve_device("cuda")
    assert runtime.resolve_device("cpu").type == "cpu"
    cfg = get_smoke("granite-3-2b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    names = T.quant_layer_names(cfg)
    eng = AdaptiveEngine(tuple(paper_profiles(names)), QuantIndex(names))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdaptiveServer(cfg, params, eng, ServingConfig(slots=32, max_batch=2))
    srv = AdaptiveServer(cfg, params, eng,
                         ServingConfig(slots=32, max_batch=2), device="cpu")
    assert srv.paged_backend == "gather"           # auto on the CPU


def test_compute_dtype_follows_device_and_override():
    assert runtime.compute_dtype("cpu") == torch.float32
    assert runtime.compute_dtype("cuda") == torch.bfloat16
    with runtime.use_compute_dtype(torch.float32):
        assert runtime.compute_dtype("cuda") == torch.float32
    assert runtime.compute_dtype("cuda") == torch.bfloat16


def test_kernel_wrapper_rejects_what_the_kernel_cannot_take():
    """CUDA tensors launch or raise; validation runs before any build."""
    from repro_torch.kernels import paged_attention as PA
    q = torch.zeros(2, 2, 2, 16)
    pool = torch.zeros(3, 8, 2, 16, dtype=torch.bfloat16)
    args = (q, pool, pool, torch.ones(2, 2), torch.ones(2, 2),
            torch.full((3, 8), -1, dtype=torch.int32),
            torch.zeros(2, 4, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32))
    out = PA.paged_attention(*args)                 # CPU: the plain version
    assert torch.equal(out, torch.zeros_like(out))  # nothing attendable
    with pytest.raises(ValueError, match="kv16/kv8/kv4"):
        PA.paged_attention(*(a.to("meta") for a in args), bits=32)
