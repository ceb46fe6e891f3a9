"""The port stands alone: ``openr_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``openr_tpu``, and its entry
points refuse to drop to the CPU when no card is present."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "openr_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "openr_tpu"}


def _port_sources():
    return sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    out = []
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_sources_import_no_jax_or_reference_package():
    offenders = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    offenders.append(f"{path.relative_to(ROOT)}:{node.lineno} {name}")
    assert not offenders, offenders


def test_every_module_imports_with_jax_and_reference_blocked():
    modules = _modules()
    for name in (
        "openr_tpu_torch.decision.backend",
        "openr_tpu_torch.decision.ksp2",
        "openr_tpu_torch.decision.whatif_api",
        "openr_tpu_torch.emulation.topology",
    ):
        assert name in modules
    code = "\n".join(
        [
            "import importlib, sys",
            "for blocked in %r:" % sorted(FORBIDDEN),
            "    sys.modules[blocked] = None",
            "for name in %r:" % modules,
            "    importlib.import_module(name)",
            "import chip_smoke",
            "leaked = [m for m in sys.modules if m.split('.')[0] in %r"
            " and sys.modules[m] is not None]" % sorted(FORBIDDEN),
            "assert not leaked, leaked",
            "print('ok', len(%r))" % modules,
        ]
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("ok")


def test_backend_without_device_refuses_to_run_without_cuda(monkeypatch):
    from openr_tpu_torch.decision.backend import CudaBackend
    from openr_tpu_torch.decision.spf_solver import SpfSolver
    from openr_tpu_torch.decision.whatif_api import DeviceBuildWhatIfEngine
    from openr_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CudaBackend(SpfSolver("node0"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceBuildWhatIfEngine(SpfSolver("node0"))
    assert resolve_device("cpu") == torch.device("cpu")
