"""Audit of the port's boundary: ``repro_torch``, ``chip_smoke.py`` and the
port's hill-climb (``tools/perf_hillclimb.py``) import neither JAX nor
anything of the JAX package ``repro``."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "repro"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "tools" / "perf_hillclimb.py"]


def _imported_roots(path):
    roots = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots += [(a.name.split(".")[0], node.lineno) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.append((node.module.split(".")[0], node.lineno))
    return roots


def test_no_jax_or_repro_import_in_port_sources():
    offenders = [
        f"{path.relative_to(REPO)}:{line} imports {root}"
        for path in _port_files()
        for root, line in _imported_roots(path)
        if root in FORBIDDEN_ROOTS
    ]
    assert not offenders, offenders


def test_every_port_module_imports_with_jax_and_repro_blocked():
    code = textwrap.dedent(
        """
        import importlib, importlib.abc, pkgutil, sys

        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None

        class RefuseRepro(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name == "repro" or name.startswith("repro."):
                    raise ImportError(f"port imported {name}")
                return None

        sys.meta_path.insert(0, RefuseRepro())
        import repro_torch

        names = ["repro_torch"] + [
            m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
        ]
        for name in names:
            importlib.import_module(name)
        assert not any(m == "repro" or m.startswith("repro.") for m in sys.modules)
        print(len(names))
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=REPO, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    n_modules = int(proc.stdout.split()[-1])
    assert n_modules == len(list(PORT.rglob("*.py")))


def test_serve_device_defaults_to_cuda():
    from repro_torch.launch import serve

    assert serve.build_parser().get_default("device") == "cuda"


def test_kernel_sources_ship_with_the_package():
    from repro_torch.kernels import _build

    names = [p.relative_to(PORT).as_posix() for p in _build.sources()]
    assert names == [
        "kernels/attention/csrc/flash_bwd_sm90.cu",
        "kernels/attention/csrc/flash_fwd_sm90.cu",
        "kernels/attention/csrc/flash_fwd_tf32_sm90.cu",
        "kernels/rwkv6/csrc/rwkv6_fwd_sm90.cu",
        "kernels/ssd/csrc/ssd_fwd_sm90.cu",
    ]
    assert "repro_torch" in (REPO / "pyproject.toml").read_text()
