"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` under ``repro_torch/kernels`` is compiled by ``nvcc``
for Hopper into a shared library with a plain C interface, in
``build/repro_torch_kernels/`` at the root of the checkout (git-ignored).
The sources include no PyTorch header, so a build takes seconds; all
sources are compiled in parallel, one ``nvcc`` each.  A library is rebuilt
when its source or a header beside it is newer.  Nothing here runs at
import: the CPU tests import every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_libraries: Dict[str, ctypes.CDLL] = {}


def sources() -> List[Path]:
    """Every kernel source of the package, in a stable order."""
    return sorted(KERNELS_DIR.glob("**/csrc/*.cu"))


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _library_path(src: Path) -> Path:
    return BUILD_DIR / f"lib{src.stem}.so"


def _stale(src: Path) -> bool:
    lib = _library_path(src)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in src.parent.iterdir() if p.suffix in (".cu", ".cuh"))
    return lib.stat().st_mtime < newest


def build_all(verbose: bool = False) -> Tuple[float, Dict[str, str]]:
    """Compile every stale source, all in parallel; returns the seconds
    spent and the compiler's output by source stem (with ``verbose``, nvcc
    runs with ``-Xptxas -v``: each kernel's registers, spills and static
    shared memory).  Raises with the compiler's output if a build fails."""
    stale = [s for s in sources() if _stale(s)]
    if not stale:
        return 0.0, {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in stale:
        out = _library_path(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures, logs = [], {}
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {src.name} (exit {proc.returncode}):\n{log}")
            continue
        logs[src.stem] = log
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return time.perf_counter() - t0, logs


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built first if
    stale)."""
    if stem not in _libraries:
        build_all()
        matches = [s for s in sources() if s.stem == stem]
        if not matches:
            raise FileNotFoundError(f"no kernel source csrc/{stem}.cu")
        _libraries[stem] = ctypes.CDLL(str(_library_path(matches[0])))
    return _libraries[stem]
