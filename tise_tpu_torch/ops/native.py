"""Build and bind the hand-written CUDA kernels in ``tise_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``build/tise_tpu_torch/``
(next to the package, git-ignored) at first use, then loaded with ``ctypes``.
All sources compile in parallel, one ``nvcc`` each.  A library's file name
carries a hash of its source and flags, so an edited source is rebuilt and a
stale library is never loaded.  Nothing is built when this module is
imported: the CPU tests import every module, and there is no ``nvcc`` there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tise_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
#: ptxas register / shared-memory report of each library built in this process
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from source at first use")
    return path


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{h}.so"


def build_all() -> List[Path]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library, all in
    parallel; raises with nvcc's output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        BUILD_LOG[src.stem] = log
        if proc.returncode != 0:
            failed.append(f"{src.name} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return [_target(src) for src in sorted(CSRC.glob("*.cu"))]


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building the sources first if
    needed."""
    if name not in _LIBS:
        path = _target(CSRC / f"{name}.cu")
        if not path.exists():
            build_all()
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
