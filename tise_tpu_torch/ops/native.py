"""Build and bind the hand-written CUDA kernels in ``tise_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``build/tise_tpu_torch/``
(next to the package, git-ignored) at first use, then loaded with ``ctypes``.
All sources compile in parallel, one ``nvcc`` each.  A library's file name
carries a hash of its source and flags, so an edited source is rebuilt and a
stale library is never loaded.  Nothing is built when this module is
imported: the CPU tests import every module, and there is no ``nvcc`` there.

:func:`launch` is the one place a kernel's C entry is called from: every
``ctypes``-bound wrapper (K1-K3, P1-P6) declares its entry once as a
module-level :class:`CFunction` and hands it, its launch counter, the
tensors' device and the arguments to ``launch``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tise_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
#: ptxas register / shared-memory report of each library built in this process
BUILD_LOG: Dict[str, str] = {}


def nvcc() -> str:
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
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
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


class CFunction:
    """One C entry of ``csrc/<library>.cu``.  Declaring it builds and loads
    nothing; the first launch binds the symbol (``argtypes`` and ``restype``
    set, so pointers are not cut to 32 bits) and keeps it in ``call``, so a
    later launch costs no lookup."""

    __slots__ = ("library", "symbol", "argtypes", "restype", "call")

    def __init__(self, library: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int):
        self.library, self.symbol, self.argtypes, self.restype = library, symbol, list(argtypes), restype
        self.call: Optional[ctypes._CFuncPtr] = None

    def bind(self):
        if self.call is None:
            fn = getattr(library(self.library), self.symbol)
            fn.argtypes, fn.restype = self.argtypes, self.restype
            self.call = fn
        return self.call


# The current device's index and the current stream's raw handle without a
# torch.cuda.Stream object or a context manager (what Triton's launcher
# reads); a PyTorch without these private entries takes the public ones.
_current_device = getattr(torch._C, "_cuda_getDevice", None) or torch.cuda.current_device
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)


def launch(fn: CFunction, counter, device: torch.device, *args) -> None:
    """Launch a kernel: call ``fn`` with ``args`` and, as its last argument,
    the raw handle of ``device``'s current stream; raise on a non-zero
    ``cudaGetLastError()`` that the entry returns; then add one to
    ``counter.launches``.  ``device`` is the CUDA device the tensors behind
    the pointers in ``args`` live on; it is made current for the call only
    when it is not already.  The caller has checked its tensors: nothing
    here looks at them, and nothing falls back."""
    call = fn.call or fn.bind()
    index = device.index
    if index == _current_device():
        err = call(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = call(*args, _raw_stream(index))
    if err != 0:
        raise RuntimeError(f"{fn.symbol}: CUDA error {err} at launch")
    counter.launches += 1
