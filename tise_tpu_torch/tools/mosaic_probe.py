"""Layout probes on the card: kernels P1-P5 (mirrors tools/mosaic_probe.py).

The TPU script asks its compiler whether five layouts that a fused Inception
stem needs can be expressed inside a kernel, and prints PASS/FAIL per
capability.  On a CUDA card every one of them can, so here each probe is a
hand-written kernel (``csrc/layout_probes.cu``) that computes what its TPU
kernel computes, at the same shape and type, and is held against a plain
PyTorch version on seeded random input:

  lane_split      [44, 900] -> [44, 300, 3] summed over the triples
  dma_minor27     x * 2 moved in blocks [2, 128, 27] (minor dimension 27)
  strided_slice   x[:, ::2]
  lane_concat     concat([2x, x.T], axis=1) of a [128, 128] tile
  scratch_stage   two scaled half rows staged through shared-memory scratch

A FAIL here is a bug, not a finding: the entry point exits non-zero on any.

Usage: python -m tise_tpu_torch.tools.mosaic_probe      (needs one CUDA card)
"""

from __future__ import annotations

import ctypes
import functools
import sys
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from tise_tpu_torch.core.config import resolve_device
from tise_tpu_torch.ops import native

_VOID, _INT = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = native.library("layout_probes")
    for name, ints in (("lane_split", 2), ("dma_minor27", 4), ("strided_slice", 2),
                       ("lane_concat", 1), ("scratch_stage", 1)):
        fn = getattr(lib, f"tise_probe_{name}")
        fn.argtypes = [_VOID, _VOID] + [_INT] * ints + [_VOID]
        fn.restype = _INT
    return lib


def _check_input(x: torch.Tensor, name: str, dim: int) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}_kernel takes a CUDA tensor")
    if x.dtype != torch.float32 or x.dim() != dim:
        raise ValueError(f"{name}: expected float32 with {dim} dimensions, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16 != 0:
        raise ValueError(f"{name}_kernel takes a contiguous tensor aligned to 16 bytes")


def _launch(fn_name: str, kernel: Callable, x: torch.Tensor, out: torch.Tensor, *ints: int) -> torch.Tensor:
    with torch.cuda.device(x.device):
        err = getattr(_lib(), f"tise_probe_{fn_name}")(
            x.data_ptr(), out.data_ptr(), *ints, torch.cuda.current_stream().cuda_stream)
    native.check(err, fn_name)
    kernel.launches += 1
    return out


# -- P1 ----------------------------------------------------------------------

def lane_split_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of P1: ``x.view(R, G, 3).sum(-1)``."""
    return x.view(x.shape[0], -1, 3).sum(-1)


def lane_split_kernel(x: torch.Tensor) -> torch.Tensor:
    """P1 on a CUDA tensor: f32 [R, 3G] (3G a multiple of 4) -> [R, G]."""
    _check_input(x, "lane_split", 2)
    r, width = x.shape
    if width % 3 != 0 or width % 4 != 0 or width * 4 > 48 * 1024:
        raise ValueError(f"lane_split: row width {width} must be a multiple of 12 and fit 48 KB")
    out = torch.empty((r, width // 3), dtype=torch.float32, device=x.device)
    return _launch("lane_split", lane_split_kernel, x, out, r, width // 3)


# -- P2 ----------------------------------------------------------------------

DMA_BLOCK = 2  # leading-dimension extent of one moved block, as in the TPU probe's BlockSpec


def dma_minor27_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of P2: ``x * 2``."""
    return x * 2.0


def dma_minor27_kernel(x: torch.Tensor) -> torch.Tensor:
    """P2 on a CUDA tensor: f32 [B, R, M], moved in blocks [2, R, M]."""
    _check_input(x, "dma_minor27", 3)
    b, r, m = x.shape
    n = DMA_BLOCK * r * m
    if b % DMA_BLOCK != 0 or n % 4 != 0 or n * 4 > 48 * 1024:
        raise ValueError(f"dma_minor27: blocks [{DMA_BLOCK}, {r}, {m}] must tile {tuple(x.shape)}, "
                         "hold a multiple of 4 floats and fit 48 KB")
    return _launch("dma_minor27", dma_minor27_kernel, x, torch.empty_like(x), b, DMA_BLOCK, r, m)


# -- P3 ----------------------------------------------------------------------

def strided_slice_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of P3: ``x[:, ::2]``."""
    return x[:, ::2].contiguous()


def strided_slice_kernel(x: torch.Tensor) -> torch.Tensor:
    """P3 on a CUDA tensor: f32 [R, 2C] -> [R, C]."""
    _check_input(x, "strided_slice", 2)
    r, width = x.shape
    if width % 2 != 0:
        raise ValueError(f"strided_slice: row width {width} must be even")
    out = torch.empty((r, width // 2), dtype=torch.float32, device=x.device)
    return _launch("strided_slice", strided_slice_kernel, x, out, r, width // 2)


# -- P4 ----------------------------------------------------------------------

def lane_concat_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of P4: ``cat([2x, x.T], 1)``."""
    return torch.cat([2.0 * x, x.T], 1)


def lane_concat_kernel(x: torch.Tensor) -> torch.Tensor:
    """P4 on a CUDA tensor: square f32 [N, N] -> [N, 2N]."""
    _check_input(x, "lane_concat", 2)
    n = x.shape[0]
    if x.shape[1] != n:
        raise ValueError(f"lane_concat: expected a square matrix, got {tuple(x.shape)}")
    out = torch.empty((n, 2 * n), dtype=torch.float32, device=x.device)
    return _launch("lane_concat", lane_concat_kernel, x, out, n)


# -- P5 ----------------------------------------------------------------------

def scratch_stage_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of P5: the two scaled halves of each row."""
    return torch.cat([x[:, :32] * 2.0, x[:, 32:] * 3.0], 1)


def scratch_stage_kernel(x: torch.Tensor) -> torch.Tensor:
    """P5 on a CUDA tensor: f32 [R, 64]."""
    _check_input(x, "scratch_stage", 2)
    if x.shape[1] != 64:
        raise ValueError(f"scratch_stage: expected rows of 64, got {tuple(x.shape)}")
    return _launch("scratch_stage", scratch_stage_kernel, x, torch.empty_like(x), x.shape[0])


for _k in (lane_split_kernel, dma_minor27_kernel, strided_slice_kernel, lane_concat_kernel, scratch_stage_kernel):
    _k.launches = 0

#: name -> (kernel wrapper, plain version, the TPU probe's input shape, rtol of the comparison)
PROBES: Dict[str, Tuple[Callable, Callable, Tuple[int, ...], float]] = {
    # three f32 adds in a fixed order; the plain reduction may add in another
    "lane_split": (lane_split_kernel, lane_split_plain, (44, 900), 1e-6),
    "dma_minor27": (dma_minor27_kernel, dma_minor27_plain, (8, 128, 27), 0.0),
    "strided_slice": (strided_slice_kernel, strided_slice_plain, (8, 256), 0.0),
    "lane_concat": (lane_concat_kernel, lane_concat_plain, (128, 128), 0.0),
    "scratch_stage": (scratch_stage_kernel, scratch_stage_plain, (8, 64), 0.0),
}


def probe(name: str, x: torch.Tensor) -> torch.Tensor:
    """The named probe: its kernel on a CUDA tensor, its plain version on a
    CPU tensor."""
    kernel, plain, _, _ = PROBES[name]
    return plain(x) if x.device.type == "cpu" else kernel(x)


def probe_input(name: str, seed: int = 0) -> np.ndarray:
    """Seeded standard-normal input at the probe's shape (random, so that a
    wrong index shows)."""
    return np.random.RandomState(seed).randn(*PROBES[name][2]).astype(np.float32)


def run_probe(name: str, device) -> Tuple[bool, float]:
    """(passed, max abs error) of one probe against its plain version on
    ``device``: bit-equal where the tolerance is 0."""
    _, plain, _, rtol = PROBES[name]
    x = torch.from_numpy(probe_input(name)).to(device)
    got, ref = probe(name, x), plain(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ok = got.shape == ref.shape and (torch.equal(got, ref) if rtol == 0.0
                                     else torch.allclose(got, ref, rtol=rtol, atol=rtol))
    return bool(ok), float((got - ref).abs().max())


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", type=str, default="cuda")
    device = resolve_device(p.parse_args(argv).device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (plain versions only)"
    print(f"torch {torch.__version__} / device {where}")
    failed = []
    for name in PROBES:
        ok, err = run_probe(name, device)
        print(f"{name:14s} {'PASS' if ok else 'FAIL'}  max_abs_err {err:.3e}")
        if not ok:
            failed.append(name)
    if failed:
        print(f"FAILED: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
