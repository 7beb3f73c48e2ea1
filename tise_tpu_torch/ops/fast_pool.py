"""3x3 stride-1 pad-1 average pooling over NHWC (mirrors
tise_tpu/ops/fast_pool.py:37-123) and kernel K2.

Every Inception A, C and E block runs this pool on its pool branch.  The
semantics are exact for both reference flavors:
  * ``count_include_pad=True``  (torch avg_pool2d): 1/3 per tap row and column;
  * ``count_include_pad=False`` (TF avg_pool SAME): 1/(in-bounds taps) per row
    and column (slim ops.py:368).
Both are two separable 3-tap sums, each scaled by ``_edge_inv``, in f32 with
the output in the input dtype — the arithmetic of the Pallas kernel, which is
not bit-equal to one division by 9 or by the tap count.

On a CUDA tensor the pool IS kernel K2 (``csrc/avg_pool3x3.cu``); a CPU
tensor takes the plain version.  There is no switch that routes the card off
the kernel.  The card's route is differentiable: its backward is K2 again
(``avg_pool_backward_kernel``): with the padding counted the pool is its own
adjoint, without it the kernel's adjoint mode takes each tap's weight at
the neighbour.  The backward's plain version is autograd through
``avg_pool_plain``, which CPU tensors take.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from tise_tpu_torch.ops import native

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}


def _edge_inv(n: int, include_pad: bool) -> np.ndarray:
    """1 / (in-bounds taps) per position (1/3 inside, 1/2 at edges) — or the
    constant 1/3 when padding counts toward the divisor."""
    c = np.full((n,), 1.0 / 3.0, np.float32)
    if not include_pad and n >= 1:
        c[0] = 0.5
        c[-1] = 0.5
        if n == 1:  # single in-bounds tap: both "edges" are the same element
            c[0] = 1.0
    return c


def avg_pool_plain(x: torch.Tensor, count_include_pad: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K2: the separable shifted-add with
    ``_edge_inv`` weights, in f32, output in the input dtype."""
    _, h, w, _ = x.shape
    xf = x.float()
    invh = torch.from_numpy(_edge_inv(h, count_include_pad)).to(x.device).view(1, h, 1, 1)
    invw = torch.from_numpy(_edge_inv(w, count_include_pad)).to(x.device).view(1, 1, w, 1)
    xh = torch.nn.functional.pad(xf, (0, 0, 0, 0, 1, 1))  # zero row above and below
    sh = (xh[:, :-2] + xh[:, 1:-1] + xh[:, 2:]) * invh
    sw = torch.nn.functional.pad(sh, (0, 0, 1, 1))  # zero column left and right
    out = (sw[:, :, :-2] + sw[:, :, 1:-1] + sw[:, :, 2:]) * invw
    return out.to(x.dtype)


def avg_pool_backward_plain(g: torch.Tensor, count_include_pad: bool = True) -> torch.Tensor:
    """Plain version of K2's backward: the gradient of ``avg_pool_plain``'s
    input for the incoming gradient ``g`` (NHWC), by autograd."""
    with torch.enable_grad():
        x = torch.zeros_like(g, requires_grad=True)  # the pool is linear: any input gives the same adjoint
        return torch.autograd.grad(avg_pool_plain(x, count_include_pad), x, g)[0]


_AVG_POOL = native.CFunction("avg_pool3x3", "tise_avg_pool3x3_s1_p1",
                             [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 13 + [ctypes.c_void_p])

#: the instances the wrapper chooses from: 16-byte accesses over whole rows,
#: one element an access over whole rows, and rows cut into column chunks
KERNEL_INSTANCES = ("vector", "scalar", "chunked")
SMS = 132                  # streaming multiprocessors of one H100
MAX_THREADS = 1024         # threads of one block
MAX_SHARED = 48 * 1024     # static-limit shared memory of one block: two row buffers of f32
TARGET_THREADS = 256       # a block's threads, where the row and the channels allow
MIN_CVB = 8                # channel vectors of a column per block (128 bytes of f32) where C has them
MIN_BLOCKS = 16 * SMS      # blocks a grid aims at: four waves at four blocks an SM
MIN_BAND = 4               # rows of a band, at least: each band re-reads two halo rows


class PoolGeometry(NamedTuple):
    """How K2 cuts one pool: what ``tise_avg_pool3x3_s1_p1`` is given, and
    the grid and block it launches from that."""

    instance: str   # one of KERNEL_INSTANCES
    vec: int        # channels a thread moves in one access: 16 bytes' worth, or 1
    cvb: int        # channel vectors of a block's slice
    chunk_w: int    # output columns of a block (the width, unless chunked)
    n_chunks: int
    band_h: int     # output rows of a block
    n_bands: int
    grid: Tuple[int, int, int]  # (channel slices, chunks x bands, images)
    threads: int    # (chunk_w + 2) x cvb: the run's columns and its two halo columns
    shared_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _geometry(shape: Sequence[int], itemsize: int, aligned: bool, target_threads: int, min_blocks: int,
              min_band: int) -> PoolGeometry:
    b, h, w, c = shape
    vec = 16 // itemsize if c % (16 // itemsize) == 0 and aligned else 1
    cv = c // vec
    max_threads = min(MAX_THREADS, MAX_SHARED // (2 * vec * 4))
    cvb_min = min(cv, MIN_CVB)
    if (w + 2) * cvb_min <= max_threads:
        chunk_w, n_chunks = w, 1
    else:  # a row does not fit one block: chunks of it, each with a column of halo on either side
        chunk_w = _cdiv(w, _cdiv(w, target_threads // cvb_min - 2))
        n_chunks = _cdiv(w, chunk_w)
    cap = max(cvb_min, min(target_threads, max_threads) // (chunk_w + 2))
    # the widest slice that divides the channels and still gives min_blocks
    # with bands of min_band rows; else the narrowest
    widths = [d for d in range(cap, cvb_min - 1, -1) if cv % d == 0] or [min(cv, cap)]
    per_image = {d: _cdiv(cv, d) * n_chunks for d in widths}
    most_bands = _cdiv(h, min_band)
    cvb = next((d for d in widths if b * per_image[d] * most_bands >= min_blocks), widths[-1])
    n_bands = max(1, min(most_bands, _cdiv(min_blocks, b * per_image[cvb])))
    band_h = _cdiv(h, n_bands)
    while band_h > min_band and _cdiv(h, band_h) < n_bands:  # rounding the band up lost a band
        band_h -= 1
    n_bands = _cdiv(h, band_h)
    threads = (chunk_w + 2) * cvb
    instance = "chunked" if n_chunks > 1 else ("vector" if vec > 1 else "scalar")
    return PoolGeometry(instance, vec, cvb, chunk_w, n_chunks, band_h, n_bands,
                        (_cdiv(cv, cvb), n_chunks * n_bands, b), threads, 2 * threads * vec * 4)


@functools.lru_cache(maxsize=None)
def pool_geometry(shape: Tuple[int, int, int, int], dtype: torch.dtype, aligned: bool = True) -> PoolGeometry:
    """K2's cut of an NHWC pool of ``shape`` and ``dtype`` (``aligned``: both
    tensors start on 16 bytes).  The vector instance where C is a multiple of
    the 16-byte vector (4 f32, 8 bf16), else the scalar one; whole rows where
    the row and its two halo columns fit one block, else column chunks.  The
    channel slice is the widest divisor of the channel vectors near
    TARGET_THREADS threads that still gives MIN_BLOCKS blocks, and rows are
    cut into bands until it does (no band under MIN_BAND rows).  Cached: the
    wrapper asks for it at every launch."""
    return _geometry(shape, _ITEMSIZE[dtype], aligned, TARGET_THREADS, MIN_BLOCKS, MIN_BAND)


def _launch_pool(counter, x: torch.Tensor, count_include_pad: bool, adjoint: bool) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError(f"{counter.__name__} takes a CUDA tensor")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"expected f32/bf16 NHWC, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{counter.__name__} takes a contiguous NHWC tensor")
    b, h, w, c = x.shape
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit 65535")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    g = pool_geometry(tuple(x.shape), x.dtype, x.data_ptr() % 16 == 0)
    native.launch(_AVG_POOL, counter, x.device, x.data_ptr(), out.data_ptr(), b, h, w, c,
                  _DTYPES[x.dtype], int(count_include_pad), int(adjoint), g.vec, g.cvb, g.chunk_w, g.n_chunks, g.band_h, g.n_bands)
    return out


def avg_pool_kernel(x: torch.Tensor, count_include_pad: bool = True) -> torch.Tensor:
    """K2 on a CUDA tensor: NHWC contiguous f32 or bf16 -> same shape and dtype."""
    return _launch_pool(avg_pool_kernel, x, count_include_pad, adjoint=False)


avg_pool_kernel.launches = 0


def avg_pool_backward_kernel(g: torch.Tensor, count_include_pad: bool = True) -> torch.Tensor:
    """K2's backward on a CUDA tensor: the incoming NHWC gradient -> the
    gradient of the pool's input.  The pool itself where the padding counts
    (it is its own adjoint), the kernel's adjoint mode where it does not.
    A gradient that arrives non-contiguous is copied first, and
    ``copies`` counts it."""
    if g.is_cuda and not g.is_contiguous():
        g = g.contiguous()
        avg_pool_backward_kernel.copies += 1
    return _launch_pool(avg_pool_backward_kernel, g, count_include_pad, adjoint=not count_include_pad)


avg_pool_backward_kernel.launches = 0
avg_pool_backward_kernel.copies = 0


class _AvgPool3x3(torch.autograd.Function):
    """K2 with K2's backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, count_include_pad: bool) -> torch.Tensor:
        ctx.count_include_pad = count_include_pad
        return avg_pool_kernel(x, count_include_pad)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return avg_pool_backward_kernel(g, ctx.count_include_pad), None


def avg_pool_3x3_s1_p1(x: torch.Tensor, count_include_pad: bool = True) -> torch.Tensor:
    """NHWC 3x3 stride-1 pad-1 average pool: K2 on a CUDA tensor (with K2's
    backward where autograd records it), the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return avg_pool_plain(x, count_include_pad)
    if torch.is_grad_enabled() and x.requires_grad:
        return _AvgPool3x3.apply(x, count_include_pad)
    return avg_pool_kernel(x, count_include_pad)
