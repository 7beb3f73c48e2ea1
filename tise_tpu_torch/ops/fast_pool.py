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
the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tise_tpu_torch.ops import native

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = native.library("avg_pool3x3")
    fn = lib.tise_avg_pool3x3_s1_p1
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def avg_pool_kernel(x: torch.Tensor, count_include_pad: bool = True) -> torch.Tensor:
    """K2 on a CUDA tensor: NHWC contiguous f32 or bf16 -> same shape and dtype."""
    if not x.is_cuda:
        raise ValueError("avg_pool_kernel takes a CUDA tensor")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"expected f32/bf16 NHWC, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("avg_pool_kernel takes a contiguous NHWC tensor")
    b, h, w, c = x.shape
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit 65535")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.tise_avg_pool3x3_s1_p1(
            x.data_ptr(), out.data_ptr(), b, h, w, c, _DTYPES[x.dtype], int(count_include_pad),
            torch.cuda.current_stream().cuda_stream,
        )
    native.check(err, "avg_pool3x3")
    avg_pool_kernel.launches += 1
    return out


avg_pool_kernel.launches = 0


def avg_pool_3x3_s1_p1(x: torch.Tensor, count_include_pad: bool = True) -> torch.Tensor:
    """NHWC 3x3 stride-1 pad-1 average pool: K2 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x.device.type == "cpu":
        return avg_pool_plain(x, count_include_pad)
    return avg_pool_kernel(x, count_include_pad)
