"""Device-side preprocessing: the normalization recipes (mirrors
tise_tpu/ops/preprocess.py:30-114) and kernel K1.

Host workers produce uint8 NHWC batches at the target geometry (exact PIL
resampling); the uint8 -> normalized-float conversion runs on the device.
``resize_and_normalize`` is the device-resize path: the host sends native-size
uint8, K1 normalizes at that size and the library's antialiased bilinear
resize brings the batch to the trunk's geometry (close to PIL's, not
bit-equal: a documented deviation of the reference's fast path).

K1, ``normalize_kernel``, is a Triton kernel that replaces the Pallas
``tise_tpu/ops/preprocess.py::normalize_pallas``.  It is one fused
elementwise pass: one uint8 read and one f32/bf16 write per element, with no
reuse, so it is bound by device-memory bandwidth (5 bytes per element in f32,
against 13 for the plain version's three passes: cast, multiply, add).  The
design does nothing but stream: 4096 elements per program, the channel of an
element is its flat index mod 3, and the per-channel constants are
scalar arguments.  The output is NHWC contiguous, which the trunk takes as an
NCHW ``channels_last`` view without a copy.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import torch

from tise_tpu_torch.ops import native

# (scale, shift) per channel applied to x in [0, 1]: out = x * scale + shift
_FID_SCALE = (0.229 / 0.5, 0.224 / 0.5, 0.225 / 0.5)
_FID_SHIFT = ((0.485 - 0.5) / 0.5, (0.456 - 0.5) / 0.5, (0.406 - 0.5) / 0.5)

_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _affine_from_mean_std(mean, std) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    scale = tuple(1.0 / (255.0 * s) for s in std)
    shift = tuple(-m / s for m, s in zip(mean, std))
    return scale, shift


#: recipe -> (scale, shift) applied to raw uint8 value v: out = v * scale + shift
RECIPES: dict[str, Tuple[Tuple[float, ...], Tuple[float, ...]]] = {
    # (a) FID: [0,1] then the TTUR affine (FID/inception.py:120-124)
    "fid": (tuple(s / 255.0 for s in _FID_SCALE), _FID_SHIFT),
    # (b) IS*: v/127.5 - 1
    "is_star": ((1 / 127.5,) * 3, (-1.0,) * 3),
    # (b') the 2015 classify_image GraphDef: (v - 128)/128
    "is_star_2015": ((1 / 128.0,) * 3, (-1.0,) * 3),
    # (c)/(e) Normalize(0.5, 0.5) on [0,1]
    "half": ((1 / 127.5,) * 3, (-1.0,) * 3),
    # (d) CLIP
    "clip": _affine_from_mean_std(_CLIP_MEAN, _CLIP_STD),
    # (f) ImageNet
    "imagenet": _affine_from_mean_std(_IMAGENET_MEAN, _IMAGENET_STD),
    # raw [0,1]
    "unit": ((1 / 255.0,) * 3, (0.0,) * 3),
}

_DTYPES = (torch.float32, torch.bfloat16)


def _constants(recipe: str, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Python float64 constants cast to the output dtype, as the JAX
    ``jnp.asarray(scale, dtype)`` does."""
    scale, shift = RECIPES[recipe]
    return torch.tensor(scale, dtype=torch.float64).to(dtype), torch.tensor(shift, dtype=torch.float64).to(dtype)


def normalize_plain(images_u8: torch.Tensor, recipe: str, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K1: ``x.to(dtype) * scale + shift``."""
    scale, shift = _constants(recipe, dtype)
    return images_u8.to(dtype) * scale.to(images_u8.device) + shift.to(images_u8.device)


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    os.environ.setdefault("TRITON_CACHE_DIR", str(native.BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def normalize_kernel(x_ptr, out_ptr, n, s0, s1, s2, b0, b1, b2,
                         BLOCK: tl.constexpr, ROUND_BF16: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        x = tl.load(x_ptr + offs, mask=mask, other=0).to(tl.float32)
        c = offs % 3
        s = tl.where(c == 0, s0, tl.where(c == 1, s1, s2))
        b = tl.where(c == 0, b0, tl.where(c == 1, b1, b2))
        p = x * s
        if ROUND_BF16:  # the bf16 product is rounded before the add, as in torch
            p = p.to(tl.bfloat16).to(tl.float32)
        tl.store(out_ptr + offs, (p + b).to(out_ptr.dtype.element_ty), mask=mask)

    return normalize_kernel


_BLOCK = 4096


def normalize_kernel(images_u8: torch.Tensor, recipe: str, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K1 on a CUDA tensor: uint8 NHWC [B, H, W, 3] contiguous -> ``dtype`` NHWC."""
    if not images_u8.is_cuda:
        raise ValueError("normalize_kernel takes a CUDA tensor")
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"expected uint8 [B, H, W, 3], got {images_u8.dtype} {tuple(images_u8.shape)}")
    if not images_u8.is_contiguous():
        raise ValueError("normalize_kernel takes a contiguous NHWC tensor")
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported output dtype {dtype}")
    scale, shift = (t.to(torch.float32).tolist() for t in _constants(recipe, dtype))
    out = torch.empty(images_u8.shape, dtype=dtype, device=images_u8.device)
    n = images_u8.numel()
    if n == 0:
        return out
    kernel = _triton_kernel()
    with torch.cuda.device(images_u8.device):
        # enable_fp_fusion=False: the product and the sum round separately,
        # as the plain version's two operations do
        kernel[(-(-n // _BLOCK),)](
            images_u8, out, n, *scale, *shift,
            BLOCK=_BLOCK, ROUND_BF16=dtype == torch.bfloat16,
            num_warps=8, enable_fp_fusion=False,
        )
    normalize_kernel.launches += 1
    return out


normalize_kernel.launches = 0


def normalize(images_u8: torch.Tensor, recipe: str, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 NHWC -> normalized float NHWC under the named recipe: K1 on a
    CUDA tensor, the plain version on a CPU tensor."""
    if images_u8.device.type == "cpu":
        return normalize_plain(images_u8, recipe, dtype)
    return normalize_kernel(images_u8, recipe, dtype)


def resize_and_normalize(
    images_u8: torch.Tensor, recipe: str, out_size: int, antialias: bool = True,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Device-side normalize, then resize to ``out_size`` x ``out_size``
    (mirrors tise_tpu/ops/preprocess.py:117-133: the affine comes first, the
    triangle filter second).  ``F.interpolate(mode="bilinear",
    align_corners=False)`` is the half-pixel-centre triangle filter of
    ``jax.image.resize(method="linear")``; with ``antialias`` both widen it by
    the scale factor when shrinking and leave it alone when enlarging."""
    x = normalize(images_u8, recipe, dtype)
    if tuple(x.shape[1:3]) == (out_size, out_size):
        return x
    y = torch.nn.functional.interpolate(
        x.permute(0, 3, 1, 2), size=(out_size, out_size), mode="bilinear",
        align_corners=False, antialias=antialias,
    )
    return y.permute(0, 2, 3, 1)


def resize_bilinear_align_corners(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize with ``align_corners=True`` (the FID wrapper's
    and the DAMSM encoder's upsample; mirrors
    tise_tpu/ops/preprocess.py:136-166, which builds the gather weights by
    hand because its library has no such mode)."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1)
