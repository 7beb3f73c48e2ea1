"""The fused ``alpha*I + beta*(A @ B)`` matmul (kernel K3) and the
Newton–Schulz square root built on it (mirrors tise_tpu/ops/pallas_kernels.py).

The Newton–Schulz step is ``T = 0.5 * (3I - Z @ Y)`` followed by two plain
products.  K3 (``csrc/epilogue_matmul.cu``) computes T with the identity and
the scale folded into the output tile's epilogue, in IEEE f32 (no TF32, as
the JAX path's f32 ``jnp.dot``).  The two plain products stay
``torch.matmul``, as the JAX function leaves them to XLA.  This is the
``--sqrtm ns-pallas`` method; ``ops.sqrtm`` keeps the all-``torch.matmul``
``ns`` beside it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tise_tpu_torch.ops import native


def epilogue_matmul_plain(a: torch.Tensor, b: torch.Tensor, alpha: float = 3.0, beta: float = -1.0) -> torch.Tensor:
    """Plain PyTorch version of K3: ``alpha*I + beta*(a @ b)`` (run it with
    TF32 off)."""
    eye = torch.eye(a.shape[0], dtype=torch.float32, device=a.device)
    return alpha * eye + beta * (a.float() @ b.float())


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = native.library("epilogue_matmul")
    fn = lib.tise_epilogue_matmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def epilogue_matmul_kernel(a: torch.Tensor, b: torch.Tensor, alpha: float = 3.0, beta: float = -1.0) -> torch.Tensor:
    """K3 on CUDA tensors: square contiguous f32 [n, n] inputs."""
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError("epilogue_matmul_kernel takes two CUDA tensors on one device")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"expected float32, got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or a.shape[0] != a.shape[1] or a.shape != b.shape:
        raise ValueError(f"expected two square matrices of one size, got {tuple(a.shape)} and {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("epilogue_matmul_kernel takes contiguous row-major matrices")
    n = a.shape[0]
    out = torch.empty((n, n), dtype=torch.float32, device=a.device)
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(a.device):
        err = lib.tise_epilogue_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n, n, n, alpha, beta,
            torch.cuda.current_stream().cuda_stream,
        )
    native.check(err, "epilogue_matmul")
    epilogue_matmul_kernel.launches += 1
    return out


epilogue_matmul_kernel.launches = 0


def epilogue_matmul(a: torch.Tensor, b: torch.Tensor, alpha: float = 3.0, beta: float = -1.0) -> torch.Tensor:
    """``alpha*I + beta*(a @ b)``: K3 on CUDA tensors, the plain version on
    CPU tensors."""
    if a.device.type == "cpu":
        return epilogue_matmul_plain(a, b, alpha, beta)
    return epilogue_matmul_kernel(a, b, alpha, beta)


def newton_schulz_sqrtm_pallas(a: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """Newton–Schulz sqrt with the fused ``0.5*(3I - Z@Y)`` step (K3).

    Y_{k+1} = Y_k T;  Z_{k+1} = T Z_k;  T = 1.5 I - 0.5 Z_k Y_k, with A
    normalised by its Frobenius norm (guard 1e-12: sqrtm(~0) = 0, not NaN).
    """
    a = a.float().contiguous()
    n = a.shape[0]
    norm = torch.sqrt(torch.sum(a * a))
    y = a / torch.clamp(norm, min=1e-12)
    z = torch.eye(n, dtype=torch.float32, device=a.device)
    for _ in range(iters):
        t = epilogue_matmul(z, y, alpha=1.5, beta=-0.5)
        y = y @ t
        z = t @ z
    return torch.where(norm > 1e-12, y * torch.sqrt(norm), torch.zeros_like(y))
