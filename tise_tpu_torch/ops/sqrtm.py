"""Matrix square root and the Fréchet distance (mirrors tise_tpu/ops/sqrtm.py).

The reference computes ``scipy.linalg.sqrtm(sigma1 @ sigma2)`` on the host
(fid_score.py:155).  Only ``trace(sqrtm(sigma1 @ sigma2))`` is needed, and
the product of two PSD matrices is similar to a PSD matrix, so a scaled
Newton–Schulz iteration converges in ~30 coupled f32 matmul steps on the
device ("ns", plain ``torch.matmul`` with TF32 off; "ns-pallas" runs the step
through kernel K3).  "scipy" reproduces the reference bit for bit, including
its eps retry and imaginary-component guard; "eigh" is the float64 host
eigendecomposition route.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tise_tpu_torch.core.config import resolve_device
from tise_tpu_torch.ops.pallas_kernels import newton_schulz_sqrtm_pallas


def newton_schulz_sqrtm(a: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """sqrt of a (near-)PSD matrix via the coupled Newton–Schulz iteration.

    Y_{k+1} = 0.5 Y_k (3I - Z_k Y_k);  Z_{k+1} = 0.5 (3I - Z_k Y_k) Z_k,
    with A normalised by its Frobenius norm for convergence.  f32 matmuls
    (run with TF32 off: core.config.configure_precision).
    """
    a = a.float()
    dim = a.shape[0]
    norm = torch.sqrt(torch.sum(a * a))
    # sqrtm(~0) = ~0: degenerate covariances yield 0 instead of NaN
    y = a / torch.clamp(norm, min=1e-12)
    z = torch.eye(dim, dtype=torch.float32, device=a.device)
    eye3 = 3.0 * torch.eye(dim, dtype=torch.float32, device=a.device)
    for _ in range(iters):
        t = 0.5 * (eye3 - z @ y)
        y = y @ t
        z = t @ z
    return torch.where(norm > 1e-12, y * torch.sqrt(norm), torch.zeros_like(y))


def frechet_distance_device(
    mu1: torch.Tensor, sigma1: torch.Tensor, mu2: torch.Tensor, sigma2: torch.Tensor, iters: int = 30
) -> torch.Tensor:
    """All-device f32 Fréchet distance (Newton–Schulz trace) -> 0-dim tensor.

    The sigmas are cast to f32 once up front: the traces would otherwise
    accumulate the diagonal in the caller's dtype.
    """
    mu1, mu2 = mu1.float(), mu2.float()
    sigma1, sigma2 = sigma1.float(), sigma2.float()
    diff = mu1 - mu2
    tr_covmean = torch.trace(newton_schulz_sqrtm(sigma1 @ sigma2, iters=iters))
    return diff.dot(diff) + torch.trace(sigma1) + torch.trace(sigma2) - 2.0 * tr_covmean


def _sqrtm_scipy(mat: np.ndarray):
    """Reference host path: scipy Schur sqrtm (fid_score.py:155-167)."""
    from scipy import linalg

    res = linalg.sqrtm(mat)  # scipy >= 1.17 returns the matrix directly
    return res[0] if isinstance(res, tuple) else res


def trace_sqrtm_product(
    sigma1: np.ndarray, sigma2: np.ndarray, method: str = "eigh", device: Optional[torch.device] = None
) -> float:
    """tr(sqrtm(sigma1 @ sigma2)) for symmetric PSD sigma1, sigma2.

    Methods:
      * "eigh":      sum sqrt(eigvals(sqrt(S1) S2 sqrt(S1))), float64 host eigh;
      * "ns":        device Newton–Schulz (float32, ``torch.matmul``);
      * "ns-pallas": device Newton–Schulz with the K3 step;
      * "scipy":     reference scipy.linalg.sqrtm.
    ``device`` is where the Newton–Schulz methods run: ``None`` means the
    card, and raises where there is none; the CPU must be asked for
    (``device="cpu"``, where "ns-pallas" takes K3's plain version).  The host
    methods take no device.
    """
    if method in ("ns", "ns-pallas"):
        dev = resolve_device(device)
        prod = torch.as_tensor(sigma1, dtype=torch.float32, device=dev) @ torch.as_tensor(
            sigma2, dtype=torch.float32, device=dev
        )
        sqrt_fn = newton_schulz_sqrtm if method == "ns" else newton_schulz_sqrtm_pallas
        return float(torch.trace(sqrt_fn(prod)))
    if method == "scipy":
        covmean = _sqrtm_scipy(sigma1.dot(sigma2))
        if np.iscomplexobj(covmean):
            covmean = covmean.real
        return float(np.trace(covmean))
    if method != "eigh":
        raise ValueError(f"unknown sqrtm method {method!r}")
    s1 = np.asarray(sigma1, np.float64)
    s2 = np.asarray(sigma2, np.float64)
    w1, v1 = np.linalg.eigh(s1)
    w1 = np.clip(w1, 0.0, None)
    sqrt_s1 = (v1 * np.sqrt(w1)) @ v1.T
    inner = sqrt_s1 @ s2 @ sqrt_s1
    w = np.linalg.eigvalsh(0.5 * (inner + inner.T))
    w = np.clip(w, 0.0, None)
    return float(np.sum(np.sqrt(w)))


def frechet_distance(
    mu1: np.ndarray,
    sigma1: np.ndarray,
    mu2: np.ndarray,
    sigma2: np.ndarray,
    eps: float = 1e-6,
    method: str = "scipy",
    device: Optional[torch.device] = None,
) -> float:
    """d^2 = ||mu1 - mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)).

    ``method="scipy"`` reproduces the reference exactly, including the
    eps-diagonal retry on singular products and the imaginary-component check
    (fid_score.py:121-171).  "ns" runs all on ``device`` in f32; "eigh" and
    "ns-pallas" compute the trace term by ``trace_sqrtm_product`` and the
    rest in float64 on the host.  ``device=None`` means the card for "ns" and
    "ns-pallas", and raises where there is none (``device="cpu"`` asks for
    the CPU); "scipy" and "eigh" run on the host and ignore it.
    """
    if method == "ns":
        dev = resolve_device(device)
        t = [torch.as_tensor(np.asarray(v), device=dev) for v in (mu1, sigma1, mu2, sigma2)]
        return float(frechet_distance_device(*t))
    mu1 = np.atleast_1d(np.asarray(mu1, np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    if mu1.shape != mu2.shape:
        raise ValueError("mean vectors have different lengths")
    if sigma1.shape != sigma2.shape:
        raise ValueError("covariances have different dimensions")

    diff = mu1 - mu2

    if method == "scipy":
        covmean = _sqrtm_scipy(sigma1.dot(sigma2))
        if not np.isfinite(covmean).all():
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = _sqrtm_scipy((sigma1 + offset).dot(sigma2 + offset))
        if np.iscomplexobj(covmean):
            if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
                m = np.max(np.abs(covmean.imag))
                raise ValueError(f"Imaginary component {m}")
            covmean = covmean.real
        tr_covmean = float(np.trace(covmean))
    else:
        tr_covmean = trace_sqrtm_product(sigma1, sigma2, method=method, device=device)

    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_covmean)
