"""Activation statistics for FID / O-FID (mirrors tise_tpu/ops/stats.py).

``exact_stats`` follows the reference: raw activations on the host, numpy
``np.mean`` / ``np.cov`` in float64 (fid_score.py:193-196).  The streaming
mode accumulates the sufficient statistics (count, sum, sum of outer
products) on the device in float32 with Kahan compensation, and the host
finalises mean and covariance in float64.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tise_tpu_torch.core.config import resolve_device


class MomentState(NamedTuple):
    """Sufficient statistics for (mean, covariance)."""

    count: torch.Tensor  # f32 scalar
    total: torch.Tensor  # f32 [D]
    outer: torch.Tensor  # f32 [D, D], sum of x x^T
    # float32 compensation terms (Kahan) keep 30k-sample accumulations tight
    total_c: torch.Tensor  # f32 [D]
    outer_c: torch.Tensor  # f32 [D, D]


def init_moments(dim: int, device: Optional[torch.device] = None) -> MomentState:
    """Zeroed accumulators on ``device``: ``None`` means the card, and raises
    where there is none; ``device="cpu"`` asks for the CPU."""
    device = resolve_device(device)
    z = torch.zeros((dim,), device=device)
    zz = torch.zeros((dim, dim), device=device)
    return MomentState(torch.zeros((), device=device), z, zz, torch.zeros_like(z), torch.zeros_like(zz))


def _kahan_add(total: torch.Tensor, comp: torch.Tensor, update: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    y = update - comp
    t = total + y
    comp_new = (t - total) - y
    return t, comp_new


def update_moments(state: MomentState, acts: torch.Tensor, mask: Optional[torch.Tensor] = None) -> MomentState:
    """Accumulate a batch of activations [B, D] (mask: bool [B], padding rows)."""
    acts = acts.float()
    if mask is not None:
        m = mask.float()
        acts = acts * m[:, None]
        count = state.count + torch.sum(m)
    else:
        count = state.count + acts.shape[0]
    batch_sum = torch.sum(acts, dim=0)
    batch_outer = acts.T @ acts  # the Gram update is one [D, B] x [B, D] product
    total, total_c = _kahan_add(state.total, state.total_c, batch_sum)
    outer, outer_c = _kahan_add(state.outer, state.outer_c, batch_outer)
    return MomentState(count, total, outer, total_c, outer_c)


def merge_moments(a: MomentState, b: MomentState) -> MomentState:
    return MomentState(
        a.count + b.count,
        a.total + b.total,
        a.outer + b.outer,
        torch.zeros_like(a.total_c),
        torch.zeros_like(a.outer_c),
    )


def psum_moments(state: MomentState, group=None) -> MomentState:
    """The accumulators summed over the processes of ``group`` (the FID
    analogue of the reference's SyncBN reduction, sync_batchnorm/comm.py);
    ``None`` is the default group.  The JAX function sums over a mesh axis."""
    summed = []
    for t in (state.count, state.total, state.outer):
        t = t.clone()
        dist.all_reduce(t, group=group)
        summed.append(t)
    return MomentState(*summed, torch.zeros_like(state.total_c), torch.zeros_like(state.outer_c))


def finalize_moments_f32(state: MomentState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device float32 finalisation -> (mu, sigma), the companion of the "ns"
    sqrtm (same f32 accuracy class)."""
    n = state.count.float()
    mu = state.total / n
    sigma = (state.outer - n * torch.outer(mu, mu)) / (n - 1.0)
    sigma = 0.5 * (sigma + sigma.T)
    return mu, sigma


def finalize_moments(state: MomentState) -> Tuple[np.ndarray, np.ndarray]:
    """Host float64 finalisation -> (mu, sigma), with the unbiased (n-1)
    normalisation of ``np.cov(act, rowvar=False)`` (fid_score.py:195)."""
    n = float(state.count)
    total = state.total.cpu().numpy().astype(np.float64)
    outer = state.outer.cpu().numpy().astype(np.float64)
    mu = total / n
    sigma = (outer - n * np.outer(mu, mu)) / (n - 1.0)
    sigma = 0.5 * (sigma + sigma.T)  # numerical symmetry
    return mu, sigma


def exact_stats(acts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Reference-semantics statistics from raw activations (fid_score.py:193-196)."""
    mu = np.mean(acts, axis=0)
    sigma = np.cov(acts, rowvar=False)
    return mu, sigma
