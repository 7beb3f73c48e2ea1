"""Temperature-scaled softmax and the split-KL Inception Score (mirrors
tise_tpu/ops/kl.py).

Reference math (identical across the three IS variants):
  * temperature-divided logits -> softmax
    (inception_score_star_bird.py:192-194, inception_score_star_coco.py:107-108,
     object_centric_inception_score.py:55-57)
  * N predictions split into ``splits`` contiguous parts by integer slicing
    ``[i*N//s : (i+1)*N//s]``; per part  exp(mean_i KL(p_i || mean_j p_j))
    (inception_score_star_bird.py:99-105); O-IS uses scipy.stats.entropy which
    is the same KL (object_centric_inception_score.py:72-79)
  * result = (mean, std) over the split scores.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tise_tpu_torch.core.config import resolve_device


def temperature_softmax(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """softmax(logits / T) in float32, on the device that holds ``logits``."""
    t = torch.tensor(temperature, dtype=torch.float32, device=logits.device)
    return torch.softmax(logits.to(torch.float32) / t, dim=-1)


def split_kl_scores(preds: np.ndarray, splits: int = 10) -> np.ndarray:
    """Per-split exp(mean KL) scores (host float64, reference slicing)."""
    preds = np.asarray(preds, dtype=np.float64)
    n = preds.shape[0]
    scores = []
    for i in range(splits):
        part = preds[i * n // splits : (i + 1) * n // splits, :]
        marginal = np.mean(part, axis=0, keepdims=True)
        kl = part * (np.log(part) - np.log(marginal))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return np.array(scores)


def inception_score(preds: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """(mean, std) of the split scores (reference: np.mean/np.std, i.e. ddof=0)."""
    scores = split_kl_scores(preds, splits)
    return float(np.mean(scores)), float(np.std(scores))


def inception_score_from_logits(
    logits: np.ndarray,
    temperature: float,
    splits: int = 10,
    shuffle_seed: Optional[int] = None,
    *,
    device=None,
) -> Tuple[float, float]:
    """Full IS* pipeline from raw logits: softmax on ``device`` (the card
    unless told otherwise), split scores on the host.

    ``shuffle_seed`` reproduces the reference's pre-split shuffle of the image
    order (inception_score_star_bird.py:85 shuffles indices before batching;
    unseeded there — an explicit seed is required for determinism).
    """
    x = torch.from_numpy(np.ascontiguousarray(logits)).to(resolve_device(device))
    probs = temperature_softmax(x, temperature).cpu().numpy()
    if shuffle_seed is not None:
        rng = np.random.RandomState(shuffle_seed)
        probs = probs[rng.permutation(probs.shape[0])]
    return inception_score(probs, splits)
