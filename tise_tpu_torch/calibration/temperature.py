"""Classifier calibration: temperature scaling and ECE in PyTorch (mirrors
tise_tpu/calibration/temperature.py; reference:
classifier_calibration/temperature_scaling.py).

A single scalar temperature is fit to minimise the NLL of cached
validation logits (:34-77); ``_ECELoss`` (:80-119) bins the max softmax
confidence into 15 equal bins and sums |accuracy - confidence| weighted by
bin occupancy.  As in the JAX package, the fit is scipy's L-BFGS-B from
``log T = 0`` on the NLL and its gradient in f32, here from torch autograd on
``device``; ECE and the reliability table are numpy in float64 on the host,
copied.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tise_tpu_torch.core.config import resolve_device


def nll(log_t: torch.Tensor, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of logits / exp(log_t) (log-parametrised for
    positivity)."""
    return F.cross_entropy(logits / torch.exp(log_t), labels)


def _tensors(logits: np.ndarray, labels: np.ndarray, device) -> Tuple[torch.Tensor, torch.Tensor]:
    device = resolve_device(device)
    return (torch.as_tensor(np.asarray(logits, np.float32), device=device),
            torch.as_tensor(np.asarray(labels, np.int64), device=device))


def nll_at(temperature: float, logits: np.ndarray, labels: np.ndarray, device=None) -> float:
    """The f32 NLL at ``temperature`` (log T rounded to f32, as the JAX package does)."""
    lt, yt = _tensors(logits, labels, device)
    log_t = torch.tensor(np.float32(np.log(temperature)), device=lt.device)
    with torch.no_grad():
        return float(nll(log_t, lt, yt))


def fit_temperature(logits: np.ndarray, labels: np.ndarray, max_iter: int = 50, device=None) -> float:
    """Fit T minimising NLL (reference ModelWithTemperature.set_temperature);
    ``device=None`` is the card, and raises where there is none."""
    from scipy.optimize import minimize

    lt, yt = _tensors(logits, labels, device)

    def objective(x):
        log_t = torch.tensor(np.float32(x[0]), device=lt.device, requires_grad=True)
        v = nll(log_t, lt, yt)
        (g,) = torch.autograd.grad(v, log_t)
        return float(v.detach()), np.array([float(g)], dtype=np.float64)

    res = minimize(objective, x0=np.zeros(1), jac=True, method="L-BFGS-B", options={"maxiter": max_iter})
    return float(np.exp(res.x[0]))


def ece(logits: np.ndarray, labels: np.ndarray, n_bins: int = 15, temperature: float = 1.0) -> float:
    """Expected Calibration Error (temperature_scaling.py:80-119 semantics:
    equal-width confidence bins over (0, 1], |acc - conf| weighted by bin
    occupancy)."""
    logits = np.asarray(logits, np.float64) / temperature
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True)
    conf = probs.max(axis=1)
    pred = probs.argmax(axis=1)
    correct = pred == np.asarray(labels)
    edges = np.linspace(0, 1, n_bins + 1)
    out = 0.0
    for lo, hi in zip(edges[:-1], edges[1:]):
        in_bin = (conf > lo) & (conf <= hi)
        prop = in_bin.mean()
        if prop > 0:
            out += abs(correct[in_bin].mean() - conf[in_bin].mean()) * prop
    return float(out)


def calibration_report(
    logits: np.ndarray, labels: np.ndarray, n_bins: int = 15, max_iter: int = 50, device=None
) -> Tuple[float, float, float, float, float]:
    """(T, nll_before, ece_before, nll_after, ece_after) — the before/after
    printout of the reference (:56-75)."""
    t = fit_temperature(logits, labels, max_iter, device)
    return (t, nll_at(1.0, logits, labels, device), ece(logits, labels, n_bins),
            nll_at(t, logits, labels, device), ece(logits, labels, n_bins, temperature=t))


def reliability_diagram(
    logits: np.ndarray, labels: np.ndarray, n_bins: int = 15, temperature: float = 1.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-bin (mean confidence, accuracy, fraction of samples) — the data
    behind the notebook's reliability plots (calibration_classifier.ipynb
    cells 5-7)."""
    logits = np.asarray(logits, np.float64) / temperature
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True)
    conf = probs.max(axis=1)
    correct = probs.argmax(axis=1) == np.asarray(labels)
    edges = np.linspace(0, 1, n_bins + 1)
    mean_conf = np.zeros(n_bins)
    accuracy = np.zeros(n_bins)
    fraction = np.zeros(n_bins)
    for i, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
        in_bin = (conf > lo) & (conf <= hi)
        fraction[i] = in_bin.mean()
        if in_bin.any():
            mean_conf[i] = conf[in_bin].mean()
            accuracy[i] = correct[in_bin].mean()
    return mean_conf, accuracy, fraction


def load_validation_npz(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load a ``*_validation_feature_data.npz`` cache (notebook cell 3 format:
    arrays of logits and integer labels; accepts common key spellings)."""
    with np.load(path, allow_pickle=True) as f:
        keys = set(f.files)
        logit_key = next(k for k in ("logits", "features", "preds") if k in keys)
        label_key = next(k for k in ("labels", "targets", "y") if k in keys)
        return np.array(f[logit_key]), np.array(f[label_key])
