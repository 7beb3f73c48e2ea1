"""Result-file and statistics IO for the FID slice (mirrors tise_tpu/core/io.py).

Byte-identical to the reference formats:
  FID   -> ``FID: <float>``    (fid_score.py:252)
  O-FID -> ``O-FID: <float>``  (O-FID/fid_score.py:220-222)
Reference statistics are npz archives with ``mu``/``sigma`` arrays
(fid_score.py:200-203).
"""

from __future__ import annotations

import os
import re
from typing import List, Tuple

import numpy as np


def _write(path: str, text: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def write_fid_result(path: str, fid: float) -> None:
    _write(path, f"FID: {fid}")


def write_o_fid_result(path: str, value: float) -> None:
    _write(path, f"O-FID: {value}")


def _floats(path: str) -> List[float]:
    """All float literals in the file, in order."""
    with open(path) as f:
        text = f.read()
    return [float(v) for v in re.findall(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?", text)]


def read_fid_result(path: str) -> float:
    return _floats(path)[0]


def load_stats_npz(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load cached activation statistics (reference fid_score.py:200-203)."""
    with np.load(path, allow_pickle=True) as f:
        return np.array(f["mu"]), np.array(f["sigma"])


def save_stats_npz(path: str, mu: np.ndarray, sigma: np.ndarray) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez(path, mu=mu, sigma=sigma)
