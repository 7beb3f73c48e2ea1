"""Result-file and statistics IO for the ported metrics (mirrors tise_tpu/core/io.py).

Byte-identical to the reference formats:
  FID      -> ``FID: <float>``                     (fid_score.py:252)
  O-FID    -> ``O-FID: <float>``                   (O-FID/fid_score.py:220-222)
  IS*      -> ``IS = <mean>  +-  <std>``           (inception_score_star_bird.py:209)
  IS* coco -> ``[Inception Score] mean: {:.5f} std: {:.5f}``
                                                   (inception_score_star_coco.py:154)
  O-IS     -> ``O-IS: <mean> +-  <std>``           (object_centric_inception_score.py:127)
  RP coco  -> ``R-precision: <mean> +- <std>``     (RP_coco.py:90)
  RP cub   -> ``R mean:{:.6f} std:{:.6f}``         (RP_cub.py:162)
  PA       -> ``PA = <float>``                     (PA.py:71)
  CA       -> ``CA = <float>``                     (CA.py:191)
  SOA      -> three lines                          (SOA.py:209-216)
Reference statistics are npz archives with ``mu``/``sigma`` arrays
(fid_score.py:200-203); the RP and PA inputs are pickles.

The readers invert the writers for the track runner (benchmark.py).  A file
that holds fewer numbers than its format, such as ``FID: nan``, raises a
``ValueError`` that names the file and quotes its text.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Any, List, Tuple

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


def write_is_result(path: str, mean: float, std: float) -> None:
    _write(path, f"IS = {mean}  +-  {std}")


def write_is_coco_result(path: str, mean: float, std: float) -> None:
    _write(path, "[Inception Score] mean: {:.5f} std: {:.5f}".format(mean, std))


def write_o_is_result(path: str, mean: float, std: float) -> None:
    _write(path, f"O-IS: {mean} +-  {std}")


def write_rp_coco_result(path: str, mean: float, std: float) -> None:
    _write(path, f"R-precision: {mean} +- {std}")


def write_rp_cub_result(path: str, mean: float, std: float) -> None:
    _write(path, "R mean:{:.6f} std:{:.6f}".format(mean, std))


def write_pa_result(path: str, pa: float) -> None:
    _write(path, f"PA = {pa}")


def write_ca_result(path: str, ca: float) -> None:
    _write(path, f"CA = {ca}")


def write_soa_result(path: str, soa_c: float, soa_i: float, top40: float, bot40: float) -> None:
    text = (
        "Class average accuracy for all classes (SOA-C) is: {:6.4f} \n".format(soa_c)
        + "Image weighted average accuracy (SOA-I) is: {:6.4f} \n".format(soa_i)
        + "Top (SOA-C-Top40) and Bottom (SOA-C-Bot40) 40 class average accuracy is: "
        "{:6.4f} and {:6.4f}".format(top40, bot40)
    )
    _write(path, text)


_FLOAT = r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?"


def _short(path: str, text: str, found: int, count: int) -> ValueError:
    return ValueError(f"{path} holds {found} of the {count} numbers of a result: {text!r}")


def _floats(path: str, count: int) -> List[float]:
    """The first ``count`` float literals in the file, in order."""
    with open(path) as f:
        text = f.read()
    values = [float(v) for v in re.findall(_FLOAT, text)]
    if len(values) < count:
        raise _short(path, text, len(values), count)
    return values[:count]


def read_fid_result(path: str) -> float:
    return _floats(path, 1)[0]


def read_is_result(path: str) -> Tuple[float, float]:
    mean, std = _floats(path, 2)
    return mean, std


read_is_coco_result = read_is_result
read_o_is_result = read_is_result
read_rp_coco_result = read_is_result
read_rp_cub_result = read_is_result


def read_pa_result(path: str) -> float:
    return _floats(path, 1)[0]


read_ca_result = read_pa_result


def read_soa_result(path: str) -> Tuple[float, float, float, float]:
    """(SOA-C, SOA-I, top40, bot40): the numbers after the last colon of
    each line (the label of the third line holds two literal 40s)."""
    with open(path) as f:
        text = f.read()
    lines = [line for line in text.splitlines() if ":" in line]
    values = [float(v) for line, n in zip(lines, (1, 1, 2)) for v in re.findall(_FLOAT, line.split(":")[-1])[:n]]
    if len(values) < 4:
        raise _short(path, text, len(values), 4)
    return values[0], values[1], values[2], values[3]


def load_stats_npz(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load cached activation statistics (reference fid_score.py:200-203)."""
    with np.load(path, allow_pickle=True) as f:
        return np.array(f["mu"]), np.array(f["sigma"])


def save_stats_npz(path: str, mu: np.ndarray, sigma: np.ndarray) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez(path, mu=mu, sigma=sigma)


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(path: str, obj: Any) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)
