"""Reliability-diagram rendering (the port's own copy of
tise_tpu/calibration/plots.py, which imports no JAX; reference:
classifier_calibration/calibration_classifier.ipynb cells 9-19).

The notebook draws, per confidence bin: an accuracy bar ("Outputs"), a red
"Gap" bar between accuracy and confidence (split above/below the diagonal),
and the y=x diagonal.  ``render_reliability_png`` reproduces that figure
from the per-bin data of :func:`temperature.reliability_diagram` and imports
matplotlib only when called; ``ascii_reliability`` prints the same data as
a terminal table so the report works without a display.
"""
from __future__ import annotations

from typing import Sequence


def ascii_reliability(
    mean_conf: Sequence[float],
    accuracy: Sequence[float],
    fraction: Sequence[float],
    width: int = 40,
) -> str:
    """Per-bin table with an accuracy bar chart (▉ = accuracy, · = gap up to
    the bin's mean confidence)."""
    n = len(mean_conf)
    lines = ["bin        conf    acc     frac    |" + " " * width + "|"]
    for i in range(n):
        lo, hi = i / n, (i + 1) / n
        a, c, f = accuracy[i], mean_conf[i], fraction[i]
        acc_w = int(round(a * width))
        gap_w = max(0, int(round(c * width)) - acc_w)
        bar = "#" * acc_w + "." * gap_w + " " * (width - acc_w - gap_w)
        lines.append(f"{lo:.2f}-{hi:.2f}  {c:.3f}   {a:.3f}   {f:.3f}   |{bar}|")
    return "\n".join(lines)


def render_reliability_png(
    path: str,
    mean_conf: Sequence[float],
    accuracy: Sequence[float],
    ece: float,
    title: str = "",
) -> None:
    """Reference-style reliability diagram (notebook cell 13): blue accuracy
    bars, red gap bars split above/below the diagonal, dashed y=x line."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    accs = np.asarray(accuracy, dtype=np.float64)
    confs = np.asarray(mean_conf, dtype=np.float64)
    m = len(accs)
    bin_size = 1.0 / m
    positions = np.arange(bin_size / 2, 1.0, bin_size)[:m]

    gap_below = np.clip(confs - accs, 0, None)
    gap_above = np.clip(accs - confs, 0, None)

    fig, ax = plt.subplots(figsize=(6, 6))
    bars_acc = ax.bar(
        positions, accs, width=bin_size, edgecolor="black", color="#00A4CCFF", label="Outputs", zorder=2
    )
    bars_gap = ax.bar(
        positions, gap_above, width=bin_size, bottom=confs,
        edgecolor="red", color="red", alpha=0.3, linewidth=2, label="Gap", zorder=3,
    )
    ax.bar(
        positions, gap_below, width=bin_size, bottom=accs,
        edgecolor="red", color="red", alpha=0.3, linewidth=2, zorder=3,
    )
    ax.plot([0, 1], [0, 1], linestyle="--", linewidth=2)
    ax.set_aspect("equal")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.set_xlabel("Confidence")
    ax.set_ylabel("Accuracy")
    ax.legend(handles=[bars_gap, bars_acc])
    ax.set_title(f"{title} (ECE = {ece * 100:.2f}%)".strip())
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
