"""Aggregate Ranking Score (RS) (mirrors tise_tpu/ranking/ranking_score.py;
reference: ranking_scores/ranking_score.py).

  * nine metrics per method, read from ``methods/<name>.json``;
  * FID, O-FID and CA are lower-is-better and change sign before ranking
    (:33-35);
  * per metric, methods are ranked ascending (the best method gets rank
    ``num_methods``): rank = 1 + the method's position in numpy's quicksort
    argsort of the signed scores (:36-45), whose order of ties is part of
    the result;
  * the ranks are grouped into six aspects (image realism mean(IS*, FID),
    RP, SOA mean(SOA-C, SOA-I), object fidelity mean(O-IS, O-FID), CA, PA)
    and summed into RS (:50-61);
  * the table is ``tabulate(df, headers="keys", tablefmt="psql",
    showindex=False)`` of the reference (:70-77), written here without
    pandas or tabulate (``render_table``), byte for byte.

    python -m tise_tpu_torch.ranking.ranking_score --methods_dir methods \\
        --output results/coco_benchmark_results.txt [--order "A,B,..."]
"""

from __future__ import annotations

import argparse
import json
import os
from collections import OrderedDict
from typing import List, Sequence, Tuple

import numpy as np

METRICS: Tuple[str, ...] = ("IS*", "FID", "RP", "SOA-C", "SOA-I", "O-IS", "O-FID", "CA", "PA")

#: indices of lower-is-better metrics (FID, O-FID, CA)
LOWER_IS_BETTER = (1, 6, 7)

#: aspect grouping over metric-rank indices: each entry is averaged, then summed
ASPECT_GROUPS: Tuple[Tuple[int, ...], ...] = ((0, 1), (2,), (3, 4), (5, 6), (7,), (8,))


def load_method_scores(methods_dir: str, order: Sequence[str] | None = None) -> "OrderedDict[str, List[float]]":
    """Read ``<methods_dir>/<name>.json`` score files.  ``order`` pins the
    method order (the reference uses the file system's order); the default
    is sorted names."""
    names = [f[: f.rindex(".")] for f in os.listdir(methods_dir) if f.endswith(".json")]
    if order is not None:
        missing = set(order) - set(names)
        if missing:
            raise ValueError(f"methods not found: {missing}")
        names = list(order)
    else:
        names = sorted(names)
    scores: "OrderedDict[str, List[float]]" = OrderedDict()
    for name in names:
        with open(os.path.join(methods_dir, f"{name}.json")) as f:
            vals = json.load(f)
        scores[name] = [float(vals[m]) for m in METRICS]
    return scores


def metric_ranks(scores: np.ndarray) -> np.ndarray:
    """Per-metric ranks (1 = worst ... n = best), the reference's tie order."""
    signed = scores.astype(np.float64).copy()
    for idx in LOWER_IS_BETTER:
        signed[:, idx] = -signed[:, idx]
    order = np.argsort(signed, axis=0, kind="quicksort")
    n_methods, n_metrics = signed.shape
    ranks = np.zeros_like(signed)
    for m in range(n_metrics):
        for pos in range(n_methods):
            ranks[order[pos, m], m] = pos + 1
    return ranks


def ranking_scores(scores: np.ndarray) -> np.ndarray:
    """RS per method: the sum of the aspect-averaged metric ranks."""
    ranks = metric_ranks(scores)
    rs = np.zeros(scores.shape[0])
    for group in ASPECT_GROUPS:
        rs += np.mean(ranks[:, list(group)], axis=1)
    return rs


def _after_point(text: str) -> int:
    """Characters after the decimal point (or after the exponent's ``e``)
    of a number formatted under ``"g"``; -1 for one that reads as an
    integer (tabulate's ``_afterpoint``)."""
    for mark in (".", "e"):
        if mark in text:
            return len(text) - text.rfind(mark) - 1
    return -1


def psql_table(headers: Sequence[str], labels: Sequence[str], columns: Sequence[Sequence[float]]) -> str:
    """tabulate's ``psql`` table of a text column and float columns with
    ``headers="keys"`` and no index: floats under ``"g"``, each float column
    aligned on its decimal point (right-padded to the most decimals, then
    right-aligned), the text column stripped and left-aligned, each column
    at least its header's width plus 2, one space of padding a side,
    trailing spaces cut from every line."""
    cells = [[str(v).strip() for v in labels]]
    for col in columns:
        text = [format(float(v), "g") for v in col]
        most = max(_after_point(t) for t in text)
        cells.append([t + " " * (most - _after_point(t)) for t in text])
    widths = [max([len(h) + 2] + [len(t) for t in col]) for h, col in zip(headers, cells)]

    def row(values, first_left: bool = True) -> str:
        parts = [f" {v:<{w}} " if i == 0 and first_left else f" {v:>{w}} "
                 for i, (v, w) in enumerate(zip(values, widths))]
        return ("|" + "|".join(parts) + "|").rstrip()

    rule = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    lines = [rule, row(headers), "|" + "+".join("-" * (w + 2) for w in widths) + "|"]
    lines += [row(r) for r in zip(*cells)]
    lines.append(rule)
    return "\n".join(lines)


def render_table(scores: "OrderedDict[str, List[float]]") -> str:
    """The reference's psql table: a row per method, the nine metrics and RS."""
    mat = np.array(list(scores.values()), dtype=np.float64)
    full = np.concatenate([mat, ranking_scores(mat)[:, None]], axis=1)
    return psql_table(("Method",) + METRICS + ("RS",), list(scores.keys()), list(full.T))


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--methods_dir", type=str, default="methods")
    p.add_argument("--output", type=str, default="results/coco_benchmark_results.txt")
    p.add_argument("--order", type=str, default=None, help="comma-separated method order")
    args = p.parse_args(argv)

    order = args.order.split(",") if args.order else None
    table = render_table(load_method_scores(args.methods_dir, order=order))
    if args.output:
        d = os.path.dirname(args.output)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.output, "w") as f:
            f.write(table)
    print(table)


if __name__ == "__main__":
    main()
