"""Calibration CLI (mirrors tise_tpu/calibration/cli.py; reference:
classifier_calibration/ notebook + temperature_scaling.py).

    python -m tise_tpu_torch.calibration.cli --validation_npz val.npz \\
        [--n_bins 15] [--max_iter 50] [--plot_prefix P] [--device cpu]

Fits a temperature on cached validation logits (the notebook's
``data/*_validation_feature_data.npz``, cells 3-7) and prints the
before/after NLL/ECE report (temperature_scaling.py:56-75) and the per-bin
reliability table; ``--plot_prefix P`` also writes ``P_before.png`` and
``P_after.png`` (notebook cells 13-19; needs matplotlib).  The fitted
constant is what the IS*/O-IS metrics bake in (core/config.py).  The NLL
and its gradient run on the card unless --device cpu; ``--max_iter`` bounds
the L-BFGS-B iterations (the JAX CLI parses it and keeps 50).
"""

from __future__ import annotations

import argparse

from tise_tpu_torch.calibration import plots
from tise_tpu_torch.calibration import temperature as calib
from tise_tpu_torch.core.config import add_device_flag, configure_precision


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--validation_npz", type=str, required=True, help="npz with logits + labels arrays")
    p.add_argument("--n_bins", type=int, default=15)
    p.add_argument("--max_iter", type=int, default=50)
    p.add_argument(
        "--plot_prefix", type=str, default=None,
        help="write <prefix>_before.png / <prefix>_after.png reliability diagrams",
    )
    add_device_flag(p)
    args = p.parse_args(argv)

    configure_precision("highest")
    logits, labels = calib.load_validation_npz(args.validation_npz)
    t, nll_b, ece_b, nll_a, ece_a = calib.calibration_report(logits, labels, args.n_bins, args.max_iter,
                                                             device=args.device)
    print(f"Before temperature - NLL: {nll_b:.5f}, ECE: {ece_b:.5f}")
    print(f"Optimal temperature: {t!r}")
    print(f"After temperature - NLL: {nll_a:.5f}, ECE: {ece_a:.5f}")

    for tag, temp, ece_val in (("before", 1.0, ece_b), ("after", t, ece_a)):
        conf, acc, frac = calib.reliability_diagram(logits, labels, args.n_bins, temperature=temp)
        print(f"\nReliability ({tag} calibration, T={temp:.6g}):")
        print(plots.ascii_reliability(conf, acc, frac))
        if args.plot_prefix:
            out = f"{args.plot_prefix}_{tag}.png"
            plots.render_reliability_png(out, conf, acc, ece_val, title=f"{tag} calibration")
            print(f"wrote {out}")


if __name__ == "__main__":
    main()
