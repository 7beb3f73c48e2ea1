"""One-command track runner for the port (mirrors tise_tpu/benchmark.py): the
CUB track, IS*, FID and RP (DAMSM) (README.md:178-243 of the reference).

    python -m tise_tpu_torch.benchmark --track cub --method_name my_model \\
        --images gen/cub --data_root data --weights_root weights \\
        --output_root results [--precision fast] [--only fid,rp] [--skip is_star] \\
        [--resume] [--device cuda]

Each stage runs one of the port's metric CLIs over the standard data and
weights layout (the reference's download layout; ``DATA``/``WEIGHTS``) with
the JAX runner's argv and ``--device`` appended, then parses its result file
back.  A stage whose inputs are missing is skipped with a note; a stage that
fails prints ``FAIL`` and the run goes on.  The values go to
``metrics.json`` and the stages' wall-clocks to ``timings.json`` under
``<output_root>/<method_name>/``.  ``--resume`` parses a stage whose result
file exists instead of running it again, and refuses when the existing
results were made with other result-affecting flags (``run_config.json``).

The COCO track needs the detector (SOA, crop, O-IS and O-FID over the crops)
and the counter (CA), which are not ported yet: ``--track coco`` says so and
exits.  The JAX runner's persistent compile cache is TPU-only and has no
counterpart here.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from tise_tpu_torch.core import io as result_io
from tise_tpu_torch.core.config import resolve_device

#: relative paths under --data_root / --weights_root: the CUB track's entries of
#: tise_tpu/benchmark.py:38-64 (the reference's download layout)
DATA = {
    "cub_fid_stats": "image_realism/FID/data/bird_val.npz",
    "cub_rp_captions": "text_relevance/captions/CUB_RP_captions.pkl",
    "cub_captions_pickle": "text_to_images_models/data/birds/captions.pickle",
}
WEIGHTS = {
    "inception": "inception_v3_torchvision.pth",
    "inception_cub": "birds_valid299.npz",
    "damsm_text": "text_to_images_models/DAMSMencoders/bird/text_encoder200.pth",
    "damsm_image": "text_to_images_models/DAMSMencoders/bird/image_encoder200.pth",
}
#: the COCO track's stages that need modules the port does not have yet
COCO_NOT_PORTED = ("soa", "ca", "crop", "o_is over the crops", "o_fid over the crops", "the ranking table")


def resolve_weight(path: str) -> str:
    """Accept a converted ``.npz`` sibling of the documented checkpoint name."""
    if os.path.exists(path):
        return path
    alt = os.path.splitext(path)[0] + ".npz"
    return alt if os.path.exists(alt) else path


@dataclass
class Stage:
    """One metric run: inputs to check, CLI argv to run, result parse."""

    name: str
    inputs: List[str]  # paths that must exist
    run: Callable[[], None]
    parse: Callable[[], Dict[str, float]]
    #: the result file; with ``--resume`` a stage whose result exists is parsed, not run
    result: str = ""


@dataclass
class Plan:
    stages: List[Stage] = field(default_factory=list)
    #: wall-clock seconds of each stage that ran, filled by execute()
    timings: Dict[str, float] = field(default_factory=dict)

    def execute(self, resume: bool = False) -> Dict[str, float]:
        values: Dict[str, float] = {}
        for st in self.stages:
            missing = [p for p in st.inputs if not p or not os.path.exists(p)]
            if missing:
                print(f"[benchmark] SKIP {st.name} (missing: {', '.join(missing)})")
                continue
            if resume and st.result and os.path.exists(st.result):
                try:
                    values.update(st.parse())
                    print(f"[benchmark] RESUME {st.name} (parsed existing {st.result})")
                    continue
                except Exception as e:  # noqa: BLE001 — a stale or partial result runs again
                    print(f"[benchmark] RESUME {st.name} unparseable ({e}); re-running")
            print(f"[benchmark] RUN  {st.name}")
            t0 = time.perf_counter()
            try:
                st.run()
                values.update(st.parse())
                self.timings[st.name] = round(time.perf_counter() - t0, 2)
                print(f"[benchmark] DONE {st.name} in {self.timings[st.name]:.1f}s")
            except Exception as e:  # noqa: BLE001 — one stage must not end the run
                print(f"[benchmark] FAIL {st.name}: {type(e).__name__}: {e}")
        return values


def _cub_plan(args, out: str) -> Plan:
    """The CUB track: FID, IS*, RP (DAMSM), with tise_tpu/benchmark.py's argv
    (:305-360) and ``--device``."""
    from tise_tpu_torch.metrics import fid, is_star, rp_cub

    d = lambda key: os.path.join(args.data_root, DATA[key])  # noqa: E731
    w = lambda key: resolve_weight(os.path.join(args.weights_root, WEIGHTS[key]))  # noqa: E731
    tail = ["--precision", args.precision]
    # the FID CLI keeps the reference's dashed --batch-size (fid_score.py:53), the others underscore
    bs = ["--batch-size", str(args.batch_size)] if args.batch_size else []
    bs_u = ["--batch_size", str(args.batch_size)] if args.batch_size else []
    dev = ["--device", args.device]
    plan = Plan()

    def txt(name: str) -> str:
        return os.path.join(out, f"{name}.txt")

    plan.stages.append(Stage(
        "fid",
        [args.images, d("cub_fid_stats"), w("inception")],
        lambda: fid.main(["--path1", d("cub_fid_stats"), "--path2", args.images,
                          "--saved_file", txt("fid"), "--weights", w("inception"),
                          "--snapshot_dir", out] + tail + bs + dev),
        lambda: {"FID": result_io.read_fid_result(txt("fid"))},
        result=txt("fid"),
    ))
    plan.stages.append(Stage(
        "is_star",
        [args.images, w("inception_cub")],
        lambda: is_star.main(["--image_folder", args.images, "--flavor", "cub",
                              "--saved_file", txt("is_star"), "--weights", w("inception_cub"),
                              "--snapshot_file", os.path.join(out, "is_star.snapshot.npz")] + tail + bs_u + dev),
        lambda: {"IS*": result_io.read_is_result(txt("is_star"))[0]},
        result=txt("is_star"),
    ))
    plan.stages.append(Stage(
        "rp",
        [args.images, d("cub_rp_captions"), d("cub_captions_pickle"), w("damsm_text"), w("damsm_image")],
        lambda: rp_cub.main(["--image_dir", args.images, "--rp_input_file", d("cub_rp_captions"),
                             "--saved_file_path", txt("rp"), "--captions_pickle", d("cub_captions_pickle"),
                             "--text_encoder", w("damsm_text"), "--image_encoder", w("damsm_image"),
                             "--snapshot_file", os.path.join(out, "rp.snapshot.npz")] + tail + bs_u + dev),
        lambda: {"RP": result_io.read_rp_cub_result(txt("rp"))[0] * 100},
        result=txt("rp"),
    ))
    return plan


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--track", choices=("coco", "cub"), required=True)
    p.add_argument("--method_name", type=str, required=True, help="row name of the method")
    p.add_argument("--images", type=str, required=True, help="flat <caption_id>.png dir")
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--weights_root", type=str, default="weights")
    p.add_argument("--output_root", type=str, default="results")
    p.add_argument("--precision", choices=("highest", "fast"), default="highest")
    p.add_argument("--batch_size", type=int, default=0,
                   help="override every stage's batch size (0 = per-CLI defaults)")
    p.add_argument("--only", type=str, default="", help="comma-separated stage names to run")
    p.add_argument("--skip", type=str, default="", help="comma-separated stage names to skip")
    p.add_argument("--resume", action="store_true",
                   help="parse stages whose result file already exists under --output_root instead of "
                        "running them again (unparseable results run again)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of every stage; 'cuda' (default) raises when no card is found, "
                        "'cpu' must be asked for")
    args = p.parse_args(argv)
    if args.track == "coco":
        raise SystemExit(f"[benchmark] --track coco is not ported yet: it needs {', '.join(COCO_NOT_PORTED)} "
                         "(the detector and the counter); run the ported COCO metrics one by one "
                         "(python -m tise_tpu_torch.metrics.{fid,is_star,rp_coco,pa})")
    resolve_device(args.device)

    out = os.path.join(args.output_root, args.method_name)
    os.makedirs(out, exist_ok=True)
    # the result-affecting flags, so that --resume cannot mix results made under two of them;
    # batch_size is left out: the values do not depend on it
    effective = {"track": args.track, "precision": args.precision}
    config_path = os.path.join(out, "run_config.json")
    if args.resume and os.path.exists(config_path):
        with open(config_path) as f:
            prior = json.load(f)
        if prior != effective:
            diff = {k: (prior.get(k), effective[k]) for k in effective if prior.get(k) != effective[k]}
            raise SystemExit(
                f"[benchmark] --resume refused: existing results under {out} were produced with different "
                f"flags {diff} (prior, requested); use a fresh --output_root/--method_name or delete the old "
                f"results")
    with open(config_path, "w") as f:
        json.dump(effective, f)
    plan = _cub_plan(args, out)
    if args.only:
        keep = {s.strip() for s in args.only.split(",")}
        plan.stages = [s for s in plan.stages if s.name in keep]
    if args.skip:
        drop = {s.strip() for s in args.skip.split(",")}
        plan.stages = [s for s in plan.stages if s.name not in drop]

    values = plan.execute(resume=args.resume)
    print(f"[benchmark] values: {json.dumps(values)}")
    print(f"[benchmark] stage wall-clock (s): {json.dumps(plan.timings)}")
    with open(os.path.join(out, "metrics.json"), "w") as f:
        json.dump(values, f, indent=1)
    timings_path = os.path.join(out, "timings.json")
    if args.resume and os.path.exists(timings_path):
        with open(timings_path) as f:  # keep the earlier run's wall-clocks of the stages resumed now
            plan.timings = {**json.load(f), **plan.timings}
    with open(timings_path, "w") as f:
        json.dump(plan.timings, f, indent=1)
    return values


if __name__ == "__main__":
    main()
