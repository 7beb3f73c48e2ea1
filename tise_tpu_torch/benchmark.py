"""One-command track runner for the port (mirrors tise_tpu/benchmark.py): the
COCO track's nine metrics and the ranking table, and the CUB track, IS*, FID
and RP (DAMSM) (README.md:178-433 of the reference).

    python -m tise_tpu_torch.benchmark --track coco --method_name my_model \\
        --images gen/coco --soa_images gen/soa --pa_images gen/pa \\
        --data_root data --weights_root weights --output_root results \\
        [--precision fast] [--sqrtm eigh] [--only fid,is_star] [--skip soa] [--resume] [--device cuda]
    python -m tise_tpu_torch.benchmark --track cub --method_name my_model \\
        --images gen/cub --data_root data --weights_root weights --output_root results

Each stage runs one of the port's metric CLIs over the standard data and
weights layout (the reference's download layout; ``DATA``/``WEIGHTS``) with
the JAX runner's argv and ``--device`` appended (and ``--sqrtm`` on FID and
O-FID where it is not ``scipy``), then parses its result file
back.  A stage whose inputs are missing, or that needs a stage that did not
complete (O-IS and O-FID need crop), is skipped with a note; a stage that
fails prints ``FAIL`` and the run goes on.  The values go to
``metrics.json`` and the stages' wall-clocks to ``timings.json`` under
``<output_root>/<method_name>/``.  ``--resume`` parses a stage whose result
file exists instead of running it again (crop by its ``crop.done``
sentinel), runs again a stage whose upstream ran again, and refuses when the
existing results were made with other result-affecting flags
(``run_config.json``).  On the COCO track the runner then writes the methods
JSON (the reference's 2-decimal rounding; RP, SOA and PA x100) and, when all
nine values are there, ranks it with the other methods of ``--methods_dir``
into ``<output_root>/benchmark_results.txt``.  The JAX runner's persistent
compile cache is TPU-only and has no counterpart here.
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

#: relative paths under --data_root / --weights_root, as tise_tpu/benchmark.py:38-64
#: (the reference's download layout and the converted-weight names)
DATA = {
    "coco_fid_stats": "image_realism/FID/data/coco_val.npz",
    "cub_fid_stats": "image_realism/FID/data/bird_val.npz",
    "o_fid_stats": "object_fidelity/O-FID/data/cropped_object_coco.npz",
    "coco_rp_captions": "text_relevance/captions/COCO_RP_captions.pkl",
    "cub_rp_captions": "text_relevance/captions/CUB_RP_captions.pkl",
    "pa_captions": "positional_alignment/captions/PA_input_captions.pkl",
    "ca_captions": "counting_alignment/captions/CA_input_captions.pkl",
    "cub_captions_pickle": "text_to_images_models/data/birds/captions.pickle",
}
WEIGHTS = {
    "inception": "inception_v3_torchvision.pth",
    "inception_2015": "inception_2015.npz",
    "inception_cub": "birds_valid299.npz",
    "inception_80": "object_fidelity/weights/inceptionv3_fine_to_with_80_coco_classes.pth",
    "clip": "clip_vit_b32.pt",
    "clip_bpe": "bpe_simple_vocab_16e6.txt.gz",
    "detector_soa": "semantic_object_accuracy/weights/coco_mask_rcnn_detector.pkl",
    "detector_crop": "object_fidelity/weights/model_final_f10217.pkl",
    "counter": "counting_alignment/weights/coco14.pt",
    "damsm_text": "text_to_images_models/DAMSMencoders/bird/text_encoder200.pth",
    "damsm_image": "text_to_images_models/DAMSMencoders/bird/image_encoder200.pth",
}


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
    after: Sequence[str] = ()  # stages that must have completed first
    #: the result file; with ``--resume`` a stage whose result exists is parsed, not run
    result: str = ""


@dataclass
class Plan:
    stages: List[Stage] = field(default_factory=list)
    #: wall-clock seconds of each stage that ran, filled by execute()
    timings: Dict[str, float] = field(default_factory=dict)

    def execute(self, resume: bool = False) -> Dict[str, float]:
        values: Dict[str, float] = {}
        done = set()
        ran = set()  # the stages that ran in this run (not parsed from an earlier one)
        for st in self.stages:
            missing = [p for p in st.inputs if not p or not os.path.exists(p)]
            failed_deps = [d for d in st.after if d not in done]
            if missing or failed_deps:
                why = "; ".join((["missing: " + ", ".join(missing)] if missing else [])
                                + (["needs: " + ", ".join(failed_deps)] if failed_deps else []))
                print(f"[benchmark] SKIP {st.name} ({why})")
                continue
            # a stage whose upstream ran again in this run (crop made the crops anew) is stale: run it again
            stale_deps = [d for d in st.after if d in ran]
            if resume and stale_deps:
                print(f"[benchmark] RESUME {st.name} skipped (upstream re-ran: {', '.join(stale_deps)})")
            if resume and not stale_deps and st.result and os.path.exists(st.result):
                try:
                    values.update(st.parse())
                    done.add(st.name)
                    print(f"[benchmark] RESUME {st.name} (parsed existing {st.result})")
                    continue
                except Exception as e:  # noqa: BLE001 — a stale or partial result runs again
                    print(f"[benchmark] RESUME {st.name} unparseable ({e}); re-running")
            print(f"[benchmark] RUN  {st.name}")
            t0 = time.perf_counter()
            try:
                st.run()
                values.update(st.parse())
                done.add(st.name)
                ran.add(st.name)
                self.timings[st.name] = round(time.perf_counter() - t0, 2)
                print(f"[benchmark] DONE {st.name} in {self.timings[st.name]:.1f}s")
            except Exception as e:  # noqa: BLE001 — one stage must not end the run
                print(f"[benchmark] FAIL {st.name}: {type(e).__name__}: {e}")
        return values


def _sqrtm_flags(args) -> List[str]:
    """The FID and O-FID stages' ``--sqrtm``, passed only when it is not the
    reference's ``scipy`` (the JAX runner has no such flag)."""
    return ["--sqrtm", args.sqrtm] if args.sqrtm != "scipy" else []


def _coco_plan(args, out: str) -> Plan:
    """The nine-metric COCO track, with tise_tpu/benchmark.py's argv
    (:146-302) and ``--device``."""
    from tise_tpu_torch.metrics import ca, crop_objects, fid, is_star, o_fid, o_is, pa, rp_coco, soa

    d = lambda key: os.path.join(args.data_root, DATA[key])  # noqa: E731
    w = lambda key: resolve_weight(os.path.join(args.weights_root, WEIGHTS[key]))  # noqa: E731
    prec = ["--precision", args.precision]
    # the FID and O-FID CLIs keep the reference's dashed --batch-size (fid_score.py:53), the others underscore
    bs = ["--batch-size", str(args.batch_size)] if args.batch_size else []
    bs_u = ["--batch_size", str(args.batch_size)] if args.batch_size else []
    # the detection stages' presets, passed only when they differ from the CLIs' defaults
    det = (["--roi-sampling", str(args.roi_sampling)] if args.roi_sampling != 2 else []) + (
        ["--proposals", str(args.proposals)] if args.proposals != 1000 else [])
    sq = _sqrtm_flags(args)
    dev = ["--device", args.device]
    crops_dir = os.path.join(out, "crops")
    crop_done = os.path.join(out, "crop.done")
    plan = Plan()

    def txt(name: str) -> str:
        return os.path.join(out, f"{name}.txt")

    def snap(name: str) -> str:
        return os.path.join(out, f"{name}.snapshot.npz")

    plan.stages.append(Stage(
        "fid",
        [args.images, d("coco_fid_stats"), w("inception")],
        lambda: fid.main(["--path1", d("coco_fid_stats"), "--path2", args.images,
                          "--saved_file", txt("fid"), "--weights", w("inception"),
                          "--snapshot_dir", out] + prec + bs + sq + dev),
        lambda: {"FID": result_io.read_fid_result(txt("fid"))},
        result=txt("fid"),
    ))
    plan.stages.append(Stage(
        "is_star",
        [args.images, w("inception_2015")],
        lambda: is_star.main(["--image_folder", args.images, "--flavor", "coco",
                              "--saved_file", txt("is_star"), "--weights", w("inception_2015"),
                              "--snapshot_file", snap("is_star")] + prec + bs_u + dev),
        lambda: {"IS*": result_io.read_is_coco_result(txt("is_star"))[0]},
        result=txt("is_star"),
    ))
    plan.stages.append(Stage(
        "rp",
        [args.images, d("coco_rp_captions"), w("clip"), w("clip_bpe")],
        lambda: rp_coco.main(["--image_dir", args.images, "--rp_input_file", d("coco_rp_captions"),
                              "--saved_file_path", txt("rp"), "--weights", w("clip"), "--bpe_path", w("clip_bpe"),
                              "--snapshot_file", snap("rp")] + prec + bs_u + dev),
        lambda: {"RP": result_io.read_rp_coco_result(txt("rp"))[0] * 100},
        result=txt("rp"),
    ))
    plan.stages.append(Stage(
        "soa",
        [args.soa_images, w("detector_soa")],
        lambda: soa.main(["--images", args.soa_images, "--detected_results", os.path.join(out, "soa_detections"),
                          "--saved_file", txt("soa"), "--weights", w("detector_soa")] + prec + det + dev),
        lambda: dict(zip(("SOA-C", "SOA-I"), [v * 100 for v in result_io.read_soa_result(txt("soa"))[:2]])),
        result=txt("soa"),
    ))
    plan.stages.append(Stage(
        "pa",
        [args.pa_images, d("pa_captions"), w("clip"), w("clip_bpe")],
        lambda: pa.main(["--image_dir", args.pa_images, "--pa_input_file", d("pa_captions"),
                         "--saved_file_path", txt("pa"), "--weights", w("clip"), "--bpe_path", w("clip_bpe"),
                         "--snapshot_file", snap("pa")] + prec + bs_u + dev),
        lambda: {"PA": result_io.read_pa_result(txt("pa")) * 100},
        result=txt("pa"),
    ))
    plan.stages.append(Stage(
        "ca",
        [args.images, d("ca_captions"), w("counter")],
        lambda: ca.main(["--image_dir", args.images, "--ct_input_file", d("ca_captions"),
                         "--result_file", txt("ca"), "--weights", w("counter"),
                         "--snapshot_file", snap("ca")] + prec + bs_u + dev),
        lambda: {"CA": result_io.read_ca_result(txt("ca"))},
        result=txt("ca"),
    ))

    def run_crop() -> None:
        # a run's crop.done says its crops are whole; the crop CLI removes the
        # old crops unless it resumes, so the old sentinel goes first (the JAX
        # runner keeps both)
        if os.path.exists(crop_done):
            os.remove(crop_done)
        crop_objects.main(["--source_image_dir", args.images, "--saved_cropped_object_dir", crops_dir,
                           "--weights", w("detector_crop")] + prec + det + dev)
        # the sentinel of a finished run: a killed run leaves a partial crops dir, which --resume must not trust
        with open(crop_done, "w") as f:
            f.write("ok\n")

    plan.stages.append(Stage("crop", [args.images, w("detector_crop")], run_crop, lambda: {}, result=crop_done))
    plan.stages.append(Stage(
        "o_is",
        [w("inception_80")],
        lambda: o_is.main(["--image_dir", crops_dir, "--saved_file", txt("o_is"), "--weights", w("inception_80"),
                           "--snapshot_file", snap("o_is")] + prec + bs_u + dev),
        lambda: {"O-IS": result_io.read_o_is_result(txt("o_is"))[0]},
        after=("crop",),
        result=txt("o_is"),
    ))
    plan.stages.append(Stage(
        "o_fid",
        [d("o_fid_stats"), w("inception_80")],
        lambda: o_fid.main(["--path1", d("o_fid_stats"), "--path2", crops_dir, "--saved_file", txt("o_fid"),
                            "--weights", w("inception_80"), "--snapshot_dir", out] + prec + bs + sq + dev),
        lambda: {"O-FID": result_io.read_fid_result(txt("o_fid"))},
        after=("crop",),
        result=txt("o_fid"),
    ))
    return plan


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
    sq = _sqrtm_flags(args)
    dev = ["--device", args.device]
    plan = Plan()

    def txt(name: str) -> str:
        return os.path.join(out, f"{name}.txt")

    plan.stages.append(Stage(
        "fid",
        [args.images, d("cub_fid_stats"), w("inception")],
        lambda: fid.main(["--path1", d("cub_fid_stats"), "--path2", args.images,
                          "--saved_file", txt("fid"), "--weights", w("inception"),
                          "--snapshot_dir", out] + tail + bs + sq + dev),
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


def assemble_methods_json(values: Dict[str, float], path: str) -> bool:
    """Write the ranking methods JSON (the reference's key order and 2-decimal
    rounding, ranking_scores/methods/*.json).  True when all nine metrics
    are there (only then can the method be ranked)."""
    from tise_tpu_torch.ranking.ranking_score import METRICS

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rounded = {m: round(values[m], 2) for m in METRICS if m in values}
    with open(path, "w") as f:
        json.dump(rounded, f)
    return len(rounded) == len(METRICS)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--track", choices=("coco", "cub"), required=True)
    p.add_argument("--method_name", type=str, required=True, help="row name of the method")
    p.add_argument("--images", type=str, required=True, help="flat <caption_id>.png dir")
    p.add_argument("--soa_images", type=str, default="", help="(coco) label_XX folder root")
    p.add_argument("--pa_images", type=str, default="", help="(coco) positional-word folder root")
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--weights_root", type=str, default="weights")
    p.add_argument("--output_root", type=str, default="results")
    p.add_argument("--methods_dir", type=str, default=None,
                   help="(coco) existing ranking methods/*.json dir to rank against (the new method's JSON "
                        "is added to it); default <output_root>/methods")
    p.add_argument("--precision", choices=("highest", "fast"), default="highest")
    p.add_argument("--batch_size", type=int, default=0,
                   help="override every stage's batch size (0 = per-CLI defaults); the detection stages size "
                        "their own micro-batches")
    p.add_argument("--roi-sampling", dest="roi_sampling", type=int, default=2, choices=(1, 2),
                   help="(coco) ROIAlign samples a bin of the soa and crop stages; 1 is the fast preset")
    p.add_argument("--proposals", type=int, default=1000,
                   help="(coco) post-NMS RPN proposals of the soa and crop stages; 256 is the fast preset")
    p.add_argument("--sqrtm", choices=("scipy", "eigh", "ns", "ns-pallas"), default="scipy",
                   help="the FID and O-FID stages' matrix square root (their CLIs' --sqrtm); scipy is the "
                        "reference's; eigh takes the trace term in float64 from two symmetric eigendecompositions")
    p.add_argument("--only", type=str, default="", help="comma-separated stage names to run")
    p.add_argument("--skip", type=str, default="", help="comma-separated stage names to skip")
    p.add_argument("--resume", action="store_true",
                   help="parse stages whose result file already exists under --output_root instead of "
                        "running them again (unparseable results run again; crop uses a crop.done sentinel)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of every stage; 'cuda' (default) raises when no card is found, "
                        "'cpu' must be asked for")
    args = p.parse_args(argv)
    resolve_device(args.device)

    out = os.path.join(args.output_root, args.method_name)
    os.makedirs(out, exist_ok=True)
    # the result-affecting flags, so that --resume cannot mix results made under two of them;
    # batch_size is left out: the values do not depend on it
    effective = {"track": args.track, "precision": args.precision,
                 "roi_sampling": args.roi_sampling, "proposals": args.proposals}
    if args.sqrtm != "scipy":  # recorded only when set, so that a default run's file stays the JAX runner's
        effective["sqrtm"] = args.sqrtm
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
    plan = _coco_plan(args, out) if args.track == "coco" else _cub_plan(args, out)
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

    if args.track == "coco":
        methods_dir = args.methods_dir or os.path.join(args.output_root, "methods")
        if assemble_methods_json(values, os.path.join(methods_dir, f"{args.method_name}.json")):
            from tise_tpu_torch.ranking import ranking_score

            table_path = os.path.join(args.output_root, "benchmark_results.txt")
            ranking_score.main(["--methods_dir", methods_dir, "--output", table_path])
            print(f"[benchmark] ranking table -> {table_path}")
        else:
            print("[benchmark] not all nine metrics computed; ranking skipped (methods JSON holds the partial set)")
    return values


if __name__ == "__main__":
    main()
