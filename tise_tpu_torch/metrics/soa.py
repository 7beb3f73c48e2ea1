"""SOA, Semantic Object Accuracy (mirrors tise_tpu/metrics/soa.py; reference:
semantic_object_accuracy/SOA.py).

Layout: 80 per-label folders ``label_XX_XX/`` of generated images
(README.md:117-135).  Stage 1 runs the detector over each folder and caches
``detected_<label>.pkl`` ({filename: [names, ids, boxes]}, SOA.py:86-107),
skipping folders whose pickle exists (:77-79, the resume).  Stage 2 is host
arithmetic:
  * per-label recall: the share of images with >= 1 detection of the label
    (:110-123)
  * SOA-C = unweighted mean of the recalls (:126-132)
  * SOA-I = image-count-weighted mean (:135-144)
  * top/bot-40: labels sorted by image count, each half summed / (0.5 n)
    (:147-165)
A label's id is the number after "label" in the folder name (util.py:16-22).
Pickles of either package, or of the reference, are interchangeable.  The
JAX CLI's multi-host sharding and TPU backend reset are left out.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from tise_tpu_torch.core import io as result_io
from tise_tpu_torch.metrics.crop_objects import add_detector_flags, build_detector, report

#: detector output per image: ([class names], [class ids], [xyxy boxes])
Detections = Tuple[List[str], List[int], List[np.ndarray]]
DetectorFn = Callable[[Sequence[str]], Dict[str, Detections]]


def label_from_filename(path: str) -> int:
    """Label id from a ``label_NN...`` path: the two characters after
    ``label_`` parsed as int, falling back to one (util.py:16-22)."""
    idx = path.find("label_")
    try:
        return int(path[idx + 6: idx + 8])
    except ValueError:
        return int(path[idx + 6: idx + 7])


def run_detection(images_root: str, detected_dir: str, detector: DetectorFn, *, expect_folders: int = 80) -> int:
    """Stage 1: one detection sweep a label folder, each saved as its own
    pickle, so a killed run repeats at most one label (SOA.py:45-107).
    Returns the number of images detected."""
    dirs = [d for d in sorted(os.listdir(images_root)) if os.path.isdir(os.path.join(images_root, d))]
    if len(dirs) != expect_folders:
        print(
            f"WARNING: expected {expect_folders} label folders, found {len(dirs)} in {images_root}; "
            "results will not be conclusive."
        )
    os.makedirs(detected_dir, exist_ok=True)
    images = 0
    for d in dirs:
        out_pkl = os.path.join(detected_dir, f"detected_{d}.pkl")
        if os.path.isfile(out_pkl):
            print(f"Detection already run for {d}; skipping.")
            continue
        folder = os.path.join(images_root, d)
        files = [os.path.join(folder, f) for f in sorted(os.listdir(folder))]
        preds = detector(files)
        images += len(files)
        output: Dict[str, Detections] = {}
        for path, (names, ids, boxes) in preds.items():
            if len(ids) > 0:
                output[os.path.basename(path)] = [list(names), list(ids), list(boxes)]
        result_io.save_pickle(out_pkl + ".tmp", output)  # a killed write leaves no pickle to skip
        os.replace(out_pkl + ".tmp", out_pkl)
    return images


def recall_for_label(detections: Dict[str, Detections], label: int) -> Tuple[float, int, int]:
    """(accuracy, recognized, total): images with >= 1 detection of ``label``
    (SOA.py:110-123)."""
    total = len(detections)
    if total == 0:
        return 0.0, 0, 0
    recognized = 0
    for det in detections.values():
        if any(int(c) == label for c in det[1]):
            recognized += 1
    return recognized / total, recognized, total


def soa_scores(results: Dict[int, Dict[str, float]]) -> Tuple[float, float, float, float]:
    """(SOA-C, SOA-I, top40, bot40) from per-label {accuracy, images_total}."""
    labels = list(results.keys())
    n = len(labels)
    soa_c = sum(results[l]["accuracy"] for l in labels) / n
    total_images = sum(results[l]["images_total"] for l in labels)
    soa_i = sum(results[l]["images_total"] * results[l]["accuracy"] for l in labels) / total_images
    by_count = sorted(labels, key=lambda l: results[l]["images_total"])
    bot = sum(results[l]["accuracy"] for l in by_count[:40])
    top = sum(results[l]["accuracy"] for l in by_count[40:])
    return soa_c, soa_i, top / (0.5 * n), bot / (0.5 * n)


def calc_soa(detected_dir: str, saved_file: str) -> Tuple[float, float, float, float]:
    """Stage 2 (SOA.py:168-216): aggregate the detection pickles, in
    ``os.listdir`` order as the JAX package does (that order is the
    insertion order of ``result_file.pkl``'s dict), and write
    ``result_file.pkl`` beside them and the result file."""
    files = [
        os.path.join(detected_dir, f)
        for f in os.listdir(detected_dir)
        if f.startswith("detected_") and f.endswith(".pkl")
    ]
    results: Dict[int, Dict[str, float]] = {}
    for path in files:
        dets = result_io.load_pickle(path)
        label = label_from_filename(path)
        acc, recognized, total = recall_for_label(dets, label)
        results[label] = {"accuracy": acc, "images_recognized": recognized, "images_total": total}
    soa_c, soa_i, top40, bot40 = soa_scores(results)
    print(f"Class average accuracy for all classes (SOA-C) is: {soa_c:6.4f}")
    print(f"Image weighted average accuracy (SOA-I) is: {soa_i:6.4f}")
    print(f"Top40 / Bot40: {top40:6.4f} / {bot40:6.4f}")
    result_io.save_pickle(os.path.join(detected_dir, "result_file.pkl"), results)
    if saved_file:
        result_io.write_soa_result(saved_file, soa_c, soa_i, top40, bot40)
    return soa_c, soa_i, top40, bot40


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--images", type=str, required=True, help="root of 80 per-label folders")
    p.add_argument("--detected_results", type=str, default="output")
    p.add_argument("--saved_file", type=str, default="")
    p.add_argument("--skip_detection", action="store_true", help="aggregate cached pickles only")
    add_detector_flags(p)
    args = p.parse_args(argv)

    if not args.skip_detection:
        detector = build_detector(args)
        t0 = time.perf_counter()
        images = run_detection(args.images, args.detected_results, detector)
        report("soa", detector, images, time.perf_counter() - t0)
    calc_soa(args.detected_results, args.saved_file)


if __name__ == "__main__":
    main()
