"""Object cropping, stage 1 of the O-metrics (mirrors
tise_tpu/metrics/crop_objects.py; reference: object_fidelity/crop_object.py).

Runs the detector (Faster R-CNN R50-FPN, score threshold 0.5,
crop_object.py:18-22) over a folder of generated images and writes every
detected box as a ``<img>_<class>_<count>.png`` crop (:25-46; ``count`` is a
running index over the whole folder).  The crops feed O-IS and O-FID.

Left out against the JAX CLI: the TPU backend reset and the multi-host
striding of files and of the index; with one process the index starts at 0
and steps by 1.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time
from typing import Sequence

from PIL import Image

from tise_tpu_torch.backbones.detection import predictor
from tise_tpu_torch.backbones.detection.coco_classes import COCO_CLASSES
from tise_tpu_torch.core.config import add_device_flag, add_precision_flag, configure_precision, resolve_device


def crop_folder(
    detector,
    src_dir: str,
    dest_dir: str,
    *,
    class_names: Sequence[str] = COCO_CLASSES,
    slab: int = 1024,
    progress: bool = True,
) -> int:
    """Detect and crop every image of ``src_dir`` (sorted); returns the
    number of crops written.  Boxes under a pixel wide or high are skipped
    (PIL cannot save them).

    Files run in slabs of ``slab``.  After each slab its crops are on disk
    and a sentinel (``.crop_progress_0.json`` in ``dest_dir``, the JAX
    package's name and format) records the cursor and the running index, so
    a killed run resumes at the slab it was in and writes the same names
    (the index restarts at the slab's start: a torn slab is overwritten, not
    duplicated).  The sentinel goes when the folder is done."""
    files = [os.path.join(src_dir, f) for f in sorted(os.listdir(src_dir))]
    os.makedirs(dest_dir, exist_ok=True)
    count = written = start = 0
    fingerprint = hashlib.sha256(("\0".join(files) + "|1").encode()).hexdigest()
    prog_path = os.path.join(dest_dir, ".crop_progress_0.json")
    if progress and os.path.exists(prog_path):
        try:
            with open(prog_path) as f:
                st = json.load(f)
            if st.get("fingerprint") == fingerprint:
                start, count, written = st["start"], st["count"], st["written"]
                print(f"[crop_objects] resuming at file {start}/{len(files)}", flush=True)
        except (OSError, ValueError, KeyError):  # a torn sentinel: start over
            pass

    while start < len(files):
        slab_files = files[start: start + slab]
        preds = detector(slab_files)
        for path in slab_files:
            _names, ids, boxes = preds[path]
            if len(ids) == 0:
                continue
            with Image.open(path) as im:
                im = im.convert("RGB")
                stem = os.path.basename(path).split(".")[0]
                for cls_id, box in zip(ids, boxes):
                    x1, y1, x2, y2 = (float(v) for v in box)
                    if x2 - x1 < 1.0 or y2 - y1 < 1.0:  # degenerate box; PIL can't save it
                        continue
                    im.crop((x1, y1, x2, y2)).save(
                        os.path.join(dest_dir, f"{stem}_{class_names[int(cls_id)]}_{count}.png"))
                    count += 1
                    written += 1
        start += len(slab_files)
        if progress:
            tmp = prog_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"fingerprint": fingerprint, "start": start, "count": count, "written": written}, f)
            os.replace(tmp, prog_path)
    if progress and os.path.exists(prog_path):
        os.remove(prog_path)
    return written


def add_detector_flags(p: argparse.ArgumentParser) -> None:
    """The detector's flags, shared with metrics/soa.py."""
    p.add_argument("--weights", type=str, default=None,
                   help="detector weights: a detectron2 .pkl or a JAX-package .npz (default: seeded random)")
    p.add_argument("--aspect-resize", action="store_true",
                   help="detectron2 ResizeShortestEdge(800/1333) with shape buckets for non-square "
                        "sources (default: square 800 resize, exact for TISE's square generated images)")
    p.add_argument("--roi-sampling", type=int, default=2, choices=(1, 2),
                   help="ROIAlign samples per bin per axis; 1 = the fast sweep setting (bin centres), "
                        "2 = default, detectron2's adaptive grid over the canonical box sizes")
    p.add_argument("--proposals", type=int, default=1000,
                   help="post-NMS RPN proposals kept (detectron2 POST_NMS_TOPK_TEST default 1000); "
                        "256 is the opt-in sweep setting")
    add_precision_flag(p)
    add_device_flag(p)


def build_detector(args) -> predictor.Detector:
    configure_precision(args.precision)
    return predictor.make_folder_detector(
        args.weights, aspect_resize=args.aspect_resize, precision=args.precision,
        roi_sampling=args.roi_sampling, proposals=args.proposals, device=resolve_device(args.device),
    )


def report(tag: str, detector: predictor.Detector, images: int, seconds: float) -> None:
    rounds = detector.nms_rounds
    nms = f"max {max(rounds)}, mean {sum(rounds) / len(rounds):.2f} over {len(rounds)} NMS calls" if rounds else "none"
    print(f"[{tag}] {images} images in {seconds:.2f} s ({images / max(seconds, 1e-9):.1f} images/s); "
          f"NMS rounds {nms}", flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--source_image_dir", default="", type=str)
    p.add_argument("--saved_cropped_object_dir", default="", type=str)
    add_detector_flags(p)
    args = p.parse_args(argv)
    detector = build_detector(args)
    t0 = time.perf_counter()
    n = crop_folder(detector, args.source_image_dir, args.saved_cropped_object_dir)
    report("crop_objects", detector, len(os.listdir(args.source_image_dir)), time.perf_counter() - t0)
    print(f"wrote {n} crops to {args.saved_cropped_object_dir}")


if __name__ == "__main__":
    main()
