"""CA — Counting Alignment (mirrors tise_tpu/metrics/ca.py; reference:
counting_alignment/CA.py).

Per caption item: predict per-class object counts for the generated image
(448 x 448, ImageNet normalization, CA.py:121-128) with the PRM counter, then
the RMSE between predicted and ground-truth counts over the classes named in
the item's ``counting_info`` (a class not predicted counts 0,
CA.py:170-186); CA = mean RMSE over items (lower is better).

Images are counted a batch at a time on one device: the uint8 batch goes up
from pinned memory, kernel K1 normalizes it under ``imagenet``, the counter
runs in f32 (TF32 off; ``--precision fast`` allows TF32 inside the forward
only), and the confidences and density maps come back for the host's count
rule (``counter.predict_counts``, numpy, as in the JAX package).  One batch
stays in flight: batch k+1 is decoded on the host while batch k runs.
"""

from __future__ import annotations

import argparse
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from tise_tpu_torch.backbones import counter as counter_lib
from tise_tpu_torch.backbones.detection.coco_classes import COCO_CLASSES
from tise_tpu_torch.core import io as result_io
from tise_tpu_torch.core.config import (add_device_flag, add_precision_flag, configure_precision, resolve_device,
                                        tf32_forward)
from tise_tpu_torch.core.data import load_image
from tise_tpu_torch.metrics import extractor as ext
from tise_tpu_torch.ops.preprocess import normalize

IMAGE_SIZE = 448  # CA.py:121


class CountingEngine:
    """uint8 [B, 448, 448, 3] batches -> per-class count dicts on one device."""

    def __init__(self, state_dict: Mapping[str, np.ndarray], device=None, fast: bool = False):
        self.device = resolve_device(device)
        self.model = counter_lib.FCResNet50PRM.from_state_dict(state_dict, self.device)
        self.fast = fast

    def dispatch(self, images_u8: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """Launch one batch; returns the device's (confidence, density), not
        synchronised."""
        x = torch.from_numpy(np.ascontiguousarray(images_u8))
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        else:
            x = x.to(self.device)
        with torch.inference_mode(), tf32_forward(self.fast):
            x = normalize(x, "imagenet").permute(0, 3, 1, 2).contiguous()
            return self.model(x)

    @staticmethod
    def pull(handle: Tuple[torch.Tensor, torch.Tensor]) -> List[Dict[str, float]]:
        """A dispatched batch's counts: {class name: count} of the non-zero
        classes of each image."""
        conf, density = handle
        counts = counter_lib.predict_counts(conf.cpu().numpy(), density.cpu().numpy())
        return [{COCO_CLASSES[i]: float(c) for i, c in enumerate(row) if c} for row in counts]


def rmse_for_item(pred: Dict[str, float], gt: Dict[str, float]) -> float:
    """Reference pairing (CA.py:176-185): iterate the GT classes; a missing
    prediction counts 0."""
    gt_vals, pred_vals = [], []
    for key, val in gt.items():
        gt_vals.append(float(val))
        pred_vals.append(float(pred.get(key, 0.0)))
    sq = np.mean((np.asarray(gt_vals) - np.asarray(pred_vals)) ** 2)
    return math.sqrt(sq)


def compute_ca(
    counting_data: Sequence[Dict],
    image_dir: str,
    engine: CountingEngine,
    *,
    batch_size: int = 32,
    num_workers: int = 8,
    snapshot_path: str = "",
    snapshot_every: int = 0,
) -> float:
    """Mean per-item RMSE.  The RMSEs are a prefix of the item order, so
    with ``snapshot_path`` they are written with the cursor every
    ``snapshot_every`` items (the JAX package's snapshot, fingerprinted by
    the caption ids); a failed run re-raises and leaves the snapshot, and the
    same command resumes from it (bit-equal result).  (The JAX package also
    resets its TPU backend in process and retries; a CUDA context that
    faulted cannot be reset in process, so the port re-raises.)"""
    n = len(counting_data)
    fp = ""
    chunks: Dict[str, list] = {}
    cursor = 0
    snapshot_every = snapshot_every or max(batch_size * 8, 256)
    if snapshot_path:
        fp = ext._snapshot_fingerprint([str(item["caption_id"]) for item in counting_data], IMAGE_SIZE, ("rmse",))
        chunks, cursor = ext._load_snapshot(snapshot_path, fp)
    since = 0
    inflight = None  # (engine.dispatch's handle, the items of its batch)

    def record(handle, chunk: range) -> None:
        nonlocal cursor, since
        preds = engine.pull(handle)
        chunks.setdefault("rmse", []).append(np.asarray(
            [rmse_for_item(preds[j], counting_data[i]["counting_info"]) for j, i in enumerate(chunk)]))
        cursor += len(chunk)
        since += len(chunk)

    def load(i: int) -> np.ndarray:
        return load_image(os.path.join(image_dir, f"{counting_data[i]['caption_id']}.png"), (IMAGE_SIZE, IMAGE_SIZE))

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for start in range(cursor, n, batch_size):
            chunk = range(start, min(start + batch_size, n))
            handle = engine.dispatch(np.stack(list(pool.map(load, chunk))))
            if inflight is not None:
                record(*inflight)
            inflight = (handle, chunk)
            if snapshot_path and since >= snapshot_every:
                record(*inflight)  # flush: the cursor must be exact
                inflight = None
                ext._save_snapshot(snapshot_path, fp, chunks, cursor)
                since = 0
        if inflight is not None:
            record(*inflight)
    if snapshot_path and os.path.exists(snapshot_path):
        os.remove(snapshot_path)
    rmse = np.concatenate(chunks["rmse"]) if chunks.get("rmse") else np.zeros(0)
    return float(np.mean(rmse))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Calculating Counting metric")
    p.add_argument("--image_dir", default="", type=str)
    p.add_argument("--ct_input_file", default="captions/CA_input_captions.pkl", type=str)
    p.add_argument("--gpu_id", default=0, type=int, help="accepted for the reference's command lines; ignored")
    p.add_argument("--result_file", default="", type=str)
    p.add_argument("--weights", type=str, required=True, help="CountSeg coco14.pt or the JAX package's .npz")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--snapshot_file", type=str, default="",
                   help="make the item loop resumable: periodic rmse+cursor snapshot at this path "
                        "(bit-equal result)")
    add_precision_flag(p)
    add_device_flag(p)
    args = p.parse_args(argv)
    configure_precision(args.precision)
    device = resolve_device(args.device)

    engine = CountingEngine(counter_lib.load_counter_weights(args.weights), device, fast=args.precision == "fast")
    counting_data = result_io.load_pickle(args.ct_input_file)
    ca = compute_ca(counting_data, args.image_dir, engine, batch_size=args.batch_size,
                    snapshot_path=args.snapshot_file)
    if args.result_file:
        result_io.write_ca_result(args.result_file, ca)
    print(f"CA = {ca}")


if __name__ == "__main__":
    main()
