"""IS* — temperature-calibrated Inception Score, CUB and COCO tracks (mirrors
tise_tpu/metrics/is_star.py).

Reference behavior:
  * CUB  (image_realism/IS/bird/inception_score_star_bird.py): TF-slim
    InceptionV3 fine-tuned to 50 bird classes (+1 background class sliced off,
    :181-189), logits / 0.5980541706085205 (:192), softmax; images shuffled
    (:85, unseeded — here: seeded), floor(N/64) full batches (tail dropped,
    :83), 10 contiguous splits -> exp(mean KL) (:99-105).
  * COCO (image_realism/IS/coco/inception_score_star_coco.py): frozen 2015
    ImageNet graph; logits reconstructed as pool3 @ W (no bias, :104-105),
    logits / 0.9091363549232483 (:107), softmax over 1008 classes; NO shuffle,
    every image used (bs=1, :34), same split-KL (:54-58).
  * preprocess: PIL-bilinear resize to 299 on uint8 for both; CUB normalizes
    /127.5-1 (recipe "is_star") while the 2015 graph normalizes (v-128)/128
    in-graph (recipe "is_star_2015"); COCO also needs pool_variant="tf2015"
    (TF avg-pool divisor + the graph's mixed_10 max-pool quirk), CUB
    pool_variant="tf".

The backbone is the slim-architecture InceptionV3
(tise_tpu_torch/backbones/inception_slim.py); kernel K1 normalizes each batch
and kernel K2 runs every pool branch in the TF count mode.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional, Tuple

import numpy as np

from tise_tpu_torch.backbones import inception_slim
from tise_tpu_torch.core import io as result_io
from tise_tpu_torch.core.config import (IS_STAR_TEMPERATURE_COCO, IS_STAR_TEMPERATURE_CUB, NUM_SPLITS,
                                        add_device_flag, add_distributed_flags, add_precision_flag,
                                        configure_precision, maybe_init_distributed, resolve_device)
from tise_tpu_torch.core.data import ImageFolderLoader
from tise_tpu_torch.metrics.extractor import BatchedExtractor, run_resumable
from tise_tpu_torch.ops import kl

IMAGE_SIZE = 299


def compute_is_star(
    image_dir: str,
    extractor: BatchedExtractor,
    *,
    flavor: str,
    batch_size: int = 64,
    splits: int = NUM_SPLITS,
    seed: int = 0,
    logits_key: str = "logits",
    snapshot_path: str = "",
    build_extractor: Optional[Callable[[], BatchedExtractor]] = None,
) -> Tuple[float, float]:
    """Run the IS* pipeline over a folder of generated images.

    ``snapshot_path`` makes the extraction resumable (extractor.run_resumable,
    bit-equal result — the seeded shuffle makes the file order the same
    across resumes)."""
    if flavor not in ("cub", "coco"):
        raise ValueError(flavor)
    temperature = IS_STAR_TEMPERATURE_CUB if flavor == "cub" else IS_STAR_TEMPERATURE_COCO

    files = ImageFolderLoader.from_dir(image_dir, batch_size, IMAGE_SIZE).files
    if flavor == "cub":
        # the reference shuffles the image order before batching and drops the
        # tail batch (inception_score_star_bird.py:83-94)
        rng = np.random.RandomState(seed)
        files = [files[i] for i in rng.permutation(len(files))]
        files = files[: (len(files) // batch_size) * batch_size]
    if not files:
        raise RuntimeError(f"No images found under: {image_dir}")

    if snapshot_path:
        logits = run_resumable(
            build_extractor or (lambda: extractor),
            files,
            batch_size=batch_size,
            image_size=IMAGE_SIZE,
            keys=(logits_key,),
            snapshot_path=snapshot_path,
        )[logits_key]
    else:
        loader = ImageFolderLoader(files, batch_size, IMAGE_SIZE, drop_last=flavor == "cub")
        logits = extractor.run(loader, keys=(logits_key,))[logits_key]
    return kl.inception_score_from_logits(logits, temperature, splits, device=extractor.device)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--image_folder", type=str, required=True)
    p.add_argument("--saved_file", type=str, default="")
    p.add_argument("--flavor", type=str, required=True, choices=["cub", "coco"])
    p.add_argument("--num_classes", type=int, default=50, help="(cub) fine-tuned classes")
    p.add_argument("--splits", type=int, default=NUM_SPLITS)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gpu", type=str, default="", help="CUDA_VISIBLE_DEVICES for this run, as in the reference")
    p.add_argument("--weights", type=str, required=True, help="converted slim checkpoint (.npz)")
    p.add_argument("--snapshot_file", type=str, default="",
                   help="resumable extraction: rows+cursor snapshot at this path "
                        "(bit-equal result; extractor.run_resumable)")
    add_precision_flag(p)
    add_device_flag(p)
    add_distributed_flags(p)
    args = p.parse_args(argv)
    if args.gpu:
        os.environ["CUDA_VISIBLE_DEVICES"] = args.gpu  # before the first CUDA call
    configure_precision(args.precision)
    maybe_init_distributed(args)
    device = resolve_device(args.device)

    def build() -> BatchedExtractor:
        return inception_slim.make_logits_extractor(args.weights, args.flavor, device, fast=args.precision == "fast")

    mean, std = compute_is_star(
        args.image_folder,
        build(),
        flavor=args.flavor,
        batch_size=args.batch_size,
        splits=args.splits,
        seed=args.seed,
        snapshot_path=args.snapshot_file,
        build_extractor=build,
    )
    if args.saved_file:
        if args.flavor == "cub":
            result_io.write_is_result(args.saved_file, mean, std)
        else:
            result_io.write_is_coco_result(args.saved_file, mean, std)
    print("[Inception Score] mean: {:.5f} std: {:.5f}".format(mean, std))


if __name__ == "__main__":
    main()
