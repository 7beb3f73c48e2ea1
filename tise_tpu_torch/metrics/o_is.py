"""O-IS — object-centric Inception Score over detector crops (mirrors
tise_tpu/metrics/o_is.py).

Reference (object_fidelity/O-IS/object_centric_inception_score.py):
  crops folder -> Resize(299) + Normalize(0.5, 0.5) (:87-93; recipe "half")
  -> torchvision InceptionV3 with an 80-class fine-tuned fc
     (transform_input=False, :42-45)
  -> logits / 2.1737587451934814 -> softmax (:55-57)
  -> 10 contiguous splits, exp(mean KL) via scipy entropy (:72-79).
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from tise_tpu_torch.backbones.inception_v3 import InceptionV3
from tise_tpu_torch.core import io as result_io
from tise_tpu_torch.core import weights as weights_io
from tise_tpu_torch.core.config import (NUM_SPLITS, O_IS_TEMPERATURE, add_device_flag, add_distributed_flags,
                                        add_precision_flag, configure_precision, maybe_init_distributed,
                                        resolve_device, tf32_forward)
from tise_tpu_torch.core.data import ImageFolderLoader
from tise_tpu_torch.metrics.extractor import BatchedExtractor, run_resumable
from tise_tpu_torch.metrics.is_star import IMAGE_SIZE
from tise_tpu_torch.ops import kl


def make_logits_extractor(state_dict: Mapping[str, np.ndarray], device, fast: bool = False) -> BatchedExtractor:
    """The f32 InceptionV3 logits extractor (the fc's width comes from the
    state dict: 80 classes for the fine-tune).  ``fast`` allows TF32 inside
    the forward."""
    model = InceptionV3.from_state_dict(state_dict, device=device)

    def apply_fn(x: torch.Tensor):
        with tf32_forward(fast):
            return model(x, endpoints=("logits",))

    return BatchedExtractor(apply_fn, recipe="half", device=device)


def compute_o_is(
    image_dir: str,
    extractor: BatchedExtractor,
    *,
    batch_size: int = 32,
    splits: int = NUM_SPLITS,
    snapshot_path: str = "",
    build_extractor: Optional[Callable[[], BatchedExtractor]] = None,
) -> Tuple[float, float]:
    loader = ImageFolderLoader.from_dir(image_dir, batch_size, IMAGE_SIZE)
    if loader.num_images() == 0:
        raise RuntimeError(f"No images found under: {image_dir}")
    if snapshot_path:
        logits = run_resumable(
            build_extractor or (lambda: extractor),
            loader.files,
            batch_size=batch_size,
            image_size=IMAGE_SIZE,
            keys=("logits",),
            snapshot_path=snapshot_path,
        )["logits"]
    else:
        logits = extractor.run(loader, keys=("logits",))["logits"]
    return kl.inception_score_from_logits(logits, O_IS_TEMPERATURE, splits, device=extractor.device)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--image_dir", type=str, required=True)
    p.add_argument("--saved_file", type=str, default="")
    p.add_argument("--gpu_id", type=str, default="", help="CUDA_VISIBLE_DEVICES for this run, as in the reference")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--weights", type=str, required=True, help="80-class fine-tuned inception (.pth/.npz)")
    p.add_argument("--snapshot_file", type=str, default="",
                   help="resumable extraction: rows+cursor snapshot at this path "
                        "(bit-equal result; extractor.run_resumable)")
    add_precision_flag(p)
    add_device_flag(p)
    add_distributed_flags(p)
    args = p.parse_args(argv)
    if args.gpu_id:
        os.environ["CUDA_VISIBLE_DEVICES"] = args.gpu_id  # before the first CUDA call
    configure_precision(args.precision)
    maybe_init_distributed(args)
    device = resolve_device(args.device)

    state_dict = weights_io.load_inception_state_dict(args.weights)

    def build() -> BatchedExtractor:
        return make_logits_extractor(state_dict, device, fast=args.precision == "fast")

    mean, std = compute_o_is(args.image_dir, build(), batch_size=args.batch_size,
                             snapshot_path=args.snapshot_file, build_extractor=build)
    if args.saved_file:
        result_io.write_o_is_result(args.saved_file, mean, std)
    print(f"O-IS: {mean} +- {std}")


if __name__ == "__main__":
    main()
