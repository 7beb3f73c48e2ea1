"""Precision configuration for metric runs (mirrors tise_tpu/core/config.py:109-152).

``--precision highest`` is the reference float parity mode.  On Hopper,
PyTorch runs float32 convolutions through cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which alone drifts pool3 by
about 1e-3; ``highest`` therefore turns TF32 off for both convolutions and
matmuls.
"""

from __future__ import annotations

import torch

# Reference calibration constants, the same values as tise_tpu/core/config.py
# (BASELINE.md "Fixed calibration constants"); the metrics of later slices
# read them from here.

#: IS* temperature, CUB 50-class fine-tuned backbone
#: (reference: image_realism/IS/bird/inception_score_star_bird.py:192)
IS_STAR_TEMPERATURE_CUB = 0.5980541706085205

#: IS* temperature, COCO ImageNet-2015 frozen-graph backbone
#: (reference: image_realism/IS/coco/inception_score_star_coco.py:107)
IS_STAR_TEMPERATURE_COCO = 0.9091363549232483

#: O-IS temperature, 80-class COCO fine-tuned backbone
#: (reference: object_fidelity/O-IS/object_centric_inception_score.py:55)
O_IS_TEMPERATURE = 2.1737587451934814

#: Detector score threshold used for object cropping and SOA
#: (reference: object_fidelity/crop_object.py:20, semantic_object_accuracy/SOA.py:21)
DETECTOR_SCORE_THRESHOLD = 0.5

#: PA success threshold: P(gt caption) must exceed this
#: (reference: positional_alignment/PA.py:41)
PA_SUCCESS_THRESHOLD = 0.6

#: Number of splits/bins for IS*/O-IS/RP
#: (reference: inception_score_star_bird.py:44, object_centric_inception_score.py:123,
#:  RP_coco.py:44, RP_cub.py:153-156)
NUM_SPLITS = 10

#: the bf16 BN-folded trunk (tise_tpu/backbones/inception_fast.py) is not
#: ported yet; ``--precision fast`` is refused with this message
FAST_NOT_PORTED = (
    "--precision fast is not ported yet: it needs backbones/inception_fast.py "
    "(ROADMAP.md, Queue 1, next slice: inception_fast)"
)


def configure_precision(mode: str = "highest") -> None:
    """Set the global matmul/conv precision for metric runs."""
    if mode == "fast":
        raise NotImplementedError(FAST_NOT_PORTED)
    if mode != "highest":
        raise ValueError(f"unknown precision {mode!r}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def add_precision_flag(parser) -> None:
    parser.add_argument(
        "--precision",
        choices=["highest", "fast"],
        default="highest",
        help="'highest' = reference float parity (TF32 off); 'fast' is not ported yet",
    )
