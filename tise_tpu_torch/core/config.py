"""Precision configuration for metric runs (mirrors tise_tpu/core/config.py:109-152).

``--precision highest`` is the reference float parity mode.  On Hopper,
PyTorch runs float32 convolutions through cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which alone drifts pool3 by
about 1e-3; ``highest`` therefore turns TF32 off for both convolutions and
matmuls.  ``--precision fast`` keeps TF32 off process-wide as well (see
:func:`configure_precision`).
"""

from __future__ import annotations

import contextlib

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

def configure_precision(mode: str = "highest") -> None:
    """Set the global matmul/conv precision for metric runs.

    Both modes turn TF32 off for convolutions and matmuls.  ``fast`` selects
    the bf16 BN-folded trunk (backbones/inception_fast.py) in the CLIs that
    have one; its reduced precision lives in that trunk's dtype, not in a
    process-wide switch, so the Fréchet stage of a ``fast`` run stays IEEE
    f32/f64 like a ``highest`` one.  CLIs without a folded trunk (IS*, O-IS)
    allow TF32 inside the forward only (:func:`tf32_forward`).
    """
    if mode not in ("highest", "fast"):
        raise ValueError(f"unknown precision {mode!r}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@contextlib.contextmanager
def tf32_forward(enabled: bool):
    """Allow TF32 convolutions and matmuls inside the block only — the
    card's counterpart of the reference's reduced-pass f32 matmuls under
    ``--precision fast`` for a trunk that stays f32."""
    if not enabled:
        yield
        return
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def add_precision_flag(parser) -> None:
    parser.add_argument(
        "--precision",
        choices=["highest", "fast"],
        default="highest",
        help="'highest' = reference float parity (TF32 off, default); 'fast' = max throughput "
             "(bf16 folded trunk where the metric has one, TF32 forward elsewhere)",
    )


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  A CUDA device that is not there raises: no
    entry point moves to the CPU unless the caller asks for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is False); "
            "pass --device cpu (device=\"cpu\") to run on the CPU"
        )
    return device


def add_device_flag(parser) -> None:
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the run; 'cuda' (default) raises when no card is found, "
                             "'cpu' must be asked for")


def add_distributed_flags(parser) -> None:
    """Multi-process flags: when --coordinator is given, every participating
    process runs the same CLI; work items shard across processes (each on
    its own card) and per-item outputs allgather back into global order
    before the metric math (tise_tpu_torch/parallel/multihost.py)."""
    parser.add_argument("--coordinator", type=str, default=None,
                        help="coordinator address host:port for multi-host runs (torch.distributed)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)


def maybe_init_distributed(args) -> None:
    """Join the cluster iff --coordinator was passed, before the first use
    of the card; ``args.device`` becomes this process's device (the card
    ``process_id % device_count``, or the CPU when ``--device cpu``)."""
    if getattr(args, "coordinator", None):
        from tise_tpu_torch.parallel import init_distributed

        args.device = str(init_distributed(args.coordinator, args.num_processes, args.process_id,
                                           getattr(args, "device", "cuda")))
