"""Object counter for CA: FC-ResNet50 and the peak-response counting head
(mirrors tise_tpu/backbones/counter.py).

The reference counts objects with CountSeg's peak-response-mapping model
(counting_alignment/CA.py:131-141: ``fc_resnet50(channels=240)`` under
``peak_response_mapping``, weights ``coco14.pt``) and derives counts as
``round(gate(confidence) * spatial_mean(density))`` per class
(CA.py:151-166).  Here, as in the JAX package: a torchvision-layout ResNet-50
(the detection stack's ``ResNet50``, whose first block of a stage strides on
the 3x3 as torchvision's does) up to ``res5``, a 1x1 convolution to 240 =
3 x 80 maps, and the (class-response, density) blocks chosen by
``head_order``; class confidence is PRM's peak stimulation.  Forward only:
counting needs no input gradients.

``head_order`` says which 80-wide block is the class-response block and
which the density block; the JAX package's default (0, 1) is kept, and it is
still to be checked on the real ``coco14.pt``, which is not in the
repository.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tise_tpu_torch.backbones.detection.resnet_fpn import ResNet50
from tise_tpu_torch.backbones.detection.weights import state_dict_from_jax_params  # noqa: F401 — the JAX .npz path
from tise_tpu_torch.core.config import resolve_device
from tise_tpu_torch.core.weights import load_pytree_npz

NUM_CLASSES = 80
MAPS_PER_CLASS = 3
BN_EPS = 1e-5  # torchvision BatchNorm2d eps


def peak_stimulation(crm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """PRM peak stimulation on NCHW maps (PRM's defaults: a 3x3 window and
    the median filter): crm [B, C, H, W] -> (confidence [B, C], peak_mask
    [B, C, H, W] bool), as tise_tpu's ``peak_stimulation``.

    A position is a peak when it is the maximum of the 3x3 window around it
    (out-of-bounds taps are -inf, as ``reduce_window`` "SAME" pads) and its
    value is at least the per-class lower middle order statistic, index
    ``(h*w - 1) // 2`` of the sorted map (not numpy's mean of the two middle
    values).  Every tied maximum of a window is a peak, as in the JAX
    package (torch PRM's argmax keeps only the first).  Confidence is the
    sum over peaks divided by ``max(count, 1)``."""
    f32 = crm.float()
    b, c, h, w = crm.shape
    median = torch.sort(f32.reshape(b, c, h * w), dim=-1).values[..., (h * w - 1) // 2, None, None]
    peak_mask = (f32 >= F.max_pool2d(f32, 3, stride=1, padding=1)) & (f32 >= median)
    fmask = peak_mask.float()
    confidence = (f32 * fmask).sum(dim=(2, 3)) / fmask.sum(dim=(2, 3)).clamp(min=1.0)
    return confidence.to(crm.dtype), peak_mask


class FCResNet50PRM(nn.Module):
    """ResNet-50 -> 1x1 conv (240) -> (class-response, density) blocks."""

    def __init__(self, bias: bool = True, head_order: Tuple[int, int] = (0, 1)):
        super().__init__()
        self.backbone = ResNet50()
        self.classifier = nn.Conv2d(2048, NUM_CLASSES * MAPS_PER_CLASS, 1, bias=bias)
        self.head_order = head_order

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: normalized [B, 3, 448, 448] -> (confidence [B, 80], density
        [B, 80, 14, 14])."""
        maps = self.classifier(self.backbone(x)["res5"])
        c0, c1 = self.head_order
        crm = maps[:, c0 * NUM_CLASSES:(c0 + 1) * NUM_CLASSES]
        density = maps[:, c1 * NUM_CLASSES:(c1 + 1) * NUM_CLASSES]
        confidence, _ = peak_stimulation(crm)
        return confidence, density

    @classmethod
    def from_state_dict(cls, state_dict: Mapping[str, Any], device=None) -> "FCResNet50PRM":
        """The f32 model on ``device`` (``None`` means the card) from the
        port's state dict; the classifier has a bias when the dict has one."""
        device = resolve_device(device)
        model = cls(bias="classifier.bias" in state_dict)
        model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()})
        return model.to(device).eval()


def predict_counts(confidence: np.ndarray, density: np.ndarray) -> np.ndarray:
    """Reference count rule (CA.py:155-161), on the host in numpy as in the
    JAX package: clamp confidence at 0, binarise positives to a gate, count =
    round(gate * spatial mean of density) (f32 mean, f64 product, round
    half to even)."""
    count_den = density.mean(axis=(2, 3))  # adaptive_avg_pool2d(density, 1)
    gate = (confidence > 0).astype(np.float64)
    return np.round(gate * count_den)


def state_dict_from_countseg(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """coco14.pt state dict -> the port's state dict.

    torchvision resnet50 names under an optional ``module.`` / ``backbone.``
    prefix and the 1x1 ``classifier`` (or ``classifier.0``) conv; each
    BatchNorm folds into its convolution's affine (eps 1e-5, eval mode), in
    numpy as the JAX package's ``params_from_countseg`` folds it."""

    def arr(v):
        return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)

    sd = {k.replace("module.", ""): arr(v) for k, v in sd.items()}
    prefix = "backbone." if any(k.startswith("backbone.") for k in sd) else ""
    out: Dict[str, np.ndarray] = {}

    def conv_bn(dst: str, conv_key: str, bn_key: str) -> None:
        scale = sd[f"{bn_key}.weight"] / np.sqrt(sd[f"{bn_key}.running_var"] + BN_EPS)
        out[f"{dst}.conv.weight"] = sd[f"{conv_key}.weight"]
        out[f"{dst}.bn_scale"] = scale.astype(np.float32)
        out[f"{dst}.bn_bias"] = (sd[f"{bn_key}.bias"] - sd[f"{bn_key}.running_mean"] * scale).astype(np.float32)

    conv_bn("backbone.stem", f"{prefix}conv1", f"{prefix}bn1")
    for ours, theirs, blocks in (("res2", "layer1", 3), ("res3", "layer2", 4), ("res4", "layer3", 6),
                                 ("res5", "layer4", 3)):
        for i in range(blocks):
            p = f"{prefix}{theirs}.{i}"
            for j in (1, 2, 3):
                conv_bn(f"backbone.{ours}_{i}.conv{j}", f"{p}.conv{j}", f"{p}.bn{j}")
            if f"{p}.downsample.0.weight" in sd:
                conv_bn(f"backbone.{ours}_{i}.shortcut", f"{p}.downsample.0", f"{p}.downsample.1")
    cls_key = next(k for k in sd if k.endswith("classifier.weight") or k.endswith("classifier.0.weight"))
    cls_prefix = cls_key[: -len(".weight")]
    out["classifier.weight"] = sd[cls_key]
    if f"{cls_prefix}.bias" in sd:
        out["classifier.bias"] = sd[f"{cls_prefix}.bias"]
    return out


def load_counter_weights(path: str) -> Dict[str, np.ndarray]:
    """A CountSeg ``.pt``/``.pth`` (the state dict, or ``{"model": ...}``)
    or a JAX ``.npz`` pytree -> the port's state dict.  The ``.pt`` is read
    with ``weights_only=False``, as the JAX package reads it: a trusted
    checkpoint may hold more than tensors."""
    if path.endswith(".npz"):
        return state_dict_from_jax_params(load_pytree_npz(path))
    state = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(state, dict) and "model" in state:
        state = state["model"]
    return state_dict_from_countseg(state)


def random_countseg_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded random weights in CountSeg's layout (torchvision resnet50
    names, BatchNorm statistics, a 240-map ``classifier`` with a bias; numpy
    f32), for tests and the smoke run.  The gains keep the activations'
    scale about steady through the 16 residual blocks."""
    rng = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}

    def conv_bn(conv_key: str, bn_key: str, cout: int, cin: int, k: int, gain: float) -> None:
        sd[f"{conv_key}.weight"] = (rng.randn(cout, cin, k, k) * gain / np.sqrt(cin * k * k)).astype(np.float32)
        sd[f"{bn_key}.weight"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        sd[f"{bn_key}.bias"] = (rng.randn(cout) * 0.1).astype(np.float32)
        sd[f"{bn_key}.running_mean"] = (rng.randn(cout) * 0.1).astype(np.float32)
        sd[f"{bn_key}.running_var"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)

    conv_bn("conv1", "bn1", 64, 3, 7, 2.0)
    cin = 64
    for name, blocks, width, cout in (("layer1", 3, 64, 256), ("layer2", 4, 128, 512), ("layer3", 6, 256, 1024),
                                      ("layer4", 3, 512, 2048)):
        for i in range(blocks):
            p = f"{name}.{i}"
            conv_bn(f"{p}.conv1", f"{p}.bn1", width, cin, 1, 1.4)
            conv_bn(f"{p}.conv2", f"{p}.bn2", width, width, 3, 1.4)
            conv_bn(f"{p}.conv3", f"{p}.bn3", cout, width, 1, 0.5)
            if i == 0:
                conv_bn(f"{p}.downsample.0", f"{p}.downsample.1", cout, cin, 1, 0.7)
            cin = cout
    sd["classifier.weight"] = (rng.randn(NUM_CLASSES * MAPS_PER_CLASS, 2048, 1, 1) / np.sqrt(2048)).astype(np.float32)
    sd["classifier.bias"] = (rng.randn(NUM_CLASSES * MAPS_PER_CLASS) * 0.01).astype(np.float32)
    return sd
