"""Detector weights: the detectron2 checkpoint, JAX-package params and seeded
random weights, each to the port's state dict (mirrors
tise_tpu/backbones/detection/weights.py).

The reference downloads ``model_final_f10217.pkl`` (crop_object.py:21,
SOA.py:22), a detectron2 pickle of {"model": {name: ndarray}}.  FrozenBatchNorm
entries (``norm.{weight,bias,running_mean,running_var}``) are folded into the
per-channel affine of ``ConvFrozenBN`` (``bn_scale``, ``bn_bias``); the mask
head is skipped.  The port's keys follow the JAX package's parameter tree
(``backbone.res2_0.conv1.conv.weight``, ``fpn.lateral2.weight``,
``rpn.objectness.weight``, ``box_head.fc1.weight``), convolutions OIHW, dense
layers [out, in], and ``fc1``'s input in HWC order.
"""

from __future__ import annotations

import math
import pickle
from typing import Any, Dict, Mapping

import numpy as np

from tise_tpu_torch.core.weights import load_pytree_npz

BN_EPS = 1e-5  # detectron2 FrozenBatchNorm2d eps
STAGE_BLOCKS = {"res2": 3, "res3": 4, "res4": 6, "res5": 3}


def _frozen_bn(sd: Mapping[str, np.ndarray], prefix: str):
    gamma = np.asarray(sd[f"{prefix}.norm.weight"])
    beta = np.asarray(sd[f"{prefix}.norm.bias"])
    mean = np.asarray(sd[f"{prefix}.norm.running_mean"])
    var = np.asarray(sd[f"{prefix}.norm.running_var"])
    scale = gamma / np.sqrt(var + BN_EPS)
    return scale.astype(np.float32), (beta - mean * scale).astype(np.float32)


def state_dict_from_detectron2(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """detectron2 state dict (numpy) -> the port's state dict."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    out: Dict[str, np.ndarray] = {}

    def conv_bn(dst: str, src: str) -> None:
        out[f"{dst}.conv.weight"] = sd[f"{src}.weight"]
        out[f"{dst}.bn_scale"], out[f"{dst}.bn_bias"] = _frozen_bn(sd, src)

    def affine(dst: str, src: str) -> None:
        out[f"{dst}.weight"], out[f"{dst}.bias"] = sd[f"{src}.weight"], sd[f"{src}.bias"]

    conv_bn("backbone.stem", "backbone.bottom_up.stem.conv1")
    for stage, blocks in STAGE_BLOCKS.items():
        for i in range(blocks):
            src = f"backbone.bottom_up.{stage}.{i}"
            names = ("conv1", "conv2", "conv3") + (("shortcut",) if f"{src}.shortcut.weight" in sd else ())
            for name in names:
                conv_bn(f"backbone.{stage}_{i}.{name}", f"{src}.{name}")
    for lvl in range(2, 6):
        affine(f"fpn.lateral{lvl}", f"backbone.fpn_lateral{lvl}")
        affine(f"fpn.output{lvl}", f"backbone.fpn_output{lvl}")
    affine("rpn.conv", "proposal_generator.rpn_head.conv")
    affine("rpn.objectness", "proposal_generator.rpn_head.objectness_logits")
    affine("rpn.anchor_deltas", "proposal_generator.rpn_head.anchor_deltas")
    affine("box_head.fc1", "roi_heads.box_head.fc1")
    w = out["box_head.fc1.weight"]  # [out, 256*7*7], rows in CHW order -> HWC
    out["box_head.fc1.weight"] = np.ascontiguousarray(
        w.reshape(w.shape[0], 256, 7, 7).transpose(0, 2, 3, 1).reshape(w.shape[0], -1))
    affine("box_head.fc2", "roi_heads.box_head.fc2")
    affine("box_head.cls_score", "roi_heads.box_predictor.cls_score")
    affine("box_head.bbox_pred", "roi_heads.box_predictor.bbox_pred")
    return out


def state_dict_from_jax_params(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX-package detector params (numpy leaves; ``{"params": tree}`` or the
    tree) -> the port's state dict: ``kernel`` HWIO -> ``weight`` OIHW,
    dense ``kernel`` [in, out] -> ``weight`` [out, in] (``fc1``'s inputs stay
    in HWC order), ``bias``, ``bn_scale`` and ``bn_bias`` as they are."""
    out: Dict[str, np.ndarray] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for key in sorted(node):
            value, name = node[key], f"{prefix}.{key}" if prefix else key
            if isinstance(value, Mapping):
                walk(value, name)
            elif key == "kernel":
                v = np.asarray(value)
                out[f"{prefix}.weight"] = np.ascontiguousarray(np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v.T)
            else:
                out[name] = np.asarray(value)

    walk(params.get("params", params), "")
    return out


def load_weights(path: str) -> Dict[str, np.ndarray]:
    """A detectron2 ``.pkl`` (``{"model": ...}`` or the bare dict) or a JAX
    ``.npz`` pytree -> the port's state dict."""
    if path.endswith(".npz"):
        return state_dict_from_jax_params(load_pytree_npz(path))
    with open(path, "rb") as f:
        ckpt = pickle.load(f, encoding="latin1")
    return state_dict_from_detectron2(ckpt["model"] if "model" in ckpt else ckpt)


def random_detectron2_state_dict(seed: int = 0, rpn_gain: float = 1.0, cls_gain: float = 1.0) -> Dict[str, np.ndarray]:
    """Seeded random weights in the detectron2 layout (numpy f32).

    ``rpn_gain`` and ``cls_gain`` sharpen the objectness and classifier
    weights so that a random forward gives confident, well-separated scores,
    the regime of real weights.  The anchor deltas are tiny and the box
    deltas exactly zero, so proposals are anchor-shaped and the final boxes
    are the proposals: random deltas make slivers whose IoU, and so NMS,
    turns on rounding.  Gains elsewhere keep the activations' scale about
    steady through the 16 residual blocks."""
    rng = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}

    def conv(prefix, cout, cin, k, norm=True, bias=False, gain=1.0):
        fan = cin * k * k
        sd[f"{prefix}.weight"] = (rng.randn(cout, cin, k, k) * gain / math.sqrt(fan)).astype(np.float32)
        if bias:
            sd[f"{prefix}.bias"] = (rng.randn(cout) * 0.01).astype(np.float32)
        if norm:
            sd[f"{prefix}.norm.weight"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
            sd[f"{prefix}.norm.bias"] = (rng.randn(cout) * 0.1).astype(np.float32)
            sd[f"{prefix}.norm.running_mean"] = (rng.randn(cout) * 0.1).astype(np.float32)
            sd[f"{prefix}.norm.running_var"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)

    def dense(prefix, cout, cin, gain=1.0):
        sd[f"{prefix}.weight"] = (rng.randn(cout, cin) * gain / math.sqrt(cin)).astype(np.float32)
        sd[f"{prefix}.bias"] = (rng.randn(cout) * 0.01).astype(np.float32)

    conv("backbone.bottom_up.stem.conv1", 64, 3, 7, gain=2.0)
    stages = [("res2", 3, 64, 256, 64), ("res3", 4, 128, 512, 256),
              ("res4", 6, 256, 1024, 512), ("res5", 3, 512, 2048, 1024)]
    for name, blocks, width, cout, cin_first in stages:
        for i in range(blocks):
            cin = cin_first if i == 0 else cout
            p = f"backbone.bottom_up.{name}.{i}"
            if i == 0:
                conv(f"{p}.shortcut", cout, cin, 1, gain=0.7)
            conv(f"{p}.conv1", width, cin, 1, gain=1.4)
            conv(f"{p}.conv2", width, width, 3, gain=1.4)
            conv(f"{p}.conv3", cout, width, 1, gain=0.5)
    for lvl, cin in zip(range(2, 6), (256, 512, 1024, 2048)):
        conv(f"backbone.fpn_lateral{lvl}", 256, cin, 1, norm=False, bias=True, gain=1.5)
        conv(f"backbone.fpn_output{lvl}", 256, 256, 3, norm=False, bias=True, gain=1.5)
    conv("proposal_generator.rpn_head.conv", 256, 256, 3, norm=False, bias=True, gain=1.5)
    conv("proposal_generator.rpn_head.objectness_logits", 3, 256, 1, norm=False, bias=True, gain=rpn_gain)
    conv("proposal_generator.rpn_head.anchor_deltas", 12, 256, 1, norm=False, bias=True, gain=1e-4)
    dense("roi_heads.box_head.fc1", 1024, 256 * 7 * 7, gain=1.5)
    dense("roi_heads.box_head.fc2", 1024, 1024, gain=1.5)
    dense("roi_heads.box_predictor.cls_score", 81, 1024, gain=cls_gain)
    sd["roi_heads.box_predictor.bbox_pred.weight"] = np.zeros((320, 1024), np.float32)
    sd["roi_heads.box_predictor.bbox_pred.bias"] = np.zeros((320,), np.float32)
    return sd
