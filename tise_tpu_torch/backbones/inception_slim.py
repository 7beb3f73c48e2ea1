"""IS* backbones: the TF-slim / 2015-frozen-graph InceptionV3 flavors (mirrors
tise_tpu/backbones/inception_slim.py).

The reference's two IS* scripts use TF-1 backbones:
  * CUB: the vendored TF-slim inception_v3 fine-tuned to 50 bird classes + 1
    background (image_realism/IS/bird/inception_score_star_bird.py:181-201,
    EMA-restored checkpoint, logits sliced to drop class 0);
  * COCO: the frozen 2015 ImageNet GraphDef, logits reconstructed as
    pool3 @ W without bias over 1008 classes
    (image_realism/IS/coco/inception_score_star_coco.py:104-108).

Both share the inception-v3 topology of backbones/inception_v3.py
(torchvision's port of the same slim graph); the slim flavor differs only in
names and in BatchNorm having no learned scale (gamma == 1).  This module maps
slim variable names / 2015 graph node names straight onto that trunk's
state-dict layout (kernels HWIO -> OIHW once, at load) and builds the
extractors the IS* metric uses.

Checkpoints are consumed as .npz (TF var name -> array); the conversion from
a native TF checkpoint/GraphDef happens offline.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from tise_tpu_torch.backbones.inception_v3 import InceptionV3
from tise_tpu_torch.core.config import tf32_forward
from tise_tpu_torch.metrics.extractor import BatchedExtractor

#: slim scope -> port module for the stem convs
_STEM = {
    "conv0": "Conv2d_1a_3x3",
    "conv1": "Conv2d_2a_3x3",
    "conv2": "Conv2d_2b_3x3",
    "conv3": "Conv2d_3b_1x1",
    "conv4": "Conv2d_4a_3x3",
}

#: slim mixed-block scope -> port module
_MIXED = {
    "mixed_35x35x256a": "Mixed_5b",
    "mixed_35x35x288a": "Mixed_5c",
    "mixed_35x35x288b": "Mixed_5d",
    "mixed_17x17x768a": "Mixed_6a",
    "mixed_17x17x768b": "Mixed_6b",
    "mixed_17x17x768c": "Mixed_6c",
    "mixed_17x17x768d": "Mixed_6d",
    "mixed_17x17x768e": "Mixed_6e",
    # NOT "mixed_8x8x1280a": the vendored slim file deliberately keeps the
    # stale 17x17 scope for checkpoint compatibility ("scope below is not
    # changed to not void previous checkpoints",
    # inception/slim/inception_model.py:243-246)
    "mixed_17x17x1280a": "Mixed_7a",
    "mixed_8x8x2048a": "Mixed_7b",
    "mixed_8x8x2048b": "Mixed_7c",
}

#: per block: slim branch conv scope -> BasicConv2d name.
#: slim auto-names sequential ops.conv2d calls Conv, Conv_1, Conv_2, ...
_BRANCHES: Dict[str, Dict[str, str]] = {
    # InceptionA (Mixed_5b/c/d)
    "A": {
        "branch1x1/Conv": "branch1x1",
        "branch5x5/Conv": "branch5x5_1",
        "branch5x5/Conv_1": "branch5x5_2",
        "branch3x3dbl/Conv": "branch3x3dbl_1",
        "branch3x3dbl/Conv_1": "branch3x3dbl_2",
        "branch3x3dbl/Conv_2": "branch3x3dbl_3",
        "branch_pool/Conv": "branch_pool",
    },
    # InceptionB (Mixed_6a)
    "B": {
        "branch3x3/Conv": "branch3x3",
        "branch3x3dbl/Conv": "branch3x3dbl_1",
        "branch3x3dbl/Conv_1": "branch3x3dbl_2",
        "branch3x3dbl/Conv_2": "branch3x3dbl_3",
    },
    # InceptionC (Mixed_6b..e)
    "C": {
        "branch1x1/Conv": "branch1x1",
        "branch7x7/Conv": "branch7x7_1",
        "branch7x7/Conv_1": "branch7x7_2",
        "branch7x7/Conv_2": "branch7x7_3",
        "branch7x7dbl/Conv": "branch7x7dbl_1",
        "branch7x7dbl/Conv_1": "branch7x7dbl_2",
        "branch7x7dbl/Conv_2": "branch7x7dbl_3",
        "branch7x7dbl/Conv_3": "branch7x7dbl_4",
        "branch7x7dbl/Conv_4": "branch7x7dbl_5",
        "branch_pool/Conv": "branch_pool",
    },
    # InceptionD (Mixed_7a)
    "D": {
        "branch3x3/Conv": "branch3x3_1",
        "branch3x3/Conv_1": "branch3x3_2",
        "branch7x7x3/Conv": "branch7x7x3_1",
        "branch7x7x3/Conv_1": "branch7x7x3_2",
        "branch7x7x3/Conv_2": "branch7x7x3_3",
        "branch7x7x3/Conv_3": "branch7x7x3_4",
    },
    # InceptionE (Mixed_7b/c)
    "E": {
        "branch1x1/Conv": "branch1x1",
        "branch3x3/Conv": "branch3x3_1",
        "branch3x3/Conv_1": "branch3x3_2a",
        "branch3x3/Conv_2": "branch3x3_2b",
        "branch3x3dbl/Conv": "branch3x3dbl_1",
        "branch3x3dbl/Conv_1": "branch3x3dbl_2",
        "branch3x3dbl/Conv_2": "branch3x3dbl_3a",
        "branch3x3dbl/Conv_3": "branch3x3dbl_3b",
        "branch_pool/Conv": "branch_pool",
    },
}

_BLOCK_KIND = {
    "Mixed_5b": "A",
    "Mixed_5c": "A",
    "Mixed_5d": "A",
    "Mixed_6a": "B",
    "Mixed_6b": "C",
    "Mixed_6c": "C",
    "Mixed_6d": "C",
    "Mixed_6e": "C",
    "Mixed_7a": "D",
    "Mixed_7b": "E",
    "Mixed_7c": "E",
}

# ---------------------------------------------------------------------------
# 2015 frozen-graph ("classify_image_graph_def.pb") node names.  The IS* COCO
# script consumes this graph directly (inception_score_star_coco.py:84-108);
# tools/convert_tf_inception.py `pb` exports its Const nodes verbatim, and the
# tables below map them onto the trunk.  Per conv unit the graph stores
# `<scope>/conv2d_params` (HWIO) and `<scope>/batchnorm/{beta,gamma,
# moving_mean,moving_variance}`; gamma is all-ones (the old
# batch_norm_with_global_normalization ran with scale_after_normalization
# off).  Use pool_variant="tf2015" with these weights: TF avg-pool SAME
# semantics plus the graph's mixed_10 max-pool quirk.
# ---------------------------------------------------------------------------

#: 2015 stem scope -> port module
_STEM_2015 = {
    "conv": "Conv2d_1a_3x3",
    "conv_1": "Conv2d_2a_3x3",
    "conv_2": "Conv2d_2b_3x3",
    "conv_3": "Conv2d_3b_1x1",
    "conv_4": "Conv2d_4a_3x3",
}

#: 2015 mixed scope -> port module (mixed, mixed_1, ..., mixed_10)
_MIXED_2015 = {
    "mixed": "Mixed_5b",
    "mixed_1": "Mixed_5c",
    "mixed_2": "Mixed_5d",
    "mixed_3": "Mixed_6a",
    "mixed_4": "Mixed_6b",
    "mixed_5": "Mixed_6c",
    "mixed_6": "Mixed_6d",
    "mixed_7": "Mixed_6e",
    "mixed_8": "Mixed_7a",
    "mixed_9": "Mixed_7b",
    "mixed_10": "Mixed_7c",
}

#: per block kind: 2015 tower conv scope -> BasicConv2d name
_BRANCHES_2015: Dict[str, Dict[str, str]] = {
    "A": {
        "conv": "branch1x1",
        "tower/conv": "branch5x5_1",
        "tower/conv_1": "branch5x5_2",
        "tower_1/conv": "branch3x3dbl_1",
        "tower_1/conv_1": "branch3x3dbl_2",
        "tower_1/conv_2": "branch3x3dbl_3",
        "tower_2/conv": "branch_pool",
    },
    "B": {
        "conv": "branch3x3",
        "tower/conv": "branch3x3dbl_1",
        "tower/conv_1": "branch3x3dbl_2",
        "tower/conv_2": "branch3x3dbl_3",
    },
    "C": {
        "conv": "branch1x1",
        "tower/conv": "branch7x7_1",
        "tower/conv_1": "branch7x7_2",
        "tower/conv_2": "branch7x7_3",
        "tower_1/conv": "branch7x7dbl_1",
        "tower_1/conv_1": "branch7x7dbl_2",
        "tower_1/conv_2": "branch7x7dbl_3",
        "tower_1/conv_3": "branch7x7dbl_4",
        "tower_1/conv_4": "branch7x7dbl_5",
        "tower_2/conv": "branch_pool",
    },
    "D": {
        "tower/conv": "branch3x3_1",
        "tower/conv_1": "branch3x3_2",
        "tower_1/conv": "branch7x7x3_1",
        "tower_1/conv_1": "branch7x7x3_2",
        "tower_1/conv_2": "branch7x7x3_3",
        "tower_1/conv_3": "branch7x7x3_4",
    },
    "E": {
        "conv": "branch1x1",
        "tower/conv": "branch3x3_1",
        "tower/mixed/conv": "branch3x3_2a",
        "tower/mixed/conv_1": "branch3x3_2b",
        "tower_1/conv": "branch3x3dbl_1",
        "tower_1/conv_1": "branch3x3dbl_2",
        "tower_1/mixed/conv": "branch3x3dbl_3a",
        "tower_1/mixed/conv_1": "branch3x3dbl_3b",
        "tower_2/conv": "branch_pool",
    },
}


def _put_conv(out: Dict[str, np.ndarray], prefix: str, kernel_hwio, beta, mean, var, gamma=None) -> None:
    """One conv unit into the state dict: kernel HWIO -> OIHW; BatchNorm
    without a stored gamma gets ones (slim and the 2015 graph ran without
    scale)."""
    beta = np.asarray(beta)
    out[f"{prefix}.conv.weight"] = np.ascontiguousarray(np.transpose(np.asarray(kernel_hwio), (3, 2, 0, 1)))
    out[f"{prefix}.bn.weight"] = np.ones_like(beta) if gamma is None else np.asarray(gamma)
    out[f"{prefix}.bn.bias"] = beta
    out[f"{prefix}.bn.running_mean"] = np.asarray(mean)
    out[f"{prefix}.bn.running_var"] = np.asarray(var)


def _conv_entry(out, prefix: str, flat: Mapping[str, np.ndarray], scope: str) -> None:
    """slim '<scope>/{weights,BatchNorm/*}' -> BasicConv2d entries."""
    bn = f"{scope}/BatchNorm"
    _put_conv(out, prefix, flat[f"{scope}/weights"], flat[f"{bn}/beta"], flat[f"{bn}/moving_mean"],
              flat[f"{bn}/moving_variance"], flat.get(f"{bn}/gamma"))


def params_from_slim_vars(flat: Mapping[str, np.ndarray], num_classes: int) -> Dict[str, np.ndarray]:
    """slim checkpoint variables (prefix 'inception_v3/' optional, EMA shadow
    suffixes already resolved by the exporter) -> torchvision-layout state dict."""
    flat = {k.split("inception_v3/")[-1]: v for k, v in flat.items()}
    out: Dict[str, np.ndarray] = {}
    for scope, mod in _STEM.items():
        _conv_entry(out, mod, flat, scope)
    for scope, mod in _MIXED.items():
        for sub, name in _BRANCHES[_BLOCK_KIND[mod]].items():
            _conv_entry(out, f"{mod}.{name}", flat, f"{scope}/{sub}")
    # slim fc: 'logits/logits/{weights,biases}', weights [in, out]
    if "logits/logits/weights" in flat:
        out["fc.weight"] = np.ascontiguousarray(np.asarray(flat["logits/logits/weights"]).T)
        out["fc.bias"] = np.asarray(flat["logits/logits/biases"])
    elif num_classes:
        raise KeyError("slim checkpoint missing logits/logits/weights")
    return out


def _conv_entry_2015(out, prefix: str, flat: Mapping[str, np.ndarray], scope: str) -> None:
    """2015-graph '<scope>/{conv2d_params,batchnorm/*}' -> BasicConv2d entries."""
    bn = f"{scope}/batchnorm"
    _put_conv(out, prefix, flat[f"{scope}/conv2d_params"], flat[f"{bn}/beta"], flat[f"{bn}/moving_mean"],
              flat[f"{bn}/moving_variance"], flat.get(f"{bn}/gamma"))


def params_from_2015_vars(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """2015 classify_image GraphDef constants (node name -> array) ->
    torchvision-layout state dict (trunk only; the 1008-class head is the
    separate 'softmax/weights' matmul)."""
    out: Dict[str, np.ndarray] = {}
    for scope, mod in _STEM_2015.items():
        _conv_entry_2015(out, mod, flat, scope)
    for scope, mod in _MIXED_2015.items():
        for sub, name in _BRANCHES_2015[_BLOCK_KIND[mod]].items():
            _conv_entry_2015(out, f"{mod}.{name}", flat, f"{scope}/{sub}")
    return out


def is_2015_layout(flat: Mapping[str, np.ndarray]) -> bool:
    """Distinguish a 2015-GraphDef export from a slim-variable export."""
    return "conv/conv2d_params" in flat or "mixed/conv/conv2d_params" in flat


def expected_2015_names() -> List[str]:
    """Every Const node name the 2015-graph loader consumes (gamma optional)."""
    scopes = list(_STEM_2015)
    for scope, mod in _MIXED_2015.items():
        scopes += [f"{scope}/{sub}" for sub in _BRANCHES_2015[_BLOCK_KIND[mod]]]
    names: List[str] = []
    for s in scopes:
        names += [
            f"{s}/conv2d_params",
            f"{s}/batchnorm/beta",
            f"{s}/batchnorm/moving_mean",
            f"{s}/batchnorm/moving_variance",
        ]
    return names


def missing_2015_names(flat: Mapping[str, np.ndarray]) -> List[str]:
    return [n for n in expected_2015_names() if n not in flat]


def load_slim_npz(path: str, num_classes: int) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as f:
        flat = {k: f[k] for k in f.files}
    return params_from_slim_vars(flat, num_classes)


def make_logits_extractor(weights_path: str, flavor: str, device, fast: bool = False) -> BatchedExtractor:
    """Extractor producing the IS* 'logits' (post background-slice for CUB,
    pool3 @ W for COCO) in f32 on ``device``.  ``fast`` allows TF32 inside
    the forward (these flavors have no folded bf16 trunk)."""
    if flavor == "cub":
        # 51-way fc; background class 0 sliced off (inception_score_star_bird.py:189).
        # pool_variant="tf": slim's tf.nn.avg_pool SAME excludes padding from
        # the divisor (ops.py:368-392), unlike torchvision.
        model = InceptionV3.from_state_dict(load_slim_npz(weights_path, num_classes=51),
                                            pool_variant="tf", device=device)

        def apply_fn(x: torch.Tensor):
            with tf32_forward(fast):
                return {"logits": model(x, endpoints=("logits",))["logits"][:, 1:]}

        recipe = "is_star"

    elif flavor == "coco":
        # 2015 frozen graph: logits = pool3 @ W, no bias, 1008 classes
        # (inception_score_star_coco.py:104-105).  The exporter stores either
        # the raw 2015 node names (conv/conv2d_params, mixed_4/tower/...) or
        # slim-style names; both load.  pool_variant="tf2015" reproduces the
        # graph's pooling (TF avg-pool divisor + mixed_10 max pool); the
        # in-graph normalize is (v-128)/128, folded into the recipe.
        with np.load(weights_path, allow_pickle=False) as f:
            flat = {k: f[k] for k in f.files}
        softmax_w = np.asarray(flat.pop("softmax/weights"))
        state = params_from_2015_vars(flat) if is_2015_layout(flat) else params_from_slim_vars(flat, num_classes=0)
        model = InceptionV3.from_state_dict(state, pool_variant="tf2015", device=device)
        w = torch.tensor(softmax_w, dtype=torch.float32, device=device)

        def apply_fn(x: torch.Tensor):
            with tf32_forward(fast):
                return {"logits": model(x, endpoints=("pool3",))["pool3"] @ w}

        recipe = "is_star_2015"

    else:
        raise ValueError(flavor)
    return BatchedExtractor(apply_fn, recipe=recipe, device=device)
