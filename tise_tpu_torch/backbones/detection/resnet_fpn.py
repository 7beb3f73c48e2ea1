"""ResNet-50 + FPN backbone of the detection stack, frozen BN (mirrors
tise_tpu/backbones/detection/resnet_fpn.py).

detectron2-compatible ResNet-50 (FrozenBatchNorm as a per-channel affine,
caffe-style stem) with a P2..P6 FPN, as ``nn.Module``s on NCHW tensors.  The
submodule names follow the JAX package's parameter tree (``backbone.res3_0.
conv2.conv.weight`` is ``params/backbone/res3_0/conv2/conv/kernel``), which
``weights.state_dict_from_jax_params`` relies on.  The model runs in the
dtype of its parameters: ``.to(torch.bfloat16)`` gives the JAX module's
``dtype=jnp.bfloat16`` (bf16 convolutions, the affine in bf16).

Like the JAX module and ``tests/torch_rcnn_ref.py``, a stage's first block
strides on the 3x3 ``conv2``.  detectron2's ``MODEL.RESNETS.STRIDE_IN_1X1 =
True``, the default that mask_rcnn_R_50_FPN_3x keeps, strides on the 1x1
``conv1`` instead; with real weights the two differ.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

STAGES = (("res2", 64, 256, 3, 1), ("res3", 128, 512, 4, 2), ("res4", 256, 1024, 6, 2), ("res5", 512, 2048, 3, 2))


class ConvFrozenBN(nn.Module):
    """conv (no bias), then the frozen BN affine ``x * bn_scale + bn_bias``
    in the conv's dtype (+ optional relu).

    Flax's ``"SAME"`` padding of the JAX module's 1x1 convolutions, the
    strided shortcut among them, pads nothing at any input size, so they
    take ``padding=0``; the 3x3 and the 7x7 stem pad explicitly."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.register_buffer("bn_scale", torch.ones(cout))
        self.register_buffer("bn_bias", torch.zeros(cout))
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        x = x * self.bn_scale.view(1, -1, 1, 1) + self.bn_bias.view(1, -1, 1, 1)
        return F.relu(x) if self.relu else x


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with a projection shortcut on a stride
    or width change (detectron2 BottleneckBlock; stride on the 3x3)."""

    def __init__(self, cin: int, width: int, cout: int, stride: int = 1):
        super().__init__()
        self.shortcut = ConvFrozenBN(cin, cout, 1, stride, relu=False) if cin != cout or stride != 1 else None
        self.conv1 = ConvFrozenBN(cin, width, 1)
        self.conv2 = ConvFrozenBN(width, width, 3, stride, padding=1)
        self.conv3 = ConvFrozenBN(width, cout, 1, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        y = self.conv3(self.conv2(self.conv1(x)))
        return F.relu(y + shortcut)


class ResNet50(nn.Module):
    """Caffe-style R50 returning {res2..res5} feature maps."""

    def __init__(self):
        super().__init__()
        self.stem = ConvFrozenBN(3, 64, 7, 2, padding=3)
        cin = 64
        for name, width, cout, blocks, stride in STAGES:
            for i in range(blocks):
                self.add_module(f"{name}_{i}", Bottleneck(cin, width, cout, stride if i == 0 else 1))
                cin = cout

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.max_pool2d(self.stem(x), 3, stride=2, padding=1)
        out: Dict[str, torch.Tensor] = {}
        for name, _width, _cout, blocks, _stride in STAGES:
            for i in range(blocks):
                x = getattr(self, f"{name}_{i}")(x)
            out[name] = x
        return out


class FPN(nn.Module):
    """Lateral 1x1 + top-down sum + 3x3 output convs -> P2..P5, plus P6 as
    P5 at stride 2 (detectron2 LastLevelMaxPool: a max pool of window 1)."""

    def __init__(self, out_channels: int = 256):
        super().__init__()
        for lvl, cin in zip(range(2, 6), (256, 512, 1024, 2048)):
            self.add_module(f"lateral{lvl}", nn.Conv2d(cin, out_channels, 1))
            self.add_module(f"output{lvl}", nn.Conv2d(out_channels, out_channels, 3, padding=1))

    def forward(self, feats: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        laterals = [getattr(self, f"lateral{lvl}")(feats[f"res{lvl}"]) for lvl in range(2, 6)]
        for i in range(len(laterals) - 2, -1, -1):  # top-down: nearest x2, cropped to the finer map
            th, tw = laterals[i].shape[-2:]
            up = F.interpolate(laterals[i + 1], scale_factor=2.0, mode="nearest")
            laterals[i] = laterals[i] + up[:, :, :th, :tw]
        outputs = [getattr(self, f"output{lvl}")(lat) for lvl, lat in zip(range(2, 6), laterals)]
        outputs.append(outputs[-1][:, :, ::2, ::2])
        return outputs  # [P2, P3, P4, P5, P6], strides 4..64
