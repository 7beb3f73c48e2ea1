"""Generator building blocks of AttnGAN++ and CounterModel in PyTorch, NCHW
(mirrors the generator side of tise_tpu/models/attngan_pp/layers.py;
reference: AttnGAN++/layers.py).

  * GLU halves the channels, a * sigmoid(b) (:7-15): the channel axis is
    dim 1 here, the last axis in the JAX package, so a dense layer's
    features [B, F] and a feature map's channels split alike;
  * upBlock: nearest 2x upsample -> conv3x3 -> BN -> GLU (:29-36);
  * ResBlock: conv/BN/GLU/conv/BN + skip (:45-60).

The JAX package's ``SyncBatchNorm`` is a BatchNorm whose moments are global
over the sharded batch; generation runs it with ``train=False``, where it
reads its running statistics, so here it is a plain ``nn.BatchNorm`` with
eps 1e-5.  Flax's ``momentum=0.9`` (weight of the old running value) is
torch's ``momentum=0.1`` (weight of the batch's); it matters only to
training.  Submodules keep the Flax names with ``Conv_i`` as ``conv{i}``
and ``SyncBatchNorm_0/bn`` as ``bn``
(``generator.py::g_state_dict_from_jax_params``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch's convention; Flax's momentum=0.9


def glu(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=1)
    return a * torch.sigmoid(b)


def batch_norm(features: int, dims: int = 2) -> nn.Module:
    """The JAX ``SyncBatchNorm`` (eval mode reads the running statistics)."""
    cls = nn.BatchNorm2d if dims == 2 else nn.BatchNorm1d
    return cls(features, eps=BN_EPS, momentum=BN_MOMENTUM)


def nearest_upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Each pixel repeated factor x factor times (NCHW)."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class Block3x3Relu(nn.Module):
    """conv3x3(out*2) -> BN -> GLU, keeps spatial size (layers.py:40-42)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv0 = conv3x3(cin, features * 2)
        self.bn = batch_norm(features * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return glu(self.bn(self.conv0(x)))


class UpBlock(Block3x3Relu):
    """nearest 2x -> conv3x3(out*2) -> BN -> GLU (layers.py:29-36)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(nearest_upsample(x))


class ResBlockG(nn.Module):
    """Generator residual block (layers.py:45-60)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv0 = conv3x3(channels, channels * 2)
        self.bn1 = batch_norm(channels * 2)
        self.conv1 = conv3x3(channels, channels)
        self.bn2 = batch_norm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = glu(self.bn1(self.conv0(x)))
        return x + self.bn2(self.conv1(y))
