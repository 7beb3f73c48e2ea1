"""InceptionV3 (torchvision architecture) in PyTorch (mirrors
tise_tpu/backbones/inception_v3.py).

The backbone behind FID / O-FID pool3 features (image_realism/FID/
inception.py:59-95) and, in later slices, O-IS logits and the DAMSM image
encoder trunk.  One trunk produces named endpoints.  Everything is
inference-mode: each BatchNorm is a frozen affine with the stored running
statistics (eps 1e-3), computed as the JAX package computes it.  The module
and parameter names are torchvision's, so a torchvision ``state_dict`` loads
as is; :func:`tise_tpu_torch.core.weights.state_dict_from_jax_params` carries
the JAX package's weights across.

The public forward takes and returns NHWC, as the JAX package does; inside,
the trunk runs ``channels_last`` (NCHW shapes over NHWC memory), so the
NHWC views handed to kernel K2 and returned at the endpoints cost no copy.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tise_tpu_torch.core.config import resolve_device
from tise_tpu_torch.ops.fast_pool import avg_pool_3x3_s1_p1

BN_EPS = 0.001  # torchvision inception BatchNorm2d eps

#: endpoint names in forward order
ENDPOINTS = ("maxpool1", "maxpool2", "mixed6e", "pool3", "logits")

POOL_VARIANTS = ("torch", "tf", "tf2015")


class FrozenBatchNorm2d(nn.Module):
    """Inference BatchNorm with torchvision's buffer names:
    ``x * inv + (bias - mean * inv)``, ``inv = rsqrt(var + eps) * weight``."""

    def __init__(self, num_features: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        shift = self.bias - self.running_mean * inv
        return x * inv.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


class BasicConv2d(nn.Module):
    """conv (no bias) + frozen BN (eps 1e-3) + relu — torchvision BasicConv2d."""

    def __init__(self, cin: int, cout: int, kernel_size, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=padding, bias=False)
        self.bn = FrozenBatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu_(self.bn(self.conv(x)))


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


def _avg_pool_3x3_s1_p1(x: torch.Tensor, count_include_pad: bool) -> torch.Tensor:
    # torch avg_pool2d(3, 1, 1) counts the padding; TF avg_pool SAME (the slim
    # and 2015-GraphDef flavors) divides by the in-bounds taps.  K2 on CUDA.
    x = x.contiguous(memory_format=torch.channels_last)
    return avg_pool_3x3_s1_p1(x.permute(0, 2, 3, 1), count_include_pad).permute(0, 3, 1, 2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, tf_avgpool: bool = False):
        super().__init__()
        self.tf_avgpool = tf_avgpool
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_s1_p1(x, not self.tf_avgpool))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, tf_avgpool: bool = False):
        super().__init__()
        self.tf_avgpool = tf_avgpool
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = m(bd)
        bp = self.branch_pool(_avg_pool_3x3_s1_p1(x, not self.tf_avgpool))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, tf_avgpool: bool = False, maxpool_branch: bool = False):
        super().__init__()
        self.tf_avgpool = tf_avgpool
        self.maxpool_branch = maxpool_branch  # the 2015 GraphDef's mixed_10 quirk
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.maxpool_branch:
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool_3x3_s1_p1(x, not self.tf_avgpool)
        bp = self.branch_pool(bp)
        return torch.cat([b1, b3, bd, bp], 1)


class InceptionV3(nn.Module):
    """torchvision-compatible InceptionV3 trunk with named endpoints.

    Endpoints map onto the reference FID block outputs (FID/inception.py:14-19):
    maxpool1 = dim 64, maxpool2 = dim 192, mixed6e = dim 768, pool3 = dim 2048
    (final average pool), logits = fc output (``num_classes`` wide).

    ``pool_variant``: "torch" — torchvision semantics (FID / O-FID): the pool
    branches divide by 9 including padding; "tf" — TF-slim semantics: divide
    by the in-bounds taps; "tf2015" — "tf" plus the 2015 GraphDef's max-pool
    branch in Mixed_7c.
    """

    def __init__(self, num_classes: int = 1000, pool_variant: str = "torch"):
        super().__init__()
        if pool_variant not in POOL_VARIANTS:
            raise ValueError(f"unknown pool_variant {pool_variant}")
        tf_pool = pool_variant in ("tf", "tf2015")
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, tf_pool)
        self.Mixed_5c = InceptionA(256, 64, tf_pool)
        self.Mixed_5d = InceptionA(288, 64, tf_pool)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, tf_pool)
        self.Mixed_6c = InceptionC(768, 160, tf_pool)
        self.Mixed_6d = InceptionC(768, 160, tf_pool)
        self.Mixed_6e = InceptionC(768, 192, tf_pool)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, tf_pool)
        self.Mixed_7c = InceptionE(2048, tf_pool, maxpool_branch=pool_variant == "tf2015")
        self.fc = nn.Linear(2048, num_classes)

    @classmethod
    def from_state_dict(
        cls, state: Mapping[str, np.ndarray], *, pool_variant: str = "torch", device=None
    ) -> "InceptionV3":
        """An eval-mode, ``channels_last`` trunk on ``device`` holding a
        torchvision-layout state_dict (numpy arrays or tensors).  ``device``
        ``None`` is the card, and raises where there is none; the CPU must be
        asked for.  AuxLogits and BN step counters are ignored; the fc may be
        absent (pool3-only checkpoints), and its width sets ``num_classes``."""
        device = resolve_device(device)
        state = {
            k: torch.tensor(np.asarray(v)) for k, v in state.items()
            if not k.startswith("AuxLogits.") and not k.endswith("num_batches_tracked")
        }
        num_classes = state["fc.weight"].shape[0] if "fc.weight" in state else 1000
        model = cls(num_classes, pool_variant)
        missing, unexpected = model.load_state_dict(state, strict=False)
        if unexpected or set(missing) - {"fc.weight", "fc.bias"}:
            raise KeyError(f"state_dict mismatch: missing {sorted(missing)}, unexpected {sorted(unexpected)}")
        return model.eval().to(device=device, memory_format=torch.channels_last)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, endpoints: Sequence[str] = ("pool3",)) -> Dict[str, torch.Tensor]:
        """x: float NHWC [B, H, W, 3] -> {endpoint: NHWC feature map or [B, D]}."""
        want = set(endpoints)
        for e in want:
            if e not in ENDPOINTS:
                raise ValueError(f"unknown endpoint {e}")
        last = max(ENDPOINTS.index(e) for e in want)
        out: Dict[str, torch.Tensor] = {}

        def tap(name: str, v: torch.Tensor) -> None:
            if name in want:
                out[name] = v.permute(0, 2, 3, 1) if v.dim() == 4 else v

        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        tap("maxpool1", x)
        if last == 0:
            return out
        x = _max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        tap("maxpool2", x)
        if last == 1:
            return out
        for m in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                  self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
            x = m(x)
        tap("mixed6e", x)
        if last == 2:
            return out
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        x = torch.mean(x, dim=(2, 3))  # adaptive avg pool to 1x1
        tap("pool3", x)
        if last == 3:
            return out
        tap("logits", self.fc(x))
        return out


def random_state_dict(seed: int = 0, num_classes: int = 1000) -> Dict[str, np.ndarray]:
    """Random but well-conditioned torchvision-layout weights, made with numpy
    from ``seed`` (tests, smoke runs; real runs load converted weights).

    The init of tests/torch_inception_ref.py:172-188 — conv N(0, 0.05), BN
    scale N(1, 0.1), bias and running mean N(0, 0.1), running var U(0.5, 1.5),
    fc N(0, 0.02) — keeps the deep activations from collapsing, which the
    framework default init does at pool3.
    """
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in InceptionV3(num_classes).state_dict().items()}
    rng = np.random.RandomState(seed)
    out: Dict[str, np.ndarray] = {}
    for k, shape in shapes.items():
        if k.endswith("conv.weight"):
            v = rng.normal(0.0, 0.05, shape)
        elif k.endswith("bn.weight"):
            v = rng.normal(1.0, 0.1, shape)
        elif k.endswith(("bn.bias", "bn.running_mean")):
            v = rng.normal(0.0, 0.1, shape)
        elif k.endswith("bn.running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif k.startswith("fc."):
            v = rng.normal(0.0, 0.02, shape)
        else:
            raise KeyError(k)
        out[k] = v.astype(np.float32)
    return out
