"""AttnGAN++ discriminators in PyTorch, NCHW (mirrors
tise_tpu/models/attngan_pp/discriminator.py; reference:
AttnGAN++/discriminators.py).

Three per-scale spectral-norm conv stacks (D_NET64/128/256, :35-98) that
share the D_GET_LOGITS heads (:7-31): an unconditional head and a
conditional head that tiles the sentence embedding over the 4x4 feature
map, concatenated after the features (the JAX package's channel order).
The trunk is exposed on its own (``features``), so that the losses reuse
one trunk pass for the cond, uncond and wrong-pair heads.  The heads return
raw logits, and the losses take BCE with logits, as in the JAX package.

``update_stats`` asks a call to keep its spectral convs' new u in
``pending_u``; ``commit_spectral`` stores them (layers.py::SpectralConv).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tise_tpu_torch.models.attngan_pp.layers import Block3x3LeakyD, DownBlockD, EncodeBy16, commit_spectral

SCALES = (64, 128, 256)


class DLogitsHead(nn.Module):
    """Conditional or unconditional logits head (discriminators.py:7-31)."""

    def __init__(self, ndf: int, nef: int, conditioned: bool = False):
        super().__init__()
        self.conditioned = conditioned
        if conditioned:
            self.joint = Block3x3LeakyD(ndf * 8 + nef, ndf * 8)
        self.out = nn.Conv2d(ndf * 8, 1, 4, stride=4)  # raw logit (the reference applies Sigmoid here)

    def forward(self, h: torch.Tensor, c: Optional[torch.Tensor], update_stats: bool = False) -> torch.Tensor:
        if self.conditioned and c is not None:
            c_map = c[:, :, None, None].expand(-1, -1, 4, 4)
            h = self.joint(torch.cat([h, c_map], dim=1), update_stats)
        return self.out(h).reshape(-1)


class DNet(nn.Module):
    """The discriminator of one scale (64, 128 or 256; discriminators.py:35-98)."""

    def __init__(self, ndf: int, nef: int, scale: int, b_jcu: bool = True):
        super().__init__()
        if scale not in SCALES:
            raise ValueError(f"scale {scale} is not one of {SCALES}")
        self.scale, self.b_jcu = scale, b_jcu
        self.s16 = EncodeBy16(ndf)
        if scale >= 128:
            self.s32 = DownBlockD(ndf * 8, ndf * 16)
            if scale == 128:
                self.s32_1 = Block3x3LeakyD(ndf * 16, ndf * 8)
        if scale >= 256:
            self.s64 = DownBlockD(ndf * 16, ndf * 32)
            self.s64_1 = Block3x3LeakyD(ndf * 32, ndf * 16)
            self.s64_2 = Block3x3LeakyD(ndf * 16, ndf * 8)
        self.cond_head = DLogitsHead(ndf, nef, conditioned=True)
        if b_jcu:
            self.uncond_head = DLogitsHead(ndf, nef, conditioned=False)

    def features(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        """Trunk: image NCHW -> [B, 8 ndf, 4, 4]."""
        h = self.s16(x, update_stats)
        for name in ("s32", "s32_1", "s64", "s64_1", "s64_2"):
            if hasattr(self, name):
                h = getattr(self, name)(h, update_stats)
        return h

    def cond_logits(self, h: torch.Tensor, c: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        return self.cond_head(h, c, update_stats)

    def uncond_logits(self, h: torch.Tensor, update_stats: bool = False) -> Optional[torch.Tensor]:
        return self.uncond_head(h, None, update_stats) if self.b_jcu else None

    def commit_spectral(self) -> None:
        """Store the u that calls with ``update_stats`` kept."""
        commit_spectral(self)
