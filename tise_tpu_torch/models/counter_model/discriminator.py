"""CounterModel discriminator in PyTorch, NCHW (mirrors
tise_tpu/models/counter_model/discriminator.py; reference:
CounterModel/discriminators.py).

One multi-scale MSG-GAN discriminator takes every generator scale
(MSG_D_NET(depth=6), :120-158): a 1x1 fRGB conv on the finest image, then
six ``DisGeneralConvBlock``s (MinibatchStdDev concat, +1 channel, :38-101;
two spectral-norm 3x3 convs; a 2x average pool), the next smaller image
concatenated (3 channels) before each later block.  The heads are the
AttnGAN++ D's ``DLogitsHead``s.

Channel order as in the JAX package, on dim 1 here: [image, features] and
then the stddev channel last, so a JAX kernel's input channels load as
they are (``models/weights.py``).  The 4 px image is not read: six blocks
take the 256 px image through fRGB and the five images from 128 down to 8.
The stddev is taken over the batch the call is given, as the JAX package
takes it over the global batch.  ``update_stats`` and ``commit_spectral``
follow the AttnGAN++ D (``attngan_pp/discriminator.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tise_tpu_torch.models.attngan_pp.discriminator import DLogitsHead
from tise_tpu_torch.models.attngan_pp.layers import Block3x3LeakyD, commit_spectral


def minibatch_stddev(x: torch.Tensor) -> torch.Tensor:
    """Append the batch-std summary channel ('all' averaging,
    discriminators.py:54-73): the biased std over the batch with 1e-8
    inside the sqrt, averaged to one scalar, as the last channel."""
    std = torch.sqrt(torch.mean(torch.square(x - x.mean(dim=0, keepdim=True)), dim=0) + 1e-8)
    chan = std.mean().expand(x.shape[0], 1, *x.shape[2:])
    return torch.cat([x, chan], dim=1)


class DisGeneralConvBlock(nn.Module):
    """stddev concat -> Block3x3LeakyD(mid) -> Block3x3LeakyD(out) ->
    2x2 average pool (discriminators.py:104-117); ``cin`` excludes the
    stddev channel."""

    def __init__(self, cin: int, mid_features: int, out_features: int):
        super().__init__()
        self.conv1 = Block3x3LeakyD(cin + 1, mid_features)
        self.conv2 = Block3x3LeakyD(mid_features, out_features)

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        x = self.conv1(minibatch_stddev(x), update_stats)
        return F.avg_pool2d(self.conv2(x, update_stats), 2)


class MSGDNet(nn.Module):
    """The depth-6 multi-scale discriminator: seven images, 4 .. 256 px,
    finest last (the generator's order)."""

    def __init__(self, ndf: int, nef: int, depth: int = 6, b_jcu: bool = True):
        super().__init__()
        self.depth, self.b_jcu = depth, b_jcu
        self.fRGB_0 = nn.Conv2d(3, ndf, 1)
        cin = ndf
        for i in range(depth):
            mid, out = (ndf * 2 ** i, ndf * 2 ** (i + 1)) if i < 3 else (ndf * 8, ndf * 8)
            setattr(self, f"block{i}", DisGeneralConvBlock(cin if i == 0 else 3 + cin, mid, out))
            cin = out
        self.cond_head = DLogitsHead(ndf, nef, conditioned=True)
        if b_jcu:
            self.uncond_head = DLogitsHead(ndf, nef, conditioned=False)

    def features(self, images: Sequence[torch.Tensor], update_stats: bool = False) -> torch.Tensor:
        """[img4, img8, ..., img256] NCHW -> [B, 8 ndf, 4, 4]."""
        out = self.block0(self.fRGB_0(images[-1]), update_stats)
        for i, x in zip(range(1, self.depth), reversed(images[:-1])):
            out = getattr(self, f"block{i}")(torch.cat([x, out], dim=1), update_stats)
        return out

    def cond_logits(self, h: torch.Tensor, c: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        return self.cond_head(h, c, update_stats)

    def uncond_logits(self, h: torch.Tensor, update_stats: bool = False) -> Optional[torch.Tensor]:
        return self.uncond_head(h, None, update_stats) if self.b_jcu else None

    def forward(self, images: Sequence[torch.Tensor], c: Optional[torch.Tensor] = None,
                update_stats: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        h = self.features(images, update_stats)
        return self.cond_head(h, c, update_stats), self.uncond_logits(h, update_stats)

    def commit_spectral(self) -> None:
        """Store the u that calls with ``update_stats`` kept."""
        commit_spectral(self)
