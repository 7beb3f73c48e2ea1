"""Word -> pixel attention of the AttnGAN++ generator in PyTorch (mirrors
``SpatialAttention`` of tise_tpu/models/attngan_pp/attention.py; reference:
AttnGAN++/attention.py:57-109).

The words are projected to the feature width by a bias-free dense layer
(the reference's 1x1 conv on the word axis), each pixel's feature queries
them, and the softmax runs over words with padding masked.  The mask value
is ``NEG_INF = -1e9``, not -inf, as in the JAX package: a caption that is
all padding gives a uniform softmax, not NaN.  ``func_attention``, the
DAMSM losses' word-region attention, waits for training.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

NEG_INF = -1e9


def masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax over the last axis (words) of [B, Q, T]; ``mask`` [B, T] is
    True where a word is padding."""
    if mask is not None:
        scores = scores.masked_fill(mask[:, None, :], NEG_INF)
    return torch.softmax(scores, dim=-1)


class SpatialAttention(nn.Module):
    def __init__(self, cdf: int, idf: int):
        super().__init__()
        self.conv_context = nn.Linear(cdf, idf, bias=False)

    def forward(self, h: torch.Tensor, word_embs: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """h [B, idf, ih, iw]; word_embs [B, cdf, T]; mask [B, T] True = PAD
        -> (the words read back per pixel [B, idf, ih, iw], the attention
        [B, ih, iw, T], the JAX package's layout)."""
        b, idf, ih, iw = h.shape
        keys = self.conv_context(word_embs.transpose(1, 2))  # [B, T, idf]
        q = h.flatten(2).transpose(1, 2)  # [B, ih*iw, idf]
        attn = masked_softmax(torch.bmm(q, keys.transpose(1, 2)), mask)
        out = torch.bmm(attn, keys).transpose(1, 2).reshape(b, idf, ih, iw)
        return out, attn.reshape(b, ih, iw, -1)
