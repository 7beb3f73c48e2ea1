"""Attention of AttnGAN++ in PyTorch (mirrors
tise_tpu/models/attngan_pp/attention.py; reference: AttnGAN++/attention.py).

``SpatialAttention`` (:57-109), the generator's word -> pixel attention:
the words are projected to the feature width by a bias-free dense layer
(the reference's 1x1 conv on the word axis), each pixel's feature queries
them, and the softmax runs over words with padding masked.
``func_attention`` (:16-54), the DAMSM word <-> region attention: softmax
over words, then a gamma1-scaled softmax over regions.  The mask value is
``NEG_INF = -1e9``, not -inf, as in the JAX package: a caption that is all
padding gives a uniform softmax, not NaN.

Under a bf16 compute dtype the word projection runs in bf16 and both
products accumulate in f32 and give f32, as the JAX einsums with
``preferred_element_type=float32`` do (attention.py:36,41,64,68): the
scores and the softmax are f32, and the words read back are f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tise_tpu_torch.models.attngan_pp.layers import Dense, at_least_f32

NEG_INF = -1e9


def masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax over the last axis (words) of [B, Q, T]; ``mask`` [B, T] is
    True where a word is padding."""
    if mask is not None:
        scores = scores.masked_fill(mask[:, None, :], NEG_INF)
    return torch.softmax(scores, dim=-1)


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated in f32 with an f32 result where the operands
    are bf16 (a product of two bf16 values is exact in f32), in the
    operands' own dtype otherwise: ``preferred_element_type=float32``."""
    return torch.bmm(at_least_f32(a), at_least_f32(b))


def func_attention(query: torch.Tensor, context: torch.Tensor, gamma1: float,
                   query_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """DAMSM double-softmax attention (attention.py:16-54).

    query [B, D, Tq] (word features), context [B, D, S] (regions),
    query_mask [B, Tq] True for a valid word -> (the regions read back per
    word [B, D, Tq], the attention over regions [B, Tq, S])."""
    attn = torch.bmm(context.transpose(1, 2), query)  # [B, S, Tq]
    if query_mask is not None:
        attn = attn.masked_fill(~query_mask[:, None, :], NEG_INF)
    attn = torch.softmax(attn, dim=-1)  # over words (Eq. 8)
    attn = torch.softmax(attn * gamma1, dim=1)  # over regions (Eq. 9)
    return torch.bmm(context, attn), attn.transpose(1, 2)


class SpatialAttention(nn.Module):
    def __init__(self, cdf: int, idf: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_context = Dense(cdf, idf, bias=False, dtype=dtype)

    def forward(self, h: torch.Tensor, word_embs: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """h [B, idf, ih, iw]; word_embs [B, cdf, T]; mask [B, T] True = PAD
        -> (the words read back per pixel [B, idf, ih, iw], the attention
        [B, ih, iw, T], the JAX package's layout)."""
        b, idf, ih, iw = h.shape
        keys = self.conv_context(word_embs.transpose(1, 2))  # [B, T, idf]
        q = h.flatten(2).transpose(1, 2)  # [B, ih*iw, idf]
        attn = masked_softmax(bmm_f32(q, keys.transpose(1, 2)), mask)
        out = bmm_f32(attn, keys).transpose(1, 2).reshape(b, idf, ih, iw)
        return out, attn.reshape(b, ih, iw, -1)
