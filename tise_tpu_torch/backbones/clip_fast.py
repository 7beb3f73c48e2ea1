"""Throughput-path CLIP ViT-B/32 image tower in bf16 (mirrors
tise_tpu/backbones/clip_fast.py).

The f32 module (backbones/clip_vit.py) stays the reference; this is the
``--precision fast`` image tower of RP-COCO and PA:

  * the weights are folded once into pre-cast tensors: bf16 matrices, f32
    biases, LayerNorm parameters and embeddings;
  * patchify is one matmul over the im2col rows (reshape, no convolution);
  * LayerNorm is single-pass (mean and E[x^2] in one sweep) in f32;
  * the dense ops run on explicitly flattened [B*T, D] rows in bf16, with
    the bias added in f32 and the sum rounded to bf16, as the JAX tower
    does; QuickGELU's sigmoid in f32.

Two differences from the JAX tower, neither of which changes the function:
the JAX tower packs four images into one attention matmul with a
block-diagonal -inf mask (a layout for the TPU's 128-row tiles, exact
because exp(-inf) = 0); here attention runs per image.  And the JAX
patchify keeps its f32 product (``preferred_element_type``), where here the
bf16 matmul rounds it to bf16 before the f32 class and position embeddings
are added (PyTorch's CPU matmul has no f32 output for bf16 operands).  The
JAX package's ``input_recipe`` fold (normalize folded into the patchify) is
not ported: its scorer does not use it, and kernel K1 normalizes every batch.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tise_tpu_torch.core.config import resolve_device

LN_EPS = 1e-5


def _ln(x: torch.Tensor, ln: Tuple[torch.Tensor, torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """Single-pass LayerNorm over the last axis of [M, D] (f32 math)."""
    x = x.float()
    m = x.mean(dim=-1, keepdim=True)
    v = (x * x).mean(dim=-1, keepdim=True) - m * m
    y = (x - m) * torch.rsqrt(v + LN_EPS)
    return (y * ln[0] + ln[1]).to(dtype)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``(x @ w.T + b)`` as the JAX tower computes it: the product in the
    compute dtype, the f32 bias added, the sum rounded to the compute dtype."""
    return (F.linear(x, w) + b).to(dtype)


class FastCLIPVisual:
    """Pre-cast bf16 image-tower forward from an OpenAI-layout state dict
    (clip_vit.py's keys)."""

    def __init__(self, state_dict: Mapping[str, Any], dtype: torch.dtype = torch.bfloat16, heads: int = 12,
                 device=None):
        device = resolve_device(device)
        self.dtype, self.heads = dtype, heads

        def f32(key: str) -> torch.Tensor:
            return torch.as_tensor(np.array(state_dict[key], dtype=np.float32), device=device)

        def ln(prefix: str) -> Tuple[torch.Tensor, torch.Tensor]:
            return f32(f"{prefix}.weight"), f32(f"{prefix}.bias")

        conv = f32("visual.conv1.weight")  # [D, 3, p, p]
        self.width, self.patch = conv.shape[0], conv.shape[-1]
        # patchify as a matmul: rows are the conv's patches in (ky, kx, c) order
        self.wpatch = conv.permute(0, 2, 3, 1).reshape(self.width, -1).to(dtype)
        self.cls = f32("visual.class_embedding")
        self.pos = f32("visual.positional_embedding")
        self.ln_pre, self.ln_post = ln("visual.ln_pre"), ln("visual.ln_post")
        self.proj = f32("visual.proj").T.contiguous().to(dtype)
        layers = 1 + max(int(k.split(".")[3]) for k in state_dict if k.startswith("visual.transformer.resblocks."))
        self.blocks = []
        for i in range(layers):
            p = f"visual.transformer.resblocks.{i}"
            self.blocks.append(dict(
                ln1=ln(f"{p}.ln_1"), ln2=ln(f"{p}.ln_2"),
                wqkv=f32(f"{p}.attn.in_proj_weight").to(dtype), bqkv=f32(f"{p}.attn.in_proj_bias"),
                wo=f32(f"{p}.attn.out_proj.weight").to(dtype), bo=f32(f"{p}.attn.out_proj.bias"),
                w1=f32(f"{p}.mlp.c_fc.weight").to(dtype), b1=f32(f"{p}.mlp.c_fc.bias"),
                w2=f32(f"{p}.mlp.c_proj.weight").to(dtype), b2=f32(f"{p}.mlp.c_proj.bias"),
            ))

    def _attention(self, qkv: torch.Tensor, b: int, t: int) -> torch.Tensor:
        """qkv rows [B*T, 3*D] -> attention output rows [B*T, D], per image.
        The scores stay in the compute dtype; the softmax reduces in f32."""
        h = self.heads
        hd = self.width // h
        q, k, v = qkv.view(b, t, 3, h, hd).permute(2, 0, 3, 1, 4).unbind(0)  # [B, H, T, hd] each
        s = (q * hd ** -0.5) @ k.transpose(-1, -2)
        a = torch.softmax(s.float(), dim=-1).to(self.dtype)
        return (a @ v).transpose(1, 2).reshape(b * t, self.width)

    def _block(self, xf: torch.Tensor, blk: Dict[str, torch.Tensor], b: int, t: int) -> torch.Tensor:
        d = self.dtype
        qkv = _dense(_ln(xf, blk["ln1"], d), blk["wqkv"], blk["bqkv"], d)
        xf = xf + _dense(self._attention(qkv, b, t), blk["wo"], blk["bo"], d)
        y = _dense(_ln(xf, blk["ln2"], d), blk["w1"], blk["b1"], d)
        y = y * torch.sigmoid(1.702 * y.float()).to(d)
        return xf + _dense(y, blk["w2"], blk["b2"], d)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """normalized image NHWC [B, 224, 224, 3] -> [B, 512] in the compute dtype."""
        d = self.dtype
        b, hh, ww, c = x.shape
        p = self.patch
        g = hh // p
        patches = x.to(d).reshape(b, g, p, g, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b * g * g, p * p * c)
        tok = F.linear(patches, self.wpatch).float().view(b, g * g, self.width)
        xt = torch.cat([self.cls.expand(b, 1, -1), tok], dim=1) + self.pos
        t = g * g + 1
        xf = _ln(xt.view(b * t, self.width), self.ln_pre, d)
        for blk in self.blocks:
            xf = self._block(xf, blk, b, t)
        out = _ln(xf.view(b, t, self.width)[:, 0], self.ln_post, d)
        return F.linear(out, self.proj)
