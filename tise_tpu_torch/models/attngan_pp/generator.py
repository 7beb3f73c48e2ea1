"""AttnGAN++ generator in PyTorch, NCHW (mirrors
tise_tpu/models/attngan_pp/generator.py; reference: AttnGAN++/generators.py).

G_NET (:132-179): CA_NET conditioning augmentation -> INIT_STAGE (fc to
4x4, four upsamples to 64 px) -> two NEXT_STAGEs (spatial word attention,
residual blocks, upsample), each scale through a tanh conv head: images at
64, 128 and 256 px.

Against the JAX package: CA's noise ``eps`` is an argument instead of an RNG
key, so a caller draws it from an explicit ``torch.Generator`` (and it is
cast to the compute dtype, as JAX draws it in that dtype); BatchNorm
follows the module's ``train()``/``eval()`` mode instead of a ``train``
argument.  ``dtype`` is the JAX modules' compute dtype (f32 or bf16;
``layers.py``): under bf16 the images, mu and logvar come out bf16 and
the attention maps f32, and a stage's residual path is f32 where JAX's
type promotion makes it so (the attention's f32 output concatenated with
bf16 features).  ``GanConfig.remat`` checkpoints the stage boundaries
while G trains, with ``torch.utils.checkpoint`` (``GNet``).  The fc's BatchNorm
runs over the flat ``ngf * 4 * 4 * 2`` features, and its GLU output is read
as NHWC [B, 4, 4, ngf] as in the JAX package, then moved to NCHW, so
JAX-trained weights keep their meaning.  Concatenations keep JAX's channel
order ([attention output, h]).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tise_tpu_torch.models.attngan_pp.attention import SpatialAttention
from tise_tpu_torch.models.attngan_pp.layers import Conv2d, Dense, ResBlockG, UpBlock, batch_norm, glu, recomputing


@dataclass(frozen=True)
class GanConfig:
    """Model dims (reference miscc/config.py:50-64 defaults)."""

    gf_dim: int = 128  # GAN.GF_DIM
    df_dim: int = 64  # GAN.DF_DIM
    z_dim: int = 100  # GAN.Z_DIM
    condition_dim: int = 100  # GAN.CONDITION_DIM
    embedding_dim: int = 256  # TEXT.EMBEDDING_DIM
    r_num: int = 2  # GAN.R_NUM
    branch_num: int = 3  # TREE.BRANCH_NUM
    words_num: int = 18  # TEXT.WORDS_NUM
    #: checkpoint G's stages while it trains (``torch.utils.checkpoint``):
    #: their activations are recomputed in the backward pass instead of
    #: kept, for about a third more operations (the JAX ``nn.remat``)
    remat: bool = False


class CANet(nn.Module):
    """Conditioning augmentation: fc -> GLU -> (mu, logvar) -> mu + eps * std
    (generators.py:11-39)."""

    def __init__(self, embedding_dim: int, condition_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.condition_dim = condition_dim
        self.fc = Dense(embedding_dim, condition_dim * 4, dtype=dtype)

    def forward(self, sent_emb: torch.Tensor, eps: torch.Tensor):
        x = glu(self.fc(sent_emb))
        mu, logvar = x[:, :self.condition_dim], x[:, self.condition_dim:]
        return mu + eps.to(mu.dtype) * torch.exp(0.5 * logvar), mu, logvar


def fc_to_4x4(fc: Dense, fc_bn: nn.Module, x: torch.Tensor, ngf: int) -> torch.Tensor:
    """fc -> BN over the flat features -> GLU -> the JAX [B, 4, 4, ngf]
    reshape, as NCHW [B, ngf, 4, 4]."""
    x = glu(fc_bn(fc(x)))
    return x.reshape(x.shape[0], 4, 4, ngf).permute(0, 3, 1, 2)


class InitStage(nn.Module):
    """fc -> 4x4 x 16gf -> four upsamples -> 64x64 x gf (generators.py:42-78)."""

    def __init__(self, ngf: int, in_features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ngf = ngf
        self.fc = Dense(in_features, ngf * 4 * 4 * 2, bias=False, dtype=dtype)
        self.fc_bn = batch_norm(ngf * 4 * 4 * 2, dims=1)
        self.up1 = UpBlock(ngf, ngf // 2, dtype)
        self.up2 = UpBlock(ngf // 2, ngf // 4, dtype)
        self.up3 = UpBlock(ngf // 4, ngf // 8, dtype)
        self.up4 = UpBlock(ngf // 8, ngf // 16, dtype)

    def forward(self, z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        x = fc_to_4x4(self.fc, self.fc_bn, torch.cat([c, z], dim=1), self.ngf)
        return self.up4(self.up3(self.up2(self.up1(x))))  # [B, ngf/16, 64, 64]


def res_blocks(module: nn.Module, r_num: int, channels: int, dtype: torch.dtype = torch.float32) -> None:
    """``res0`` .. ``res{r_num-1}``, the Flax names."""
    for i in range(r_num):
        setattr(module, f"res{i}", ResBlockG(channels, dtype))


def run_res_blocks(module: nn.Module, r_num: int, x: torch.Tensor) -> torch.Tensor:
    for i in range(r_num):
        x = getattr(module, f"res{i}")(x)
    return x


class NextStage(nn.Module):
    """Spatial attention + residual blocks + upsample (generators.py:81-118)."""

    def __init__(self, ngf: int, nef: int, r_num: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.r_num = r_num
        self.attn = SpatialAttention(nef, ngf, dtype)
        res_blocks(self, r_num, ngf * 2, dtype)
        self.up = UpBlock(ngf * 2, ngf, dtype)

    def forward(self, h: torch.Tensor, word_embs: torch.Tensor, mask: Optional[torch.Tensor]):
        attn_out, attn = self.attn(h, word_embs, mask)
        x = run_res_blocks(self, self.r_num, torch.cat([attn_out, h], dim=1))
        return self.up(x), attn


class GetImage(nn.Module):
    """conv3x3 -> tanh image head (generators.py:121-129)."""

    def __init__(self, ngf: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img = Conv2d(ngf, 3, 3, padding=1, bias=False, dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.img(h))


def _remat_contexts():
    """``checkpoint``'s contexts: none for the first pass, ``recomputing``
    (BatchNorm leaves its running statistics alone) for the recompute."""
    return contextlib.nullcontext(), recomputing()


class GNet(nn.Module):
    """Multi-scale generator -> ([images 64/128/256 NCHW], [attention maps
    [B, ih, iw, T]], mu, logvar), computing in ``dtype``.

    With ``cfg.remat``, while G trains under autograd, ``h_net1`` and each
    ``NextStage`` run under ``torch.utils.checkpoint`` (non-reentrant): the
    backward pass recomputes their activations from the stage's inputs.  A
    recompute runs each BatchNorm in train mode again, so it normalises
    with the same batch moments but does not move the running statistics a
    second time (``layers.recomputing``): they move once a step, as under
    JAX's ``nn.remat``.  Nothing random runs inside a stage (CA's ``eps``
    is drawn by the caller, outside), so no RNG state is kept for the
    recompute.  In eval mode, or without autograd, ``remat`` changes
    nothing."""

    def __init__(self, cfg: GanConfig = GanConfig(), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        ngf = cfg.gf_dim
        self.ca_net = CANet(cfg.embedding_dim, cfg.condition_dim, dtype)
        self.h_net1 = InitStage(ngf * 16, cfg.condition_dim + cfg.z_dim, dtype)
        self.img_net1 = GetImage(ngf, dtype)
        if cfg.branch_num > 1:
            self.h_net2 = NextStage(ngf, cfg.embedding_dim, cfg.r_num, dtype)
            self.img_net2 = GetImage(ngf, dtype)
        if cfg.branch_num > 2:
            self.h_net3 = NextStage(ngf, cfg.embedding_dim, cfg.r_num, dtype)
            self.img_net3 = GetImage(ngf, dtype)

    def _stage(self, stage: nn.Module, *args):
        if self.cfg.remat and self.training and torch.is_grad_enabled():
            return checkpoint(stage, *args, use_reentrant=False, context_fn=_remat_contexts)
        return stage(*args)

    def forward(self, z: torch.Tensor, sent_emb: torch.Tensor, word_embs: torch.Tensor,
                mask: Optional[torch.Tensor], eps: torch.Tensor
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor, torch.Tensor]:
        """z [B, z_dim], sent_emb [B, nef], word_embs [B, nef, T], mask [B, T]
        True = PAD, eps [B, condition_dim] (CA's noise)."""
        c_code, mu, logvar = self.ca_net(sent_emb, eps)
        h = self._stage(self.h_net1, z, c_code)
        fake_imgs, attn_maps = [self.img_net1(h)], []
        for stage in (2, 3)[:self.cfg.branch_num - 1]:
            h, a = self._stage(getattr(self, f"h_net{stage}"), h, word_embs, mask)
            fake_imgs.append(getattr(self, f"img_net{stage}")(h))
            attn_maps.append(a)
        return fake_imgs, attn_maps, mu, logvar
