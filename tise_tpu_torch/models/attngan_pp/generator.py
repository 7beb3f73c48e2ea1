"""AttnGAN++ generator in PyTorch, NCHW (mirrors
tise_tpu/models/attngan_pp/generator.py; reference: AttnGAN++/generators.py).

G_NET (:132-179): CA_NET conditioning augmentation -> INIT_STAGE (fc to
4x4, four upsamples to 64 px) -> two NEXT_STAGEs (spatial word attention,
residual blocks, upsample), each scale through a tanh conv head: images at
64, 128 and 256 px.

Against the JAX package: CA's noise ``eps`` is an argument instead of an RNG
key, so a caller draws it from an explicit ``torch.Generator``; BatchNorm
follows the module's ``train()``/``eval()`` mode instead of a ``train``
argument; the memory option ``remat`` is left out (it belongs to training,
where ``torch.utils.checkpoint`` is its counterpart).  The fc's BatchNorm
runs over the flat ``ngf * 4 * 4 * 2`` features, and its GLU output is read
as NHWC [B, 4, 4, ngf] as in the JAX package, then moved to NCHW, so
JAX-trained weights keep their meaning.  Concatenations keep JAX's channel
order ([attention output, h]).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn

from tise_tpu_torch.models.attngan_pp.attention import SpatialAttention
from tise_tpu_torch.models.attngan_pp.layers import ResBlockG, UpBlock, batch_norm, glu


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


class CANet(nn.Module):
    """Conditioning augmentation: fc -> GLU -> (mu, logvar) -> mu + eps * std
    (generators.py:11-39)."""

    def __init__(self, embedding_dim: int, condition_dim: int):
        super().__init__()
        self.condition_dim = condition_dim
        self.fc = nn.Linear(embedding_dim, condition_dim * 4)

    def forward(self, sent_emb: torch.Tensor, eps: torch.Tensor):
        x = glu(self.fc(sent_emb))
        mu, logvar = x[:, :self.condition_dim], x[:, self.condition_dim:]
        return mu + eps * torch.exp(0.5 * logvar), mu, logvar


def fc_to_4x4(fc: nn.Linear, fc_bn: nn.Module, x: torch.Tensor, ngf: int) -> torch.Tensor:
    """fc -> BN over the flat features -> GLU -> the JAX [B, 4, 4, ngf]
    reshape, as NCHW [B, ngf, 4, 4]."""
    x = glu(fc_bn(fc(x)))
    return x.reshape(x.shape[0], 4, 4, ngf).permute(0, 3, 1, 2)


class InitStage(nn.Module):
    """fc -> 4x4 x 16gf -> four upsamples -> 64x64 x gf (generators.py:42-78)."""

    def __init__(self, ngf: int, in_features: int):
        super().__init__()
        self.ngf = ngf
        self.fc = nn.Linear(in_features, ngf * 4 * 4 * 2, bias=False)
        self.fc_bn = batch_norm(ngf * 4 * 4 * 2, dims=1)
        self.up1 = UpBlock(ngf, ngf // 2)
        self.up2 = UpBlock(ngf // 2, ngf // 4)
        self.up3 = UpBlock(ngf // 4, ngf // 8)
        self.up4 = UpBlock(ngf // 8, ngf // 16)

    def forward(self, z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        x = fc_to_4x4(self.fc, self.fc_bn, torch.cat([c, z], dim=1), self.ngf)
        return self.up4(self.up3(self.up2(self.up1(x))))  # [B, ngf/16, 64, 64]


def res_blocks(module: nn.Module, r_num: int, channels: int) -> None:
    """``res0`` .. ``res{r_num-1}``, the Flax names."""
    for i in range(r_num):
        setattr(module, f"res{i}", ResBlockG(channels))


def run_res_blocks(module: nn.Module, r_num: int, x: torch.Tensor) -> torch.Tensor:
    for i in range(r_num):
        x = getattr(module, f"res{i}")(x)
    return x


class NextStage(nn.Module):
    """Spatial attention + residual blocks + upsample (generators.py:81-118)."""

    def __init__(self, ngf: int, nef: int, r_num: int = 2):
        super().__init__()
        self.r_num = r_num
        self.attn = SpatialAttention(nef, ngf)
        res_blocks(self, r_num, ngf * 2)
        self.up = UpBlock(ngf * 2, ngf)

    def forward(self, h: torch.Tensor, word_embs: torch.Tensor, mask: Optional[torch.Tensor]):
        attn_out, attn = self.attn(h, word_embs, mask)
        x = run_res_blocks(self, self.r_num, torch.cat([attn_out, h], dim=1))
        return self.up(x), attn


class GetImage(nn.Module):
    """conv3x3 -> tanh image head (generators.py:121-129)."""

    def __init__(self, ngf: int):
        super().__init__()
        self.img = nn.Conv2d(ngf, 3, 3, padding=1, bias=False)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.img(h))


class GNet(nn.Module):
    """Multi-scale generator -> ([images 64/128/256 NCHW], [attention maps
    [B, ih, iw, T]], mu, logvar)."""

    def __init__(self, cfg: GanConfig = GanConfig()):
        super().__init__()
        self.cfg = cfg
        ngf = cfg.gf_dim
        self.ca_net = CANet(cfg.embedding_dim, cfg.condition_dim)
        self.h_net1 = InitStage(ngf * 16, cfg.condition_dim + cfg.z_dim)
        self.img_net1 = GetImage(ngf)
        if cfg.branch_num > 1:
            self.h_net2 = NextStage(ngf, cfg.embedding_dim, cfg.r_num)
            self.img_net2 = GetImage(ngf)
        if cfg.branch_num > 2:
            self.h_net3 = NextStage(ngf, cfg.embedding_dim, cfg.r_num)
            self.img_net3 = GetImage(ngf)

    def forward(self, z: torch.Tensor, sent_emb: torch.Tensor, word_embs: torch.Tensor,
                mask: Optional[torch.Tensor], eps: torch.Tensor
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor, torch.Tensor]:
        """z [B, z_dim], sent_emb [B, nef], word_embs [B, nef, T], mask [B, T]
        True = PAD, eps [B, condition_dim] (CA's noise)."""
        c_code, mu, logvar = self.ca_net(sent_emb, eps)
        h = self.h_net1(z, c_code)
        fake_imgs, attn_maps = [self.img_net1(h)], []
        for stage in (2, 3)[:self.cfg.branch_num - 1]:
            h, a = getattr(self, f"h_net{stage}")(h, word_embs, mask)
            fake_imgs.append(getattr(self, f"img_net{stage}")(h))
            attn_maps.append(a)
        return fake_imgs, attn_maps, mu, logvar
