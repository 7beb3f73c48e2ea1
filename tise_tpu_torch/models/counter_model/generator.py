"""CounterModel generator in PyTorch, NCHW (mirrors
tise_tpu/models/counter_model/generator.py; reference:
CounterModel/generators.py).

The DM-GAN-style memory generator of the RP-overfitting counter-example:
fc -> 4x4 x 16gf, a tanh image head at every scale (4 .. 256 px, seven
images: MSG-GAN out-skips, generators.py:207-295), plain upBlocks to 64 px,
then two memory stages (:127-193):

  * writing (:160-176): gate = sigmoid(A(words) + B(avg(h))); memory =
    relu(M_w(words)) * gate + relu(M_r(avg(h))) * (1 - gate);
  * key addressing and value reading (:179-182): pixel queries over the
    memory keys, softmax over words with padding masked (-1e9), values read
    back;
  * key response (:185-187): a sigmoid 1x1 gate over [h, readout] blends h
    with the readout, and the blend, doubled channel-wise, runs through the
    residual blocks and the upsample.

Channel order of the concatenations as in the JAX package: [h, mem_out] and
[h_new, h_new].
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tise_tpu_torch.models.attngan_pp.attention import masked_softmax
from tise_tpu_torch.models.attngan_pp.generator import (CANet, GanConfig, GetImage, fc_to_4x4, res_blocks,
                                                        run_res_blocks)
from tise_tpu_torch.models.attngan_pp.layers import UpBlock, batch_norm

SCALES = (4, 8, 16, 32, 64)  # the plain upsampling part: 4 -> 64 px
MULTS = (8, 4, 2, 1)  # its widths after each upsample, in gf


class MemoryStage(nn.Module):
    """NEXT_STAGE_G with the memory mechanism (generators.py:127-193)."""

    def __init__(self, ngf: int, nef: int, r_num: int = 2):
        super().__init__()
        self.r_num = r_num
        self.A = nn.Linear(nef, 1, bias=False)
        self.B = nn.Linear(ngf, 1, bias=False)
        self.M_w = nn.Linear(nef, ngf * 2)
        self.M_r = nn.Linear(ngf, ngf * 2)
        self.key = nn.Linear(ngf * 2, ngf)
        self.value = nn.Linear(ngf * 2, ngf)
        self.response_gate = nn.Conv2d(ngf * 2, 1, 1)
        res_blocks(self, r_num, ngf * 2)
        self.up = UpBlock(ngf * 2, ngf)

    def forward(self, h: torch.Tensor, word_embs: torch.Tensor, mask: Optional[torch.Tensor]):
        b, ngf, ih, iw = h.shape
        words = word_embs.transpose(1, 2)  # [B, T, nef]
        h_avg = h.mean(dim=(2, 3)).detach()  # [B, ngf]
        writing_gate = torch.sigmoid(self.A(words) + self.B(h_avg)[:, None, :])  # [B, T, 1]
        m_w = F.relu(self.M_w(words))
        m_r = F.relu(self.M_r(h_avg))[:, None, :]
        memory = m_w * writing_gate + m_r * (1.0 - writing_gate)  # [B, T, 2ngf]
        key, value = F.relu(self.key(memory)), F.relu(self.value(memory))
        q = h.flatten(2).transpose(1, 2)  # [B, ih*iw, ngf]
        attn = masked_softmax(torch.bmm(q, key.transpose(1, 2)), mask)
        mem_out = torch.bmm(attn, value).transpose(1, 2).reshape(b, ngf, ih, iw)
        gate = torch.sigmoid(self.response_gate(torch.cat([h, mem_out], dim=1)))
        h_new = h * (1.0 - gate) + gate * mem_out
        x = run_res_blocks(self, self.r_num, torch.cat([h_new, h_new], dim=1))
        return self.up(x), attn.reshape(b, ih, iw, -1)


class CounterGNet(nn.Module):
    """Seven-scale out-skip generator (generators.py:207-295) -> ([images
    4..256 px NCHW], [two attention maps [B, ih, iw, T]], mu, logvar)."""

    def __init__(self, cfg: GanConfig = GanConfig()):
        super().__init__()
        self.cfg = cfg
        ngf = cfg.gf_dim
        self.ca_net = CANet(cfg.embedding_dim, cfg.condition_dim)
        self.fc = nn.Linear(cfg.condition_dim + cfg.z_dim, ngf * 16 * 4 * 4 * 2, bias=False)
        self.fc_bn = batch_norm(ngf * 16 * 4 * 4 * 2, dims=1)
        self.img_4 = GetImage(ngf * 16)
        cin = ngf * 16
        for s, m in zip(SCALES, MULTS):
            setattr(self, f"up_{s}_to_{2 * s}", UpBlock(cin, ngf * m))
            setattr(self, f"img_{2 * s}", GetImage(ngf * m))
            cin = ngf * m
        self.mem_64_to_128 = MemoryStage(ngf, cfg.embedding_dim, cfg.r_num)
        self.img_128 = GetImage(ngf)
        self.mem_128_to_256 = MemoryStage(ngf, cfg.embedding_dim, cfg.r_num)
        self.img_256 = GetImage(ngf)

    def forward(self, z: torch.Tensor, sent_emb: torch.Tensor, word_embs: torch.Tensor,
                mask: Optional[torch.Tensor], eps: torch.Tensor
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor, torch.Tensor]:
        c_code, mu, logvar = self.ca_net(sent_emb, eps)
        out = fc_to_4x4(self.fc, self.fc_bn, torch.cat([c_code, z], dim=1), self.cfg.gf_dim * 16)
        fake_imgs, attn_maps = [self.img_4(out)], []
        for s in SCALES[:-1]:
            out = getattr(self, f"up_{s}_to_{2 * s}")(out)
            fake_imgs.append(getattr(self, f"img_{2 * s}")(out))
        for s in (64, 128):
            out, a = getattr(self, f"mem_{s}_to_{2 * s}")(out, word_embs, mask)
            fake_imgs.append(getattr(self, f"img_{2 * s}")(out))
            attn_maps.append(a)
        return fake_imgs, attn_maps, mu, logvar
