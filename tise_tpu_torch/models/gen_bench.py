"""The generation bench's chain in PyTorch (mirrors
tise_tpu/models/gen_bench.py::build).

The production sampling path: the bi-LSTM text encoder, CA_NET and the
3-stage AttnGAN++ G forward at the COCO eval dims (GF_DIM=64, R_NUM=3,
cfg/eval_coco.yml), 256 px, eval mode, batch 64, seeded weights.  ``dtype``
is G's compute dtype, f32 or bf16 (the JAX ``build(dtype=...)``, which
``tools/gen_bench.py`` runs in both); the text encoder stays f32 in both,
as in the JAX chain.  Captions are drawn from [1, ntoken - 1) so the
per-rep salt ``(seed + i) % 2``, kept from the JAX chain, stays in the
vocabulary.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from tise_tpu_torch.backbones import damsm
from tise_tpu_torch.core.config import resolve_device
from tise_tpu_torch.models import weights as g_weights
from tise_tpu_torch.models.attngan_pp.generator import GanConfig
from tise_tpu_torch.models.generate import draw_noise

COCO_NTOKEN = 27297  # coco captions.pickle vocab size
EVAL_GAN = GanConfig(gf_dim=64, df_dim=32, r_num=3, words_num=20, embedding_dim=256)


class GenBench(NamedTuple):
    """``chain_fn(seed)`` runs ``chain`` salted batch-``batch`` sampling reps
    and returns the sum of their finest images (a device scalar);
    ``step_fn(i)`` is one rep, returning the finest images [B, 3, 256, 256]."""

    chain_fn: Callable[[int], torch.Tensor]
    batch: int
    chain: int
    step_fn: Callable[[int], torch.Tensor]
    gnet: nn.Module


def build(device=None, *, gan: GanConfig = EVAL_GAN, ntoken: int = COCO_NTOKEN, batch: int = 64,
          chain: int = 8, dtype: torch.dtype = torch.float32) -> GenBench:
    """The chain on ``device`` (``None`` is the card) with seeded weights,
    G computing in ``dtype`` (its images come out in it)."""
    device = resolve_device(device)
    text_encoder = damsm.RNNEncoder.from_state_dict(
        damsm.random_rnn_state_dict(0, ntoken, nhidden=gan.embedding_dim // 2), device=device)
    gnet = g_weights.load_generator(g_weights.random_g_state_dict(0, gan), gan, device=device, dtype=dtype)
    host = np.random.RandomState(0)
    caps = torch.from_numpy(host.randint(1, ntoken - 1, (batch, gan.words_num)).astype(np.int64)).to(device)
    lens = host.randint(5, gan.words_num + 1, (batch,))
    mask = caps == 0

    @torch.no_grad()
    def step(i: int) -> torch.Tensor:
        words, sent = text_encoder(caps + i % 2, lens)
        z, eps = draw_noise(0, i, batch, gan.z_dim, gan.condition_dim, device)
        return gnet(z, sent, words, mask, eps)[0][-1]

    def chain_fn(seed: int) -> torch.Tensor:
        return sum(step(seed + i).float().sum() for i in range(chain))

    return GenBench(chain_fn=chain_fn, batch=batch, chain=chain, step_fn=step, gnet=gnet)
