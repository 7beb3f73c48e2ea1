"""CounterModel training step in PyTorch (mirrors
tise_tpu/models/counter_model/trainer.py; reference: CounterModel/trainer.py:230-330).

The AttnGAN++ step's skeleton (``attngan_pp/trainer.py``) with one
multi-scale MSG discriminator: the frozen bi-LSTM encodes the captions ->
ONE G forward in train mode (seven scales, 4 .. 256 px) -> the D update on
the seven-scale reals, the detached fakes and the wrong pairs (real
features [:B-1] with sentences [1:]) -> the G update through the UPDATED D
with its new u: adversarial, the DAMSM terms at the finest scale through
the frozen image encoder (``encode``: K2 and its backward on the card, in
f32 even where the encoder is its bf16 copy) and KL -> a 0.999 EMA of G's
parameters.  The D update's real and fake passes are differentiated one
after the other (the loss is a sum over them), so one pass's graph is held
at a time.  The DAMSM weight lambda defaults to 5 (SURVEY.md component 30;
CounterModel/miscc/utils.py:38).

The multi-scale reals are a 2x average-pool chain from the 256 px image
(the JAX package's MSG-GAN convention; the reference loads them with
BRANCH_NUM=7): so the step uploads and normalizes (K1 under ``half``) only
the batch's finest image.  The noise, the spectral state, Adam and the
in-place state follow the AttnGAN++ step.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tise_tpu_torch.backbones import damsm
from tise_tpu_torch.core.config import resolve_device
from tise_tpu_torch.models import weights as m_weights
from tise_tpu_torch.models.attngan_pp import losses
from tise_tpu_torch.models.attngan_pp.generator import GanConfig
from tise_tpu_torch.models.attngan_pp.trainer import (Batch, TrainConfig, adam, ema_from, ema_generator_state,
                                                      frozen_encoders, load_strict, synthetic_batch, update_ema,
                                                      upload)
from tise_tpu_torch.models.counter_model.discriminator import MSGDNet
from tise_tpu_torch.models.counter_model.generator import CounterGNet
from tise_tpu_torch.ops.preprocess import normalize

SCALES = (4, 8, 16, 32, 64, 128, 256)


def default_config() -> TrainConfig:
    return TrainConfig(damsm=losses.DamsmWeights(lam=5.0))


class CounterModels(NamedTuple):
    gnet: CounterGNet
    dnet: MSGDNet
    text_encoder: damsm.RNNEncoder
    image_encoder: damsm.CNNEncoder


@dataclass
class CounterTrainState:
    """What a step updates: the step count, G (parameters and running
    statistics) and its Adam, the EMA of G's parameters, the MSG D
    (parameters and u) and its Adam."""

    step: int
    gnet: CounterGNet
    g_opt: torch.optim.Adam
    g_ema: Dict[str, torch.Tensor]
    dnet: MSGDNet
    d_opt: torch.optim.Adam

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "g": self.gnet.state_dict(), "g_opt": self.g_opt.state_dict(),
                "g_ema": dict(self.g_ema), "d": self.dnet.state_dict(), "d_opt": self.d_opt.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.step = int(state["step"])
        self.gnet.load_state_dict(state["g"])
        self.g_opt.load_state_dict(state["g_opt"])
        with torch.no_grad():
            for name, v in state["g_ema"].items():
                self.g_ema[name].copy_(v)
        self.dnet.load_state_dict(state["d"])
        self.d_opt.load_state_dict(state["d_opt"])

    @property
    def device(self) -> torch.device:
        return next(self.gnet.parameters()).device

    def ema_generator_state(self) -> Dict[str, np.ndarray]:
        return ema_generator_state(self.gnet, self.g_ema)


def multiscale_reals(img256: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """256 px [-1, 1] NCHW -> the seven scales 4 .. 256, coarsest first."""
    outs = [img256]
    x = img256
    while x.shape[2] > 4:
        x = F.avg_pool2d(x, 2)
        outs.append(x)
    return tuple(reversed(outs))


def build_models(cfg: TrainConfig, text_state: Optional[Dict[str, Any]] = None,
                 image_state: Optional[Dict[str, Any]] = None, device=None) -> CounterModels:
    """G in train mode, the MSG D and the frozen DAMSM encoders on ``device``
    (``None`` is the card, and raises where there is none); seeded encoders
    where a state dict is absent."""
    device = resolve_device(device)
    gan = cfg.gan
    return CounterModels(CounterGNet(gan).to(device).train(), MSGDNet(gan.df_dim, gan.embedding_dim).to(device),
                         *frozen_encoders(cfg, text_state, image_state, device))


def init_state(cfg: TrainConfig, models: CounterModels, seed: int = 0,
               dicts: Optional[m_weights.TrainStateDicts] = None) -> CounterTrainState:
    """Load G and D with ``dicts`` (``weights.train_state_dicts_from_jax(state,
    "counter_model")``), else with seeded weights; the EMA starts as G's
    parameters unless ``dicts`` has one; Adam's moments start at zero."""
    gan = cfg.gan
    if dicts is None:
        dicts = m_weights.TrainStateDicts(0, m_weights.random_g_state_dict(seed, gan, "counter_model"), {},
                                          m_weights.random_msg_d_state_dict(seed + 1, gan.df_dim, gan.embedding_dim))
    load_strict(models.gnet, dicts.g)
    load_strict(models.dnet, dicts.d)
    return CounterTrainState(dicts.step, models.gnet, adam(models.gnet, cfg.g_lr, cfg),
                             ema_from(models.gnet, dicts.g_ema), models.dnet, adam(models.dnet, cfg.d_lr, cfg))


def make_train_step(cfg: TrainConfig, models: CounterModels):
    """-> ``train_step(state, batch, z, eps)``: one step in place, returning
    the metrics (d_loss, g_loss, w_loss, s_loss, kl_loss) as 0-d tensors on
    the device."""

    def train_step(state: CounterTrainState, batch: Batch, z: torch.Tensor, eps: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        device = z.device
        gnet, dnet = state.gnet, state.dnet
        captions = upload(batch.captions, device, torch.int64)
        cap_lens = upload(batch.cap_lens, device, torch.int64)
        class_ids = upload(batch.class_ids, device, torch.int64)
        reals = multiscale_reals(normalize(upload(batch.images[-1], device), "half").to(z.dtype).permute(0, 3, 1, 2))
        with torch.no_grad():  # the text features are detached (trainer.py:142-143)
            words_embs, sent_emb = models.text_encoder(captions, np.asarray(batch.cap_lens))
        mask = captions == 0
        b = captions.shape[0]

        # ---- G forward, once: its graph backs the G update ----
        fakes, _, mu, logvar = gnet(z, sent_emb, words_embs, mask, eps)

        # ---- the D update on the detached fakes ----
        # The D loss adds terms of the real logits to terms of the fake ones, so the real pass's gradient is
        # taken with stand-ins for the fake logits and its graph freed before the fake pass is built: at 256 px
        # and batch 64 a pass holds about 10 GB, which cuDNN otherwise misses for its fast algorithms' workspace.
        real_h = dnet.features(reals, update_stats=True)
        real = (dnet.cond_logits(real_h, sent_emb), dnet.uncond_logits(real_h),
                dnet.cond_logits(real_h[:b - 1], sent_emb[1:]))  # wrong pairs
        stand_in = torch.zeros_like(real[0])
        state.d_opt.zero_grad(set_to_none=True)
        losses.discriminator_loss(real[0], real[1], stand_in, stand_in, real[2]).total.backward()
        real = tuple(r.detach() for r in real)
        fake_h = dnet.features([f.detach() for f in fakes])
        d_parts = losses.discriminator_loss(real[0], real[1], dnet.cond_logits(fake_h, sent_emb),
                                            dnet.uncond_logits(fake_h), real[2])
        d_parts.total.backward()
        state.d_opt.step()
        dnet.commit_spectral()

        # ---- the G update through the updated D ----
        dnet.requires_grad_(False)
        try:
            h = dnet.features(fakes)
            adv = losses.generator_adv_loss(dnet.cond_logits(h, sent_emb), dnet.uncond_logits(h))
            region, cnn_code = models.image_encoder.encode(fakes[-1].permute(0, 2, 3, 1))
            w_loss, s_loss = losses.generator_damsm_loss(region.to(z.dtype), cnn_code.to(z.dtype), words_embs,
                                                         sent_emb, cap_lens, class_ids, cfg.damsm)
            kl = losses.kl_loss(mu, logvar)
            g_loss = adv + w_loss + s_loss + kl
            state.g_opt.zero_grad(set_to_none=True)
            g_loss.backward()
        finally:
            dnet.requires_grad_(True)
        state.g_opt.step()
        update_ema(gnet, state.g_ema, cfg.ema_decay)
        state.step += 1
        return {"d_loss": d_parts.total.detach(), "g_loss": g_loss.detach(), "w_loss": w_loss.detach(),
                "s_loss": s_loss.detach(), "kl_loss": kl.detach()}

    return train_step


def smoke_train(device=None) -> Dict[str, float]:
    """One step on a synthetic batch of 2 at the JAX smoke's small widths
    -> its metrics."""
    from tise_tpu_torch.models.generate import draw_noise

    batch_size = 2
    gan = GanConfig(gf_dim=16, df_dim=16, z_dim=16, condition_dim=16, embedding_dim=32, words_num=8)
    cfg = dataclasses.replace(default_config(), gan=gan, batch_size=batch_size, ntoken=100)
    models = build_models(cfg, device=device)
    state = init_state(cfg, models)
    z, eps = draw_noise(1, 0, batch_size, gan.z_dim, gan.condition_dim, state.device)
    metrics = make_train_step(cfg, models)(state, synthetic_batch(cfg, np.random.RandomState(0), batch_size), z, eps)
    return {k: float(v) for k, v in metrics.items()}


def main(argv=None) -> Optional[list]:
    """``--smoke`` runs one step on a synthetic batch; any other flags are
    the training CLI's, forwarded to ``tise_tpu_torch.models.main`` with
    ``--model counter_model`` (the reference's CounterModel/main.py is a
    near-copy of the AttnGAN++ one; here it is the same entry point)."""
    import argparse
    import sys

    from tise_tpu_torch.core.config import add_device_flag

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--smoke" in argv:
        p = argparse.ArgumentParser()
        p.add_argument("--smoke", action="store_true")
        add_device_flag(p)
        args = p.parse_args(argv)
        print({k: round(v, 4) for k, v in smoke_train(device=resolve_device(args.device)).items()})
        return None
    from tise_tpu_torch.models import main as models_main

    return models_main.main(["--model", "counter_model", *argv])


if __name__ == "__main__":
    main()
