"""AttnGAN++ training step in PyTorch (mirrors
tise_tpu/models/attngan_pp/trainer.py; reference: AttnGAN++/trainer.py).

One step (trainer.py:297-418): the frozen bi-LSTM encodes the captions ->
ONE G forward in train mode (its BatchNorm statistics move once) -> the
three D updates on the detached fakes (Adam 2e-4, betas (0.5, 0.999)) ->
the G update through the UPDATED discriminators, with the adversarial
terms, the DAMSM terms through the frozen image encoder on the finest
scale, and KL; G's backward runs through the graph the one forward kept ->
a 0.999 EMA of G's parameters.

Against the JAX step (``make_train_step``), which is one jitted program:

  * the step runs eagerly and updates ``TrainState`` in place (the modules'
    parameters, G's running statistics, each D's u, the optimisers, the
    EMA) and returns the metrics as 0-d tensors on the device;
  * the noise comes in as arguments: z [B, z_dim] and CA's eps
    [B, condition_dim], which the JAX step draws from
    ``split(fold_in(rng, step))``; the training loop draws them through
    ``models/generate.py::draw_noise``, and tests hand in JAX's draws;
  * batches carry uint8 images at every scale; the step uploads them and
    normalizes them on the device with K1 under ``half`` (x / 127.5 - 1);
  * spectral state: every spectral conv of a step starts from the u of the
    step's start; only the D trunk's u of the real-image pass is stored,
    after that D's update (``DNet.commit_spectral``); the heads' and the
    G loss's passes store nothing (the JAX step discards those ``mutable``
    collections);
  * Adam is ``torch.optim.Adam``, whose eps is added outside the
    bias-corrected sqrt(v) as in ``optax.adam``.

``make_sharded_train_step`` is the step of one process on its shard of a
global batch (tise_tpu/models/attngan_pp/trainer.py:320-340): every
process ends the step with the same state, equal to one process's step on
the global batch up to f32 rounding.  Three places couple a batch's rows,
and each is made global: G's train-mode BatchNorm takes the global batch's
mean and biased variance (``layers.synced_batch_norm``); the DAMSM losses
rank this process's images against the global batch's captions and take
its own rows (``losses``), and the D's wrong pairs cross the processes'
boundaries; each process's loss is its share of the global loss times the
number of processes, and the gradients are averaged over the processes
before each Adam update (``average_gradients``: one forward feeds several
backward passes, so this is done by hand rather than by DDP).

Left out: the JAX step's ``ablate`` profiling hook and ``GanConfig.remat``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tise_tpu_torch.backbones import damsm
from tise_tpu_torch.core.config import resolve_device
from tise_tpu_torch.models import weights as m_weights
from tise_tpu_torch.models.attngan_pp import layers, losses
from tise_tpu_torch.models.attngan_pp.discriminator import SCALES, DNet
from tise_tpu_torch.models.attngan_pp.generator import GanConfig, GNet
from tise_tpu_torch.ops.preprocess import normalize
from tise_tpu_torch.parallel import gather_rows, group_size


@dataclass(frozen=True)
class TrainConfig:
    gan: GanConfig = field(default_factory=GanConfig)
    batch_size: int = 64  # TRAIN.BATCH_SIZE
    g_lr: float = 2e-4  # TRAIN.GENERATOR_LR
    d_lr: float = 2e-4  # TRAIN.DISCRIMINATOR_LR
    beta1: float = 0.5  # Adam betas (trainer.py:141,146)
    beta2: float = 0.999
    ema_decay: float = 0.999  # trainer.py:387-388
    max_epoch: int = 600
    snapshot_interval: int = 5
    ntoken: int = 5450  # vocabulary size (dataset-dependent)
    damsm: losses.DamsmWeights = field(default_factory=losses.DamsmWeights)
    #: the frozen DAMSM image encoder inside the G loss: "fast" runs its
    #: forward and backward in bf16 (the loss and everything trainable stay
    #: f32); "highest" matches the reference's f32 training
    encoder_precision: str = "highest"


class Models(NamedTuple):
    gnet: GNet
    dnets: Dict[int, DNet]
    text_encoder: damsm.RNNEncoder
    image_encoder: damsm.CNNEncoder


class Batch(NamedTuple):
    """One training batch (prepare_data semantics, datasets.py:25-51): uint8
    NHWC images at every scale, numpy or tensors."""

    images: Tuple[Any, ...]  # ([B,64,64,3], [B,128,128,3], [B,256,256,3]) uint8
    captions: Any  # int [B, T], 0 is padding
    cap_lens: Any  # int [B]
    class_ids: Any  # int [B]


@dataclass
class TrainState:
    """What a step updates: the step count, G (parameters and running
    statistics) and its Adam, the EMA of G's parameters, each scale's D
    (parameters and u) and its Adam."""

    step: int
    gnet: GNet
    g_opt: torch.optim.Adam
    g_ema: Dict[str, torch.Tensor]
    dnets: Dict[int, DNet]
    d_opts: Dict[int, torch.optim.Adam]

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "g": self.gnet.state_dict(), "g_opt": self.g_opt.state_dict(),
                "g_ema": dict(self.g_ema), "d": {s: d.state_dict() for s, d in self.dnets.items()},
                "d_opt": {s: o.state_dict() for s, o in self.d_opts.items()}}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.step = int(state["step"])
        self.gnet.load_state_dict(state["g"])
        self.g_opt.load_state_dict(state["g_opt"])
        with torch.no_grad():
            for name, v in state["g_ema"].items():
                self.g_ema[name].copy_(v)
        for s, d in self.dnets.items():
            d.load_state_dict(state["d"][s])
            self.d_opts[s].load_state_dict(state["d_opt"][s])

    @property
    def device(self) -> torch.device:
        return next(self.gnet.parameters()).device

    def ema_generator_state(self) -> Dict[str, np.ndarray]:
        return ema_generator_state(self.gnet, self.g_ema)


def ema_generator_state(gnet: torch.nn.Module, g_ema: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """G's state dict with the EMA in place of the parameters (the running
    statistics are G's own), numpy leaves: what
    ``weights.save_generator_npz`` writes for the generate CLIs."""
    out = {k: v.detach().cpu().numpy() for k, v in gnet.state_dict().items()}
    out.update({k: v.detach().cpu().numpy() for k, v in g_ema.items()})
    return out


def ema_from(gnet: torch.nn.Module, g_ema: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The EMA of G's parameters: ``g_ema``'s arrays where it has them, else
    copies of G's parameters.  ``torch.tensor`` copies: the EMA is updated in
    place and must not write into the caller's arrays."""
    return {k: (torch.tensor(np.asarray(g_ema[k]), dtype=p.dtype, device=p.device) if k in g_ema
                else p.detach().clone()) for k, p in gnet.named_parameters()}


def update_ema(gnet: torch.nn.Module, g_ema: Dict[str, torch.Tensor], decay: float) -> None:
    """g_ema <- decay g_ema + (1 - decay) G, after G's update (trainer.py:387-388)."""
    with torch.no_grad():
        for name, p in gnet.named_parameters():
            g_ema[name].mul_(decay).add_(p, alpha=1.0 - decay)


def adam(module: torch.nn.Module, lr: float, cfg: TrainConfig) -> torch.optim.Adam:
    return torch.optim.Adam(module.parameters(), lr=lr, betas=(cfg.beta1, cfg.beta2), eps=1e-8)


def build_models(cfg: TrainConfig, text_state: Optional[Dict[str, Any]] = None,
                 image_state: Optional[Dict[str, Any]] = None, device=None) -> Models:
    """G in train mode, one D a scale, and the frozen DAMSM encoders on
    ``device`` (``None`` is the card, and raises where there is none).
    Encoder state dicts in the reference's layout; seeded ones where absent
    (smoke runs), as the JAX ``init_state`` initialises them at random.
    Under ``encoder_precision="fast"`` the image encoder is its bf16 copy."""
    device = resolve_device(device)
    gan = cfg.gan
    gnet = GNet(gan).to(device).train()
    dnets = {s: DNet(gan.df_dim, gan.embedding_dim, s).to(device) for s in SCALES[:gan.branch_num]}
    return Models(gnet, dnets, *frozen_encoders(cfg, text_state, image_state, device))


def frozen_encoders(cfg: TrainConfig, text_state: Optional[Dict[str, Any]], image_state: Optional[Dict[str, Any]],
                    device: torch.device) -> Tuple[damsm.RNNEncoder, damsm.CNNEncoder]:
    """The frozen DAMSM encoders of the G loss on ``device``, seeded where a
    state dict is absent; the image encoder's bf16 copy under
    ``encoder_precision="fast"``."""
    gan = cfg.gan
    if text_state is None:
        text_state = damsm.random_rnn_state_dict(0, cfg.ntoken, nhidden=gan.embedding_dim // 2)
    if image_state is None:
        image_state = damsm.random_cnn_state_dict(0, nef=gan.embedding_dim)
    text_encoder = damsm.RNNEncoder.from_state_dict(text_state, device=device).requires_grad_(False)
    image_encoder = damsm.CNNEncoder.from_state_dict(image_state, device=device).requires_grad_(False)
    if cfg.encoder_precision == "fast":
        image_encoder = image_encoder.bf16_copy()
    elif cfg.encoder_precision != "highest":
        raise ValueError(f"unknown encoder_precision {cfg.encoder_precision!r}")
    return text_encoder, image_encoder


def load_strict(module: torch.nn.Module, state: Dict[str, Any]) -> None:
    module.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state.items()}, strict=True)


def init_state(cfg: TrainConfig, models: Models, seed: int = 0,
               dicts: Optional[m_weights.TrainStateDicts] = None) -> TrainState:
    """Load G and the Ds with ``dicts`` (the JAX state carried across by
    ``weights.train_state_dicts_from_jax``), else with seeded weights; the
    EMA starts as G's parameters unless ``dicts`` has one; Adam's moments
    start at zero."""
    gan = cfg.gan
    if dicts is None:
        dicts = m_weights.TrainStateDicts(
            0, m_weights.random_g_state_dict(seed, gan),
            {}, {s: m_weights.random_d_state_dict(seed + s, gan.df_dim, gan.embedding_dim, s) for s in models.dnets})
    load_strict(models.gnet, dicts.g)
    for s, d in models.dnets.items():
        load_strict(d, dicts.d[s])
    return TrainState(dicts.step, models.gnet, adam(models.gnet, cfg.g_lr, cfg), ema_from(models.gnet, dicts.g_ema),
                      models.dnets, {s: adam(d, cfg.d_lr, cfg) for s, d in models.dnets.items()})


def upload(a, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host array -> ``device``, through pinned memory to the card."""
    t = torch.as_tensor(np.ascontiguousarray(a) if isinstance(a, np.ndarray) else a)
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def average_gradients(module: torch.nn.Module, group) -> None:
    """Each gradient of ``module`` <- its mean over the processes of
    ``group`` (one all-reduce of them all); nothing for ``None``."""
    if group is None:
        return
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def local_rows(batch_size: int, group) -> slice:
    """The global rows of this process's shard of a batch: contiguous
    blocks in rank order, as the JAX step shards the batch axis."""
    return losses.own_rows(batch_size // group_size(group), group)


def shard_batch(batch: Batch, group) -> Batch:
    """This process's rows of a global batch (host arrays)."""
    rows = local_rows(len(batch.cap_lens), group)
    return Batch(tuple(im[rows] for im in batch.images), batch.captions[rows], batch.cap_lens[rows],
                 batch.class_ids[rows])


def make_train_step(cfg: TrainConfig, models: Models, group=None):
    """-> ``train_step(state, batch, z, eps)``: one step in place, returning
    the metrics (g_loss, d_loss, w_loss, s_loss, kl_loss, d{scale}_loss) as
    0-d tensors on the device.  ``group``: see
    :func:`make_sharded_train_step`; ``None`` is one process."""
    scales = SCALES[:cfg.gan.branch_num]
    decay = cfg.ema_decay
    world = group_size(group)

    def train_step(state: TrainState, batch: Batch, z: torch.Tensor, eps: torch.Tensor) -> Dict[str, torch.Tensor]:
        device = z.device
        gnet, dnets = state.gnet, state.dnets
        # the text side of the GLOBAL batch: the DAMSM losses and the D's
        # wrong pairs read other processes' captions
        captions, cap_lens, class_ids = (gather_rows(upload(a, device, torch.int64), group)
                                         for a in (batch.captions, batch.cap_lens, batch.class_ids))
        reals = [normalize(upload(im, device), "half").to(z.dtype).permute(0, 3, 1, 2) for im in batch.images]
        with torch.no_grad():  # the text features are detached (trainer.py:178-179)
            words_embs, sent_emb = models.text_encoder(
                captions, np.asarray(batch.cap_lens) if group is None else cap_lens.cpu().numpy())
        mask = captions == 0  # padding is token 0 (trainer.py:316)
        b, rows = z.shape[0], local_rows(captions.shape[0], group)
        total = captions.shape[0]
        sent_local = sent_emb[rows]
        # wrong pairs: real row i against sentence i + 1 for the B - 1 rows i < B - 1
        n_wrong = min(b, total - 1 - rows.start)
        wrong_sent = sent_emb[rows.start + 1:rows.start + 1 + n_wrong]

        # ---- G forward, once: its graph backs the G update ----
        with layers.synced_batch_norm(gnet, group):
            fakes, _, mu, logvar = gnet(z, sent_local, words_embs[rows], mask[rows], eps)

        # ---- D updates on the detached fakes (losses.py:138) ----
        metrics: Dict[str, torch.Tensor] = {}
        d_total = torch.zeros((), device=device)
        for i, s in enumerate(scales):
            d = dnets[s]
            real_h = d.features(reals[i], update_stats=True)
            fake_h = d.features(fakes[i].detach())
            parts = losses.discriminator_loss(
                d.cond_logits(real_h, sent_local), d.uncond_logits(real_h),
                d.cond_logits(fake_h, sent_local), d.uncond_logits(fake_h),
                d.cond_logits(real_h[:n_wrong], wrong_sent),  # wrong pairs (losses.py:146-148)
                wrong_weight=n_wrong * world / (total - 1))
            state.d_opts[s].zero_grad(set_to_none=True)
            parts.total.backward()
            average_gradients(d, group)
            state.d_opts[s].step()
            d.commit_spectral()
            metrics[f"d{s}_loss"] = parts.total.detach()
            d_total = d_total + parts.total.detach()

        # ---- G update through the updated discriminators ----
        for d in dnets.values():
            d.requires_grad_(False)
        try:
            g_loss = torch.zeros((), device=device)
            for i, s in enumerate(scales):
                h = dnets[s].features(fakes[i])
                g_loss = g_loss + losses.generator_adv_loss(dnets[s].cond_logits(h, sent_local),
                                                            dnets[s].uncond_logits(h))
            # DAMSM on the finest scale through the frozen encoder; the loss in
            # G's dtype (f32 under a bf16 encoder too)
            region, cnn_code = models.image_encoder.encode(fakes[-1].permute(0, 2, 3, 1))
            w_loss, s_loss = losses.generator_damsm_loss(region.to(z.dtype), cnn_code.to(z.dtype), words_embs,
                                                         sent_emb, cap_lens, class_ids, cfg.damsm, group)
            kl = losses.kl_loss(mu, logvar)
            g_loss = g_loss + w_loss + s_loss + kl
            state.g_opt.zero_grad(set_to_none=True)
            g_loss.backward()
        finally:
            for d in dnets.values():
                d.requires_grad_(True)
        average_gradients(gnet, group)
        state.g_opt.step()

        update_ema(gnet, state.g_ema, decay)
        state.step += 1
        metrics = {"g_loss": g_loss.detach(), "d_loss": d_total, "w_loss": w_loss.detach(),
                   "s_loss": s_loss.detach(), "kl_loss": kl.detach(), **metrics}
        if group is not None:  # each process's losses are its share times the processes: their mean is global
            values = torch.stack(list(metrics.values()))
            dist.all_reduce(values, group=group)
            metrics = dict(zip(metrics, values / world))
        return metrics

    return train_step


def make_sharded_train_step(cfg: TrainConfig, models: Models, group):
    """-> ``train_step(state, batch, z, eps)`` of one process of ``group``
    (``parallel.step_group``) on its shard of the global batch
    (``shard_batch``: contiguous rows in rank order) and its rows of the
    global z and eps draws.  Every process starts from the same state and
    ends with the same state, the one-process step's on the global batch
    up to f32 rounding; the metrics are the global batch's."""
    return make_train_step(cfg, models, group)


def synthetic_batch(cfg: TrainConfig, rng: np.random.RandomState, batch_size: int) -> Batch:
    """A random batch for smoke runs, with the JAX function's caption draws;
    the images are uint8 here (the JAX ones are floats in [-1, 1])."""
    gan = cfg.gan
    t = gan.words_num
    lens = rng.randint(2, t + 1, size=batch_size).astype(np.int32)
    caps = np.zeros((batch_size, t), np.int32)
    for i, n in enumerate(lens):
        caps[i, :n] = rng.randint(1, cfg.ntoken, size=n)
    imgs = tuple(rng.randint(0, 256, (batch_size, s, s, 3)).astype(np.uint8) for s in SCALES[:gan.branch_num])
    return Batch(images=imgs, captions=caps, cap_lens=lens,
                 class_ids=rng.randint(0, 20, size=batch_size).astype(np.int32))
