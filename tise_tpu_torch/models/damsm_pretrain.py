"""DAMSM encoder pretraining in PyTorch (mirrors tise_tpu/models/damsm_pretrain.py;
reference: AttnGAN++/pretrain_DAMSM.py, copied byte for byte into CounterModel).

Trains the bi-LSTM text encoder and the two projection heads of the CNN
image encoder (``emb_features``, ``emb_cnn_code``; the InceptionV3 trunk is
frozen, its BatchNorms in eval mode) with the symmetric word- and
sentence-level DAMSM losses, Adam (lr 2e-4, betas (0.5, 0.999)) and the
text encoder's gradient clipped to a global norm of 0.25.  As in the JAX
package, ``words_loss``'s third value is dropped: the reference's script
unpacks a fourth "competition" term that its losses.py does not return, and
it is not ported.

Against the JAX step (one jitted program):

  * the step runs eagerly and updates ``DamsmTrainState`` in place; the
    trunk runs under ``torch.no_grad()`` (``CNNEncoder.encode_heads``), so
    no graph of it is kept, and the text encoder under autograd
    (``RNNEncoder.encode``);
  * images come to the card as uint8 at the finest scale and K1 normalizes
    them there under ``half``;
  * the clip is optax's ``clip_by_global_norm``: g x 0.25 / |g| where
    |g| >= 0.25 (``torch.nn.utils.clip_grad_norm_`` divides by |g| + 1e-6);
  * the learning rate of step k is ``make_lr_schedule``'s lr(k), set on both
    Adams before their update (optax reads its count before incrementing
    it).

    python -m tise_tpu_torch.models.damsm_pretrain --data_dir data/birds \\
        --output_dir output/DAMSM [--batch_size 64 --max_epoch 600] [--device cpu]

Best encoders by validation loss go to ``best_text_encoder.npz`` and
``best_image_encoder.npz`` in the JAX package's ``{"params": ...}`` layout,
which ``models.main --net_e/--image_encoder``, RP-CUB and both packages'
loaders read; snapshots to ``checkpoints/epoch_<n>.pt``, the newest kept,
resumed from by the next run.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tise_tpu_torch.backbones import damsm
from tise_tpu_torch.core.config import add_device_flag, configure_precision, resolve_device
from tise_tpu_torch.core.weights import save_pytree_npz
from tise_tpu_torch.models.attngan_pp import losses
from tise_tpu_torch.models.attngan_pp.train_loop import make_logger, run_epochs
from tise_tpu_torch.models.attngan_pp.trainer import upload
from tise_tpu_torch.ops.preprocess import normalize


@dataclass(frozen=True)
class DamsmPretrainConfig:
    ntoken: int
    embedding_dim: int = 256  # TEXT.EMBEDDING_DIM
    lr: float = 2e-4  # TRAIN.ENCODER_LR
    rnn_grad_clip: float = 0.25  # TRAIN.RNN_GRAD_CLIP
    batch_size: int = 64  # TRAIN.BATCH_SIZE (miscc/config.py:29)
    words_num: int = 18
    max_epoch: int = 600  # TRAIN.MAX_EPOCH (miscc/config.py:30)
    snapshot_interval: int = 5  # TRAIN.SNAPSHOT_INTERVAL (miscc/config.py:31)
    weights: losses.DamsmWeights = field(default_factory=losses.DamsmWeights)


def make_lr_schedule(lr0: float, steps_per_epoch: int) -> Callable[[int], float]:
    """The reference's per-epoch decay (pretrain_DAMSM.py:365-366): lr *=
    0.98 at each epoch's end while lr > lr0/10, then frozen.  As a step
    schedule: lr(step) = lr0 0.98^min(epoch, E), E the first epoch count at
    which the decayed lr reaches lr0/10 (114)."""
    e_floor, lr = 0, lr0
    while lr > lr0 / 10.0:
        lr *= 0.98
        e_floor += 1
    return lambda step: lr0 * 0.98 ** min(step // steps_per_epoch, e_floor)


@dataclass
class DamsmTrainState:
    """What a step updates: the step count, the text encoder and its Adam,
    the image encoder's two heads and their Adam (the trunk is frozen)."""

    step: int
    text_encoder: damsm.RNNEncoder
    image_encoder: damsm.CNNEncoder
    rnn_opt: torch.optim.Adam
    cnn_opt: torch.optim.Adam

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "text": self.text_encoder.state_dict(), "image": self.image_encoder.state_dict(),
                "rnn_opt": self.rnn_opt.state_dict(), "cnn_opt": self.cnn_opt.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.step = int(state["step"])
        self.text_encoder.load_state_dict(state["text"])
        self.image_encoder.load_state_dict(state["image"])
        self.rnn_opt.load_state_dict(state["rnn_opt"])
        self.cnn_opt.load_state_dict(state["cnn_opt"])

    @property
    def device(self) -> torch.device:
        return self.text_encoder.encoder.weight.device

    def encoder_state_dicts(self) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """(text, image) encoders as reference-layout state dicts, numpy
        leaves (the trunk's unused fc and BatchNorm counters left out)."""
        text = {k: v.detach().cpu().numpy() for k, v in self.text_encoder.state_dict().items()}
        image = {k.removeprefix("trunk."): v.detach().cpu().numpy()
                 for k, v in self.image_encoder.state_dict().items()
                 if not k.startswith("trunk.fc.") and not k.endswith("num_batches_tracked")}
        return text, image


def init_state(cfg: DamsmPretrainConfig, text_state: Optional[Dict[str, Any]] = None,
               image_state: Optional[Dict[str, Any]] = None, device=None, seed: int = 0) -> DamsmTrainState:
    """The encoders on ``device`` (``None`` is the card, and raises where
    there is none) from reference-layout state dicts, seeded full-width ones
    where absent (the JAX ``init_state`` initialises them at random); the
    trunk frozen; Adam's moments at zero."""
    device = resolve_device(device)
    if text_state is None:
        text_state = damsm.random_rnn_state_dict(seed, cfg.ntoken, nhidden=cfg.embedding_dim // 2)
    if image_state is None:
        image_state = damsm.random_cnn_state_dict(seed, nef=cfg.embedding_dim)
    rnn = damsm.RNNEncoder.from_state_dict(text_state, device=device)
    cnn = damsm.CNNEncoder.from_state_dict(image_state, device=device)
    cnn.trunk.requires_grad_(False)

    def adam(params):
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.5, 0.999), eps=1e-8)

    return DamsmTrainState(0, rnn, cnn, adam(rnn.parameters()),
                           adam([*cnn.emb_features.parameters(), *cnn.emb_cnn_code.parameters()]))


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on the gradients of ``params``, in
    place: g / |g| x max_norm where the global norm |g| is not below
    max_norm.  -> |g| (0-d, on the device; no synchronisation)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def _damsm_losses(cfg, region, code, words_emb, sent_emb, cap_lens, class_ids):
    w0, w1, _ = losses.words_loss(region, words_emb, cap_lens, class_ids, cfg.weights)
    s0, s1 = losses.sent_loss(code, sent_emb, class_ids, cfg.weights)
    return w0 + w1, s0 + s1


def _inputs(state: DamsmTrainState, images, captions, cap_lens, class_ids):
    dev = state.device
    dtype = state.image_encoder.emb_cnn_code.weight.dtype
    x = normalize(upload(images, dev), "half").to(dtype)
    return x, upload(captions, dev, torch.int64), upload(cap_lens, dev, torch.int64), upload(class_ids, dev,
                                                                                              torch.int64)


def make_train_step(cfg: DamsmPretrainConfig, schedule: Optional[Callable[[int], float]] = None):
    """-> ``train_step(state, images, captions, cap_lens, class_ids)``: one
    step in place (uint8 NHWC images at the finest scale) -> the metrics
    (w_loss, s_loss, loss) as 0-d tensors on the device.  ``schedule`` maps
    the step count to the learning rate; ``cfg.lr`` throughout without it."""

    def train_step(state: DamsmTrainState, images, captions, cap_lens, class_ids) -> Dict[str, torch.Tensor]:
        x, caps, lens, cls = _inputs(state, images, captions, cap_lens, class_ids)
        words_emb, sent_emb = state.text_encoder.encode(caps, np.asarray(cap_lens))
        region, code = state.image_encoder.encode_heads(x)
        w_loss, s_loss = _damsm_losses(cfg, region, code, words_emb, sent_emb, lens, cls)
        loss = w_loss + s_loss
        state.rnn_opt.zero_grad(set_to_none=True)
        state.cnn_opt.zero_grad(set_to_none=True)
        loss.backward()
        clip_by_global_norm_(state.text_encoder.parameters(), cfg.rnn_grad_clip)
        lr = cfg.lr if schedule is None else schedule(state.step)
        for opt in (state.rnn_opt, state.cnn_opt):
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
        state.step += 1
        return {"w_loss": w_loss.detach(), "s_loss": s_loss.detach(), "loss": loss.detach()}

    return train_step


def make_eval_step(cfg: DamsmPretrainConfig):
    """Validation losses (pretrain_DAMSM.py evaluate(), :151-184): -> the
    word and sentence DAMSM losses of a batch, with no autograd."""

    @torch.no_grad()
    def eval_step(state: DamsmTrainState, images, captions, cap_lens, class_ids) -> Tuple[torch.Tensor, torch.Tensor]:
        x, caps, lens, cls = _inputs(state, images, captions, cap_lens, class_ids)
        words_emb, sent_emb = state.text_encoder(caps, np.asarray(cap_lens))
        region, code = state.image_encoder(x)
        return _damsm_losses(cfg, region, code, words_emb, sent_emb, lens, cls)

    return eval_step


def save_best_encoders(state: DamsmTrainState, output_dir: str) -> None:
    """``best_text_encoder.npz`` and ``best_image_encoder.npz`` in the JAX
    package's ``{"params": ...}`` layout."""
    text, image = state.encoder_state_dicts()
    save_pytree_npz(os.path.join(output_dir, "best_text_encoder.npz"), damsm.jax_params_from_rnn_state_dict(text))
    save_pytree_npz(os.path.join(output_dir, "best_image_encoder.npz"), damsm.jax_params_from_cnn_state_dict(image))


def train(cfg: DamsmPretrainConfig, dataset, output_dir: str, *, val_dataset=None, text_state=None,
          image_state=None, device=None, log_every: int = 50, num_workers: int = 8
          ) -> Tuple[DamsmTrainState, List[Dict]]:
    """Full pretraining (pretrain_DAMSM.py:316-421) through the trainers'
    epoch loop (``train_loop.run_epochs``: the resume from the newest
    snapshot, a snapshot every ``snapshot_interval`` epochs and at the last,
    the newest kept) with the 0.98 decay and its floor, logging every
    ``log_every`` batches (UPDATE_INTERVAL), and after each epoch the
    validation losses over the test split where it holds a batch and the
    best encoders by validation loss (the reference ranks by damsm + ALPHA_1
    comp, whose second term its losses.py lacks).  -> (the final state, one
    record an epoch run here: epoch, steps, seconds, data_wait_s, last
    metrics, and the validation losses where there were any)."""
    steps_per_epoch = max(1, len(dataset) // cfg.batch_size)
    state = init_state(cfg, text_state, image_state, device)
    step_fn = make_train_step(cfg, make_lr_schedule(cfg.lr, steps_per_epoch))
    eval_fn = make_eval_step(cfg)
    logger = make_logger(output_dir)
    best = float("inf")

    def run_step(batch) -> Dict[str, torch.Tensor]:
        return step_fn(state, batch.images[-1], batch.captions, batch.cap_lens, batch.class_ids)

    def log_line(epoch: int, step: int, m: Dict[str, float]) -> str:
        return ("| epoch %3d | %5d/%5d batches | s_loss %7.4f | w_loss %7.4f | damsm_loss %7.4f |"
                % (epoch, step, steps_per_epoch, m["s_loss"], m["w_loss"], m["loss"]))

    def validate(epoch: int, record: Dict) -> None:
        nonlocal best
        if val_dataset is None or len(val_dataset) < cfg.batch_size:
            return
        w_tot = s_tot = 0.0
        n = 0
        for batch in val_dataset.batches(cfg.batch_size, shuffle=False, num_workers=num_workers):
            w, s = eval_fn(state, batch.images[-1], batch.captions, batch.cap_lens, batch.class_ids)
            w_tot, s_tot, n = w_tot + float(w), s_tot + float(s), n + 1
        damsm_loss = (w_tot + s_tot) / n
        logger.info("| end epoch %3d | valid_s_loss %7.4f | valid_w_loss %7.4f | DAMSM_loss %7.4f |"
                    % (epoch, s_tot / n, w_tot / n, damsm_loss))
        record["valid"] = {"w_loss": w_tot / n, "s_loss": s_tot / n, "damsm_loss": damsm_loss, "batches": n}
        if damsm_loss < best:
            best = damsm_loss
            save_best_encoders(state, output_dir)
            logger.info("Save best image encoder and text encoder!")

    records = run_epochs(state, dataset, output_dir, run_step, log_line, batch_size=cfg.batch_size,
                         max_epoch=cfg.max_epoch, snapshot_interval=cfg.snapshot_interval, log_every=log_every,
                         num_workers=num_workers, end_epoch=validate)
    return state, records


def smoke_train(device=None) -> Dict[str, float]:
    """Two steps at the JAX smoke's small widths on seeded batches of 3
    (uint8 96 px images) -> the last metrics."""
    cfg = DamsmPretrainConfig(ntoken=60, embedding_dim=16, words_num=6)
    state = init_state(cfg, device=device)
    step = make_train_step(cfg)
    r = np.random.RandomState(0)
    batch_size = 3
    metrics: Dict[str, torch.Tensor] = {}
    for _ in range(2):
        images = r.randint(0, 256, (batch_size, 96, 96, 3)).astype(np.uint8)
        caps = r.randint(1, 60, (batch_size, cfg.words_num)).astype(np.int32)
        lens = r.randint(2, cfg.words_num + 1, (batch_size,)).astype(np.int32)
        metrics = step(state, images, caps, lens, np.arange(batch_size, dtype=np.int32))
    return {k: float(v) for k, v in metrics.items()}


def main(argv=None) -> Optional[list]:
    """The JAX CLI's flags (pretrain_DAMSM.py's parser, :35-47, with explicit
    config flags in place of the --cfg yml) plus ``--device``, the card by
    default.  -> the training records, one an epoch this run trained."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--smoke", action="store_true", help="2 steps on synthetic batches")
    p.add_argument("--data_dir", type=str, default="", help="dataset root (data/birds or data/coco)")
    p.add_argument("--output_dir", type=str, default="output/DAMSM")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--max_epoch", type=int, default=600)
    p.add_argument("--snapshot_interval", type=int, default=5)
    p.add_argument("--encoder_lr", type=float, default=2e-4)
    p.add_argument("--base_size", type=int, default=64)
    p.add_argument("--num_branch", type=int, default=3, help="finest scale = base_size * 2^(num_branch-1)")
    p.add_argument("--words_num", type=int, default=18)
    p.add_argument("--embedding_dim", type=int, default=256)
    p.add_argument("--caps_per_img", type=int, default=10)
    p.add_argument("--manual_seed", type=int, default=100)
    add_device_flag(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.smoke:
        print({k: round(v, 4) for k, v in smoke_train(device=device).items()})
        return None
    if not args.data_dir:
        p.error("--data_dir is required for full pretraining (or use --smoke)")
    from tise_tpu_torch.models import datasets as ds

    configure_precision("highest")  # TF32 off: the f32 step is the reference's
    np.random.seed(args.manual_seed)
    torch.manual_seed(args.manual_seed)

    def make(split: str, augment: bool):
        return ds.TextImageDataset(args.data_dir, split, base_size=args.base_size, branch_num=args.num_branch,
                                   words_num=args.words_num, captions_per_image=args.caps_per_img,
                                   seed=args.manual_seed, augment=augment)

    dataset = make("train", True)
    cfg = DamsmPretrainConfig(ntoken=dataset.n_words, embedding_dim=args.embedding_dim, lr=args.encoder_lr,
                              batch_size=args.batch_size, words_num=args.words_num, max_epoch=args.max_epoch,
                              snapshot_interval=args.snapshot_interval)
    _, records = train(cfg, dataset, args.output_dir, val_dataset=make("test", False), device=device)
    for r in records:
        valid = r.get("valid")
        print(f"epoch {r['epoch']}: {r['steps']} steps in {r['seconds']:.2f} s, {r['data_wait_s']:.2f} s waiting "
              f"for data; " + ", ".join(f"{k} {v:.4f}" for k, v in r["metrics"].items())
              + (f"; valid DAMSM_loss {valid['damsm_loss']:.4f}" if valid else ""))
    return records


if __name__ == "__main__":
    main()
