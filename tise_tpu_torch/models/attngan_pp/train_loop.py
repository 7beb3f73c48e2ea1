"""Host-side training loop: snapshots, resume, logging (mirrors
tise_tpu/models/attngan_pp/train_loop.py; reference: AttnGAN++/trainer.py).

  * the epoch loop with the reference's logging every ``log_every`` steps
    into ``train_history.log`` and ``scalars.jsonl`` (the JAX keys);
  * a snapshot every SNAPSHOT_INTERVAL epochs and at the last one, keeping
    only the newest (trainer.py:174-208): ``checkpoints/epoch_<n>.pt``, a
    ``torch.save`` of the whole trainer state (the JAX package writes Orbax,
    a JAX format), and beside it ``checkpoints/epoch_<n>.npz``, the EMA
    generator in the JAX package's ``.npz`` layout, which the generate CLIs
    read (``--checkpoint``);
  * a resume from the newest snapshot, optimiser state included (:113-115,
    :143-148).

The noise of step n is ``models/generate.py::draw_noise(NOISE_SEED, n)`` on
the device (the JAX loop folds the step into ``PRNGKey(1)``).  Each epoch's
log line carries its seconds and the seconds the loop waited for data, and
``train`` returns them as records beside the state.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Tuple

import torch

from tise_tpu_torch.models import weights as m_weights
from tise_tpu_torch.models.attngan_pp import trainer as T
from tise_tpu_torch.models.generate import draw_noise

NOISE_SEED = 1


class CheckpointManager:
    """``torch.save`` snapshots with the reference's policy: only the newest
    is kept."""

    def __init__(self, model_dir: str):
        self.model_dir = os.path.abspath(model_dir)
        os.makedirs(self.model_dir, exist_ok=True)

    def path(self, epoch: int, suffix: str = ".pt") -> str:
        return os.path.join(self.model_dir, f"epoch_{epoch}{suffix}")

    def epochs(self) -> List[int]:
        out = []
        for name in os.listdir(self.model_dir):
            stem, ext = os.path.splitext(name)
            if ext == ".pt" and stem.startswith("epoch_") and stem[6:].isdigit():
                out.append(int(stem[6:]))
        return sorted(out)

    def save(self, state: T.TrainState, epoch: int) -> None:
        tmp = self.path(epoch, ".pt.tmp")
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, self.path(epoch))  # a snapshot is whole or absent
        m_weights.save_generator_npz(self.path(epoch, ".npz"), state.ema_generator_state())
        for e in self.epochs()[:-1]:
            for suffix in (".pt", ".npz"):
                if os.path.exists(self.path(e, suffix)):
                    os.remove(self.path(e, suffix))

    def restore(self, state: T.TrainState) -> int:
        """Load the newest snapshot into ``state``; -> its epoch, 0 where
        there is none."""
        epochs = self.epochs()
        if not epochs:
            return 0
        epoch = epochs[-1]
        device = next(state.gnet.parameters()).device
        state.load_state_dict(torch.load(self.path(epoch), map_location=device, weights_only=False))
        return epoch


def make_logger(output_dir: str) -> logging.Logger:
    """The train_history.log file logger (main.py:114-123)."""
    os.makedirs(output_dir, exist_ok=True)
    logger = logging.getLogger(f"tise_tpu_torch.train.{os.path.abspath(output_dir)}")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fh = logging.FileHandler(os.path.join(output_dir, "train_history.log"))
        fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logger.addHandler(fh)
    return logger


class ScalarWriter:
    """JSONL scalars (the reference's TensorBoard scalars, trainer.py:381-385)."""

    def __init__(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "scalars.jsonl")

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, **{k: float(v) for k, v in scalars.items()}}) + "\n")


def train(cfg: T.TrainConfig, dataset, output_dir: str, *, text_state=None, image_state=None, device=None,
          log_every: int = 100, num_workers: int = 8) -> Tuple[T.TrainState, List[Dict]]:
    """Epochs over ``dataset.batches(cfg.batch_size)`` with snapshots,
    resume from the newest one and logging -> (the final state, one record
    an epoch run here: epoch, steps, seconds, data_wait_s, last metrics)."""
    models = T.build_models(cfg, text_state, image_state, device)
    state = T.init_state(cfg, models, seed=0)
    step_fn = T.make_train_step(cfg, models)
    dev = next(models.gnet.parameters()).device
    ckpt = CheckpointManager(os.path.join(output_dir, "checkpoints"))
    logger = make_logger(output_dir)
    scalars = ScalarWriter(output_dir)

    start_epoch = ckpt.restore(state) + 1
    if start_epoch > 1:
        logger.info(f"resumed from epoch {start_epoch - 1}")
    gan = cfg.gan
    records = []
    for epoch in range(start_epoch, cfg.max_epoch + 1):
        t0 = time.perf_counter()
        wait = 0.0
        steps = 0
        metrics: Dict[str, torch.Tensor] = {}
        batches = iter(dataset.batches(cfg.batch_size, num_workers=num_workers))
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            wait += time.perf_counter() - t_wait
            if batch is None:
                break
            z, eps = draw_noise(NOISE_SEED, state.step, len(batch.cap_lens), gan.z_dim, gan.condition_dim, dev)
            metrics = step_fn(state, batch, z, eps)
            steps += 1
            if steps % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                logger.info("epoch %d iter %d D_loss: %.4f G_loss: %.4f w: %.4f s: %.4f kl: %.4f"
                            % (epoch, steps, m["d_loss"], m["g_loss"], m["w_loss"], m["s_loss"], m["kl_loss"]))
                scalars.write(state.step, m)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        logger.info(f"epoch {epoch} done in {seconds:.1f}s ({steps} steps, {wait:.2f}s waiting for data)")
        records.append({"epoch": epoch, "steps": steps, "seconds": seconds, "data_wait_s": wait,
                        "metrics": {k: float(v) for k, v in metrics.items()}})
        if epoch % cfg.snapshot_interval == 0 or epoch == cfg.max_epoch:
            ckpt.save(state, epoch)
            logger.info(f"saved snapshot at epoch {epoch}")
    return state, records
