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

``train(..., module=...)`` runs the CounterModel's trainer through the same
loop, and DAMSM pretraining runs its epochs through the same ``run_epochs``
(its snapshots have no ``.npz``: its state has no generator).  The noise of step n is
``models/generate.py::draw_noise(NOISE_SEED, n)`` on the device (the JAX
loop folds the step into ``PRNGKey(1)``).  Each epoch's log line carries
its seconds and the seconds the loop waited for data, and ``train``
returns them as records beside the state.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from tise_tpu_torch.models import weights as m_weights
from tise_tpu_torch.models.attngan_pp import trainer as T
from tise_tpu_torch.models.generate import draw_noise

NOISE_SEED = 1


class CheckpointManager:
    """``torch.save`` snapshots of a state's ``state_dict()`` with the
    reference's policy: only the newest is kept.  Where the state has an EMA
    generator (``ema_generator_state``), it goes beside each snapshot as
    ``epoch_<n>.npz``."""

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

    def save(self, state, epoch: int) -> None:
        tmp = self.path(epoch, ".pt.tmp")
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, self.path(epoch))  # a snapshot is whole or absent
        if hasattr(state, "ema_generator_state"):
            m_weights.save_generator_npz(self.path(epoch, ".npz"), state.ema_generator_state())
        for e in self.epochs()[:-1]:
            for suffix in (".pt", ".npz"):
                if os.path.exists(self.path(e, suffix)):
                    os.remove(self.path(e, suffix))

    def restore(self, state) -> int:
        """Load the newest snapshot into ``state``; -> its epoch, 0 where
        there is none."""
        epochs = self.epochs()
        if not epochs:
            return 0
        epoch = epochs[-1]
        state.load_state_dict(torch.load(self.path(epoch), map_location=state.device, weights_only=False))
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


def run_epochs(state, dataset, output_dir: str, run_step: Callable[[Any], Dict[str, torch.Tensor]],
               log_line: Callable[[int, int, Dict[str, float]], str], *, batch_size: int, max_epoch: int,
               snapshot_interval: int, log_every: int, num_workers: int,
               end_epoch: Optional[Callable[[int, Dict], None]] = None) -> List[Dict]:
    """The epoch loop of every trainer: resume ``state`` from the newest
    snapshot under ``output_dir/checkpoints``; then an epoch is the steps
    over ``dataset.batches(batch_size)`` (``run_step(batch)`` -> the
    metrics) with the host's wait for each batch timed, ``log_line(epoch,
    step, metrics)`` logged and the metrics written to ``scalars.jsonl``
    every ``log_every`` steps, a sync, the epoch's record (epoch, steps,
    seconds, data_wait_s, last metrics), ``end_epoch(epoch, record)`` where
    given (pretraining's validation), and a snapshot every
    ``snapshot_interval`` epochs and at the last.  -> one record an epoch
    run here."""
    ckpt = CheckpointManager(os.path.join(output_dir, "checkpoints"))
    logger = make_logger(output_dir)
    scalars = ScalarWriter(output_dir)
    start_epoch = ckpt.restore(state) + 1
    if start_epoch > 1:
        logger.info(f"resumed from epoch {start_epoch - 1}")
    records = []
    for epoch in range(start_epoch, max_epoch + 1):
        t0 = time.perf_counter()
        wait = 0.0
        steps = 0
        metrics: Dict[str, torch.Tensor] = {}
        batches = iter(dataset.batches(batch_size, num_workers=num_workers))
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            wait += time.perf_counter() - t_wait
            if batch is None:
                break
            metrics = run_step(batch)
            steps += 1
            if steps % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                logger.info(log_line(epoch, steps, m))
                scalars.write(state.step, m)
        if state.device.type == "cuda":
            torch.cuda.synchronize(state.device)
        seconds = time.perf_counter() - t0
        logger.info(f"epoch {epoch} done in {seconds:.1f}s ({steps} steps, {wait:.2f}s waiting for data)")
        record = {"epoch": epoch, "steps": steps, "seconds": seconds, "data_wait_s": wait,
                  "metrics": {k: float(v) for k, v in metrics.items()}}
        if end_epoch is not None:
            end_epoch(epoch, record)
        if epoch % snapshot_interval == 0 or epoch == max_epoch:
            ckpt.save(state, epoch)
            logger.info(f"saved snapshot at epoch {epoch}")
        records.append(record)
    return records


def train(cfg: T.TrainConfig, dataset, output_dir: str, *, text_state=None, image_state=None, device=None,
          log_every: int = 100, num_workers: int = 8, module=None) -> Tuple[Any, List[Dict]]:
    """Epochs over ``dataset.batches(cfg.batch_size)`` with snapshots,
    resume from the newest one and logging (``run_epochs``) -> (the final
    state, one record an epoch run here: epoch, steps, seconds, data_wait_s,
    last metrics).

    ``module`` selects the trainer: any module with ``build_models``,
    ``init_state`` and ``make_train_step`` over the shared ``Batch``; the
    AttnGAN++ trainer by default, ``models.counter_model.trainer`` plugs in
    as it is (the JAX loop's ``module``)."""
    M = T if module is None else module
    models = M.build_models(cfg, text_state, image_state, device)
    state = M.init_state(cfg, models, seed=0)
    step_fn = M.make_train_step(cfg, models)
    gan = cfg.gan

    def run_step(batch):
        z, eps = draw_noise(NOISE_SEED, state.step, len(batch.cap_lens), gan.z_dim, gan.condition_dim, state.device)
        return step_fn(state, batch, z, eps)

    def log_line(epoch: int, step: int, m: Dict[str, float]) -> str:
        return ("epoch %d iter %d D_loss: %.4f G_loss: %.4f w: %.4f s: %.4f kl: %.4f"
                % (epoch, step, m["d_loss"], m["g_loss"], m["w_loss"], m["s_loss"], m["kl_loss"]))

    records = run_epochs(state, dataset, output_dir, run_step, log_line, batch_size=cfg.batch_size,
                         max_epoch=cfg.max_epoch, snapshot_interval=cfg.snapshot_interval, log_every=log_every,
                         num_workers=num_workers)
    return state, records
