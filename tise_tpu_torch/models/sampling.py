"""Trainer-side evaluation sampling (mirrors tise_tpu/models/sampling.py;
reference: AttnGAN++/trainer.py ``sampling()``, :514-641).

  * ``sample_test_split``: one image for every item of a dataset split with
    a generator (``models/generate.py::CaptionGenerator``, the EMA weights
    a snapshot wrote), named by item index;
  * ``train_time_r_precision`` (:608-641): each generated image ranks its
    caption against 99 mismatched captions drawn from the dataset
    (datasets.py:300-319) with the frozen DAMSM encoders
    (``metrics/rp_cub.py::DamsmScorer``), the model-selection signal of
    training.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from tise_tpu_torch.core.data import load_image
from tise_tpu_torch.metrics.rp_cub import DamsmScorer, pack_caption_sets
from tise_tpu_torch.models import generate as gen_lib
from tise_tpu_torch.models.datasets import TextImageDataset


def sample_test_split(dataset: TextImageDataset, gen: gen_lib.CaptionGenerator, out_dir: str, *,
                      batch_size: int = 32) -> int:
    """Generate ``<index>.png`` for every item of ``dataset`` (the reference
    names by caption id; items carry file names, so the index is the id)."""
    items = []
    for idx in range(len(dataset)):
        caps, length = dataset.sample_caption(idx)
        toks = [dataset.ixtoword.get(int(t), "") for t in caps[:length]]
        items.append({"caption_id": idx, "caption": " ".join(toks)})
    return gen_lib.generate_flat(items, out_dir, gen, dataset.wordtoix, batch_size=batch_size,
                                 words_num=dataset.words_num)


def train_time_r_precision(dataset: TextImageDataset, image_dir: str, scorer: DamsmScorer, *, batch_size: int = 16,
                           max_items: Optional[int] = None, max_len: int = 32) -> float:
    """R-precision of the generated test images, each against its caption
    and 99 mismatched ones (trainer.py:608-641, datasets.py:300-319)."""
    n = len(dataset) if max_items is None else min(max_items, len(dataset))
    successes = np.zeros(n, dtype=np.float64)
    for start in range(0, n, batch_size):
        idxs = list(range(start, min(start + batch_size, n)))
        imgs, cap_sets = [], []
        for idx in idxs:
            imgs.append(load_image(os.path.join(image_dir, f"{idx}.png"), (256, 256)))
            gt_caps, gt_len = dataset.sample_caption(idx)
            mis_caps, mis_lens = dataset.get_mis_captions(int(dataset.class_id[idx]))
            cap_sets.append([list(gt_caps[:gt_len])] + [list(mis_caps[j, :mis_lens[j]]) for j in range(len(mis_caps))])
        caps, lens = pack_caption_sets(cap_sets, max_len)
        scores = scorer.pull(scorer.dispatch(np.stack(imgs), caps, lens))
        successes[idxs] = (np.argmax(scores, axis=1) == 0).astype(np.float64)
    return float(np.mean(successes))
