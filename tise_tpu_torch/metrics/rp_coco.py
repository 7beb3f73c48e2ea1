"""RP (COCO) — R-precision via CLIP ViT-B/32 (mirrors tise_tpu/metrics/rp_coco.py;
reference: text_relevance/RP_coco.py).

Per caption item: rank the ground-truth caption against its 99
``mismatched_captions`` by image-text logits; success iff the GT ranks first
(RP_coco.py:67-76).  Items are shuffled into 10 bins (the last takes the
remainder, :41-52); the score is mean +- std over the per-bin success rates
(:83-85).  The reference's shuffle is unseeded (:43); here it is seeded
(--seed), as in the JAX package.

Whole blocks of items run per step through ClipPairScorer: by default every
unique caption is encoded once into a bank on the device and each item
gathers its rows; ``--no-dedup-text`` re-encodes each item's captions as the
reference does.  Kernel K1 normalizes every image batch.
"""

from __future__ import annotations

import argparse
import os
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np

from tise_tpu_torch.backbones import clip_vit
from tise_tpu_torch.backbones.clip_tokenizer import SimpleTokenizer
from tise_tpu_torch.core import io as result_io
from tise_tpu_torch.core.config import (NUM_SPLITS, add_device_flag, add_distributed_flags, add_precision_flag,
                                        configure_precision, maybe_init_distributed, resolve_device)
from tise_tpu_torch.core.data import center_crop_resize
from tise_tpu_torch.metrics import extractor as ext
from tise_tpu_torch.metrics.clip_scorer import ClipPairScorer
from tise_tpu_torch.parallel import multihost

IMAGE_SIZE = 224


def make_bins(num_items: int, num_bins: int = NUM_SPLITS, seed: int = 0) -> List[List[int]]:
    """Shuffled ids split into bins; the last bin takes the remainder
    (RP_coco.py:41-52)."""
    ids = list(range(num_items))
    random.Random(seed).shuffle(ids)
    per_bin = num_items // num_bins
    bins = []
    for i in range(num_bins):
        if i == num_bins - 1 and num_items % num_bins != 0:
            bins.append(ids[i * per_bin:])
        else:
            bins.append(ids[i * per_bin:(i + 1) * per_bin])
    return bins


def score_items(
    items: Sequence[Dict],
    image_paths: Sequence[str],
    scorer: ClipPairScorer,
    tokenizer: SimpleTokenizer,
    *,
    batch_size: int = 64,
    num_workers: int = 8,
    dedup_text: bool = True,
    snapshot_path: str = "",
    snapshot_every: int = 0,
) -> np.ndarray:
    """-> bool success per item (GT caption ranked first among its captions).

    ``dedup_text`` (default): every UNIQUE caption string is tokenized and
    encoded once into a bank on the device; each item gathers its rows and
    dots them against its image embedding.  The same tokens give the same
    embedding and the logit is scale*<img,txt> either way, so this removes
    only the ~100x caption repetition the reference re-encodes per item
    (RP_coco.py:70-73).  The bank holds unique_captions x 512 f32 on the
    device; ``dedup_text=False`` re-encodes per item like the reference.

    One batch stays in flight: batch k+1 is decoded on the host and queued
    before batch k's logits are pulled.  ``snapshot_path``: successes are a
    prefix of the item order, so every ``snapshot_every`` items they are
    written with the cursor; a failed run re-raises and leaves the snapshot,
    and the same command resumes from it (bit-equal result).  (The JAX
    package also resets its TPU backend in process and retries; a CUDA
    context that faulted cannot be reset in process, so the port re-raises.)

    Across processes (``parallel.multihost``) the items shard and the
    successes allgather back into global item order.  Every process encodes
    the bank of EVERY item's captions, so each holds the whole bank, the
    same bits as one process's (the JAX CLI builds each process's bank from
    its shard, and its bank comes back sharded over a mesh of more than one
    device).  Snapshots are one process's.
    """
    if snapshot_path and multihost.is_distributed():
        raise NotImplementedError("RP snapshots are one process's; a multi-process run shards the items instead")
    n = len(items)
    sel, gidx = multihost.shard_items(list(range(n)))
    bank = rows = None
    if dedup_text:
        cap_id: Dict[str, int] = {}
        item_rows = [[cap_id.setdefault(c, len(cap_id)) for c in [it["caption"], *it["mismatched_captions"]]]
                     for it in items]
        uniq = list(cap_id)
        toks = np.concatenate(
            [tokenizer.tokenize(uniq[s:s + 2048]) for s in range(0, len(uniq), 2048)]
        ) if uniq else np.zeros((0, 77), np.int32)
        bank = scorer.encode_text_bank(toks)
        rows = np.asarray(item_rows, dtype=np.int32) if item_rows else np.zeros((0, 1), np.int32)

    fp = ""
    chunks: Dict[str, list] = {}
    cursor = 0
    snapshot_every = snapshot_every or max(batch_size * 16, 1024)
    if snapshot_path:
        fp = ext._snapshot_fingerprint([image_paths[i] for i in sel], IMAGE_SIZE, ("success",))
        chunks, cursor = ext._load_snapshot(snapshot_path, fp)
    since = 0
    inflight = None  # (scorer.dispatch_from_bank's handle, item count)

    def record(logits: np.ndarray, n_items: int) -> None:
        nonlocal cursor, since
        chunks.setdefault("success", []).append(np.argmax(logits, axis=1) == 0)
        cursor += n_items
        since += n_items

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for start in range(cursor, len(sel), batch_size):
            chunk = sel[start:start + batch_size]
            imgs = np.stack(list(pool.map(lambda i: center_crop_resize(image_paths[i], IMAGE_SIZE), chunk)))
            if dedup_text:
                handle = scorer.dispatch_from_bank(imgs, bank, rows[chunk])
                if inflight is not None:
                    record(scorer.pull_logits(inflight[0]), inflight[1])
                inflight = (handle, len(chunk))
            else:
                toks = np.stack([tokenizer.tokenize([items[i]["caption"], *items[i]["mismatched_captions"]])
                                 for i in chunk])
                record(scorer.logits(imgs, toks), len(chunk))
            if snapshot_path and since >= snapshot_every:
                if inflight is not None:  # flush: the cursor must be exact
                    record(scorer.pull_logits(inflight[0]), inflight[1])
                    inflight = None
                ext._save_snapshot(snapshot_path, fp, chunks, cursor)
                since = 0
        if inflight is not None:
            record(scorer.pull_logits(inflight[0]), inflight[1])
    if snapshot_path and os.path.exists(snapshot_path):
        os.remove(snapshot_path)
    local = np.concatenate(chunks["success"]).astype(bool) if chunks.get("success") else np.zeros(0, dtype=bool)
    return multihost.allgather_rows(local, gidx, n)


def compute_rp(
    rp_input: Sequence[Dict],
    image_dir: str,
    scorer: ClipPairScorer,
    tokenizer: SimpleTokenizer,
    *,
    num_bins: int = NUM_SPLITS,
    seed: int = 0,
    batch_size: int = 64,
    dedup_text: bool = True,
    snapshot_path: str = "",
) -> Tuple[float, float, List[float]]:
    paths = [os.path.join(image_dir, f"{item['caption_id']}.png") for item in rp_input]
    success = score_items(rp_input, paths, scorer, tokenizer, batch_size=batch_size, dedup_text=dedup_text,
                          snapshot_path=snapshot_path)
    bins = make_bins(len(rp_input), num_bins, seed)
    bin_scores = [float(np.mean(success[b])) for b in bins]
    return float(np.mean(bin_scores)), float(np.std(bin_scores)), bin_scores


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Calculating R-precision")
    p.add_argument("--image_dir", default="", type=str)
    p.add_argument("--rp_input_file", default="captions/COCO_RP_captions.pkl", type=str)
    p.add_argument("--saved_file_path", default=None, type=str)
    p.add_argument("--gpu_id", default="0", type=str, help="accepted for the reference's command lines; ignored")
    p.add_argument("--weights", type=str, required=True, help="CLIP ViT-B/32 weights (.pt/.npz)")
    p.add_argument("--bpe_path", type=str, required=True, help="CLIP BPE vocab (bpe_simple_vocab_16e6.txt.gz)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--no-dedup-text",
        action="store_true",
        help="re-encode the 100 captions per item like the reference instead "
        "of the unique-caption embedding bank (exact either way; see score_items)",
    )
    p.add_argument("--snapshot_file", type=str, default="",
                   help="make the item loop resumable: periodic successes+"
                        "cursor snapshot at this path (bit-equal result)")
    add_precision_flag(p)
    add_device_flag(p)
    add_distributed_flags(p)
    args = p.parse_args(argv)
    configure_precision(args.precision)
    maybe_init_distributed(args)
    device = resolve_device(args.device)

    rp_input = result_io.load_pickle(args.rp_input_file)
    scorer = ClipPairScorer(clip_vit.load_params(args.weights), device, fast=args.precision == "fast")
    tokenizer = SimpleTokenizer(args.bpe_path)
    mean, std, bin_scores = compute_rp(
        rp_input,
        args.image_dir,
        scorer,
        tokenizer,
        seed=args.seed,
        batch_size=args.batch_size,
        dedup_text=not args.no_dedup_text,
        snapshot_path=args.snapshot_file,
    )
    for i, s in enumerate(bin_scores):
        print(f"Bin: {i}, RP: {s}")
    if args.saved_file_path is not None:
        result_io.write_rp_coco_result(args.saved_file_path, mean, std)
    print(f"R-precision: {mean} +- {std}")


if __name__ == "__main__":
    main()
