"""PA — Positional Alignment (mirrors tise_tpu/metrics/pa.py; reference:
positional_alignment/PA.py).

Input pickle: {positional_word: [ {caption, false_caption, caption_id}, ... ]}
(README.md:140-154).  Per item, CLIP scores the caption against the
``false_caption`` (the same sentence with the positional word swapped); the
item succeeds iff P(gt) > 0.6 after a 2-way softmax (PA.py:33-43).  PA is the
unweighted mean of the per-phrase success rates (:67).

Images live at ``<image_dir>/<phrase>/<caption_id>.png`` (:56-60).  Items
are scored in [B, 2]-caption blocks per step through ClipPairScorer; kernel
K1 normalizes every image batch.
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence, Tuple

import numpy as np

from tise_tpu_torch.backbones import clip_vit
from tise_tpu_torch.backbones.clip_tokenizer import SimpleTokenizer
from tise_tpu_torch.core import io as result_io
from tise_tpu_torch.core.config import (PA_SUCCESS_THRESHOLD, add_device_flag, add_precision_flag,
                                        configure_precision, resolve_device)
from tise_tpu_torch.core.data import center_crop_resize
from tise_tpu_torch.metrics import extractor as ext
from tise_tpu_torch.metrics.clip_scorer import ClipPairScorer

IMAGE_SIZE = 224


def _softmax2_first(logits: np.ndarray) -> np.ndarray:
    """P(gt) of the 2-way softmax: [B, 2] -> [B]."""
    m = logits.max(axis=1, keepdims=True)
    e = np.exp(logits - m)
    return e[:, 0] / e.sum(axis=1)


def score_phrase(
    items: Sequence[Dict],
    phrase_dir: str,
    scorer: ClipPairScorer,
    tokenizer: SimpleTokenizer,
    *,
    batch_size: int = 64,
    threshold: float = PA_SUCCESS_THRESHOLD,
    num_workers: int = 8,
) -> Tuple[float, int]:
    """-> (success rate, total) for one positional-word folder."""
    n = len(items)
    success = np.zeros(n, dtype=bool)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for start in range(0, n, batch_size):
            chunk = items[start:start + batch_size]
            imgs = list(pool.map(
                lambda it: center_crop_resize(os.path.join(phrase_dir, f"{it['caption_id']}.png"), IMAGE_SIZE),
                chunk))
            toks = [tokenizer.tokenize([it["caption"], it["false_caption"]]) for it in chunk]
            logits = scorer.logits(np.stack(imgs), np.stack(toks))
            success[start:start + len(chunk)] = _softmax2_first(logits) > threshold
    return float(np.sum(success)) / n if n else 0.0, n


def _load_phrase_snapshot(path: str, fingerprint: str) -> Dict[str, Dict]:
    """-> completed {phrase: {success, total, score}} or {} when absent/stale."""
    if not os.path.exists(path):
        return {}
    try:
        with np.load(path, allow_pickle=False) as z:
            if str(z["fingerprint"]) != fingerprint:
                return {}
            return {
                str(nm): {
                    "success": float(z["success"][i]),
                    "total": float(z["total"][i]),
                    "score": float(z["score"][i]),
                }
                for i, nm in enumerate(z["phrases"])
            }
    except Exception:  # noqa: BLE001 — torn/corrupt snapshot: start over
        return {}


def _save_phrase_snapshot(path: str, fingerprint: str, phrase_res: Dict[str, Dict]) -> None:
    names = list(phrase_res)
    tmp = path + ".tmp.npz"  # np.savez appends .npz to bare names
    np.savez(
        tmp,
        fingerprint=fingerprint,
        phrases=np.asarray(names),
        success=np.asarray([phrase_res[n]["success"] for n in names]),
        total=np.asarray([phrase_res[n]["total"] for n in names]),
        score=np.asarray([phrase_res[n]["score"] for n in names]),
    )
    os.replace(tmp, path)  # atomic: a kill mid-write never leaves a torn file


def compute_pa(
    data: Dict[str, Sequence[Dict]],
    image_dir: str,
    scorer: ClipPairScorer,
    tokenizer: SimpleTokenizer,
    *,
    batch_size: int = 64,
    threshold: float = PA_SUCCESS_THRESHOLD,
    snapshot_path: str = "",
) -> Tuple[float, Dict[str, Dict]]:
    """PA over every phrase.  ``snapshot_path`` makes the run resumable at
    phrase granularity: each completed phrase's result is written there; a
    failed run re-raises and leaves the snapshot, and the same command skips
    the completed phrases (bit-equal result).  (The JAX package also resets
    its TPU backend in process and re-runs the phrase; a CUDA context that
    faulted cannot be reset in process, so the port re-raises.)"""
    phrase_res: Dict[str, Dict] = {}
    fp = ""
    if snapshot_path:
        fp = ext._snapshot_fingerprint([f"{p}:{len(items)}" for p, items in data.items()], IMAGE_SIZE, ("pa",))
        phrase_res = _load_phrase_snapshot(snapshot_path, fp)
        if phrase_res:
            print(f"[pa] resuming: {len(phrase_res)}/{len(data)} phrases from snapshot", flush=True)
    for phrase, items in data.items():
        if phrase in phrase_res:
            continue
        score, total = score_phrase(items, os.path.join(image_dir, phrase), scorer, tokenizer,
                                    batch_size=batch_size, threshold=threshold)
        phrase_res[phrase] = {"success": score * total, "total": float(total), "score": score}
        print(phrase, phrase_res[phrase])
        if snapshot_path:
            _save_phrase_snapshot(snapshot_path, fp, phrase_res)
    if snapshot_path and os.path.exists(snapshot_path):
        os.remove(snapshot_path)
    pa = float(np.mean([phrase_res[p]["score"] for p in phrase_res]))
    return pa, phrase_res


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Calculating positional alignment")
    p.add_argument("--image_dir", default="", type=str)
    p.add_argument("--pa_input_file", default="captions/PA_input_captions.pkl", type=str)
    p.add_argument("--saved_file_path", default=None, type=str)
    p.add_argument("--gpu_id", default="0", type=str, help="accepted for the reference's command lines; ignored")
    p.add_argument("--weights", type=str, required=True, help="CLIP ViT-B/32 weights (.pt/.npz)")
    p.add_argument("--bpe_path", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--snapshot_file", type=str, default="",
                   help="make the phrase loop resumable: completed-phrase "
                        "snapshot at this path (bit-equal result)")
    add_precision_flag(p)
    add_device_flag(p)
    args = p.parse_args(argv)
    configure_precision(args.precision)
    device = resolve_device(args.device)

    data = result_io.load_pickle(args.pa_input_file)
    scorer = ClipPairScorer(clip_vit.load_params(args.weights), device, fast=args.precision == "fast")
    tokenizer = SimpleTokenizer(args.bpe_path)
    pa, _ = compute_pa(data, args.image_dir, scorer, tokenizer, batch_size=args.batch_size,
                       snapshot_path=args.snapshot_file)
    if args.saved_file_path is not None:
        result_io.write_pa_result(args.saved_file_path, pa)
    print(f"PA = {pa}")


if __name__ == "__main__":
    main()
