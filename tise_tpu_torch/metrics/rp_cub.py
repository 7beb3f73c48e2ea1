"""RP (CUB) — R-precision via the DAMSM encoders (mirrors tise_tpu/metrics/rp_cub.py;
reference: text_relevance/RP_cub.py).

Per item: the cosine between the image's ``cnn_code`` and the ``sent_emb``
of its caption and of its 99 mismatched captions; success iff the caption
scores highest (RP_cub.py:99-132).  Captions tokenize with a ``\\w+`` regex,
lowercase, ascii-filtered, through the captions.pickle vocabulary (:58-96).
Images: PIL resize to 256 x 256, then Normalize(0.5, 0.5) (:135-137), which
kernel K1 computes on the card under the ``half`` recipe.

Scoring quirk kept under ``--legacy-compat``: the reference shuffles the
per-item successes and averages the slices ``[i*3000 : (i+1)*3000 - 1]``, an
off-by-one that drops the last item of each bin (:153-156; PARITY.md #11).
The default mode uses 10 equal bins.

Items run in blocks of ``batch_size``: one image forward and one LSTM pass
over the block's B x 100 captions a step (the reference runs one image and
two text forwards per item), with one block in flight while the host decodes
and tokenizes the next.
"""

from __future__ import annotations

import argparse
import os
import pickle
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from tise_tpu_torch.backbones import damsm
from tise_tpu_torch.core import io as result_io
from tise_tpu_torch.core.config import (NUM_SPLITS, add_device_flag, add_distributed_flags, add_precision_flag,
                                        configure_precision, maybe_init_distributed, resolve_device, tf32_forward)
from tise_tpu_torch.core.data import load_image
from tise_tpu_torch.metrics import extractor as ext
from tise_tpu_torch.ops.preprocess import normalize
from tise_tpu_torch.parallel import multihost

IMAGE_SIZE = 256
MAX_LEN = 32  # tokens kept of a caption
_WORD_RE = re.compile(r"\w+")


def tokenize_caption(sent: str, wordtoix: Dict[str, int]) -> List[int]:
    """Reference tokenization: \\w+ regex, lower, ascii filter, vocabulary
    lookup (RP_cub.py:58-75)."""
    sent = sent.replace("��", " ")
    ids = []
    for tok in _WORD_RE.findall(sent.lower()):
        tok = tok.encode("ascii", "ignore").decode("ascii")
        if tok and tok in wordtoix:
            ids.append(wordtoix[tok])
    return ids


def load_vocab(captions_pickle: str) -> Tuple[Dict[int, str], Dict[str, int]]:
    """captions.pickle entries 2 and 3 are (ixtoword, wordtoix) (RP_cub.py:33-37)."""
    with open(captions_pickle, "rb") as f:
        x = pickle.load(f, encoding="latin1")
    return x[2], x[3]


def pack_caption_sets(caption_sets: Sequence[Sequence[List[int]]], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """[[ids...] x K] x B -> (captions int32 [B, K, max_len], lengths int32
    [B, K]); an empty caption is token 0 with length 1."""
    b = len(caption_sets)
    k = len(caption_sets[0])
    caps = np.zeros((b, k, max_len), dtype=np.int32)
    lens = np.ones((b, k), dtype=np.int32)
    for i, cap_set in enumerate(caption_sets):
        for j, ids in enumerate(cap_set):
            ids = ids[:max_len]
            if ids:
                caps[i, j, :len(ids)] = ids
                lens[i, j] = len(ids)
    return caps, lens


def legacy_bins(successes: np.ndarray, seed: int = 0) -> np.ndarray:
    """The reference's binning, its off-by-one slice included (RP_cub.py:153-156)."""
    scores = np.array(successes, dtype=np.float64)
    np.random.RandomState(seed).shuffle(scores)
    bins = np.zeros(10)
    for i in range(10):
        bins[i] = np.average(scores[i * 3000:(i + 1) * 3000 - 1])
    return bins


def equal_bins(successes: np.ndarray, num_bins: int = NUM_SPLITS, seed: int = 0) -> np.ndarray:
    scores = np.array(successes, dtype=np.float64)
    np.random.RandomState(seed).shuffle(scores)
    return np.array([np.mean(part) for part in np.array_split(scores, num_bins)])


class DamsmScorer:
    """(uint8 image block, caption-set block) -> cosine scores on one device."""

    def __init__(self, rnn_state: Dict[str, Any], cnn_state: Dict[str, Any], device=None, *, fast: bool = False):
        """``rnn_state``/``cnn_state``: reference-layout state dicts
        (damsm.load_rnn_state_dict, load_cnn_state_dict).  ``fast=True``
        allows TF32 inside the forward only (``tf32_forward``), the card's
        counterpart of the JAX package's reduced-pass f32 under ``fast``."""
        self.device = resolve_device(device)
        self.fast = fast
        self.rnn = damsm.RNNEncoder.from_state_dict(rnn_state, device=self.device)
        self.cnn = damsm.CNNEncoder.from_state_dict(cnn_state, device=self.device)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return x.pin_memory().to(self.device, non_blocking=True)
        return x.to(self.device)

    def image_codes(self, images_u8: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC [B, 256, 256, 3] on the device -> cnn_code [B, nef]."""
        return self.cnn(normalize(images_u8, "half"))[1]

    def sentence_codes(self, captions: torch.Tensor, lengths: np.ndarray) -> torch.Tensor:
        """int [N, T] on the device and host lengths [N] -> sent_emb [N, 2H]."""
        return self.rnn(captions, lengths)[1]

    def dispatch(self, images_u8: np.ndarray, captions: np.ndarray, lengths: np.ndarray):
        """Upload a block, queue its forward and a copy of the [B, K] scores
        into pinned host memory, and return (host tensor, event) without
        synchronising, so the host prepares the next block meanwhile."""
        b, k, t = captions.shape
        with torch.inference_mode(), tf32_forward(self.fast):
            code = self.image_codes(self._upload(images_u8))
            sent = self.sentence_codes(self._upload(captions.reshape(b * k, t)), lengths.reshape(b * k)).view(b, k, -1)
            # the cosine with the reference's clamp of the norms' product (RP_cub.py:123-127)
            num = torch.einsum("bd,bkd->bk", code, sent)
            denom = torch.linalg.vector_norm(code, dim=-1, keepdim=True) * torch.linalg.vector_norm(sent, dim=-1)
            scores = num / denom.clamp_min(1e-8)
            if self.device.type != "cuda":
                return scores, None
            host = torch.empty(scores.shape, dtype=scores.dtype, pin_memory=True)
            host.copy_(scores, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return host, done

    @staticmethod
    def pull(inflight) -> np.ndarray:
        """Blocking half: wait for the copy, -> [B, K] float32 numpy."""
        host, done = inflight
        if done is not None:
            done.synchronize()
        return host.numpy()


def score_items(
    rp_input: Sequence[Dict],
    image_dir: str,
    scorer: DamsmScorer,
    wordtoix: Dict[str, int],
    *,
    batch_size: int = 32,
    snapshot_path: str = "",
    snapshot_every: int = 0,
) -> np.ndarray:
    """-> float64 success per item (its caption scores highest; ties go to
    the first index, as ``np.argmax``'s do).

    One block stays in flight: block k+1 is decoded (8 threads), tokenized and queued
    before block k's scores are pulled.  Each caption string is tokenized
    once (the reference tokenizes it again wherever it recurs).
    ``snapshot_path``: the successes are a prefix of the item order, so
    every ``snapshot_every`` items they are written with the cursor; a
    failed run re-raises and leaves the snapshot, and the same command
    resumes from it (bit-equal result).  (The JAX package also resets its TPU
    backend in process and retries; a CUDA context that faulted cannot be
    reset in process, so the port re-raises.)  Across processes the items
    shard and the successes allgather back into global item order
    (``parallel.multihost``); snapshots are one process's.
    """
    if snapshot_path and multihost.is_distributed():
        raise NotImplementedError("RP-CUB snapshots are one process's; a multi-process run shards the items "
                                  "instead")
    n = len(rp_input)
    sel, gidx = multihost.shard_items(list(range(n)))
    fp = ""
    chunks: Dict[str, list] = {}
    cursor = 0
    snapshot_every = snapshot_every or max(batch_size * 8, 256)
    if snapshot_path:
        fp = ext._snapshot_fingerprint([str(rp_input[i]["caption_id"]) for i in sel], IMAGE_SIZE, ("rp_cub",))
        chunks, cursor = ext._load_snapshot(snapshot_path, fp)
    token_ids: Dict[str, List[int]] = {}

    def tokens(caption: str) -> List[int]:
        if caption not in token_ids:
            token_ids[caption] = tokenize_caption(caption, wordtoix)
        return token_ids[caption]

    def load(i: int) -> np.ndarray:
        return load_image(os.path.join(image_dir, f"{rp_input[i]['caption_id']}.png"), (IMAGE_SIZE, IMAGE_SIZE))

    since = 0
    inflight = None  # (scorer.dispatch's handle, item count)

    def record(scores: np.ndarray, n_items: int) -> None:
        nonlocal cursor, since
        chunks.setdefault("success", []).append((np.argmax(scores, axis=1) == 0).astype(np.float64))
        cursor += n_items
        since += n_items

    with ThreadPoolExecutor(max_workers=8) as pool:
        for start in range(cursor, len(sel), batch_size):
            chunk = sel[start:start + batch_size]
            imgs = np.stack(list(pool.map(load, chunk)))
            caps, lens = pack_caption_sets(
                [[tokens(rp_input[i]["caption"])] + [tokens(c) for c in rp_input[i]["mismatched_captions"]]
                 for i in chunk], MAX_LEN)
            handle = scorer.dispatch(imgs, caps, lens)
            if inflight is not None:
                record(scorer.pull(inflight[0]), inflight[1])
            inflight = (handle, len(chunk))
            if snapshot_path and since >= snapshot_every:
                record(scorer.pull(inflight[0]), inflight[1])  # flush: the cursor must be exact
                inflight = None
                ext._save_snapshot(snapshot_path, fp, chunks, cursor)
                since = 0
        if inflight is not None:
            record(scorer.pull(inflight[0]), inflight[1])
    if snapshot_path and os.path.exists(snapshot_path):
        os.remove(snapshot_path)
    local = np.concatenate(chunks["success"]) if chunks.get("success") else np.zeros(0, np.float64)
    return multihost.allgather_rows(local, gidx, n)


def compute_rp_cub(
    rp_input: Sequence[Dict],
    image_dir: str,
    scorer: DamsmScorer,
    wordtoix: Dict[str, int],
    *,
    batch_size: int = 32,
    legacy_compat: bool = False,
    seed: int = 0,
    snapshot_path: str = "",
) -> Tuple[float, float, np.ndarray]:
    """-> (mean, std) over the bins, and the per-item successes."""
    successes = score_items(rp_input, image_dir, scorer, wordtoix, batch_size=batch_size,
                            snapshot_path=snapshot_path)
    bins = legacy_bins(successes, seed) if legacy_compat else equal_bins(successes, seed=seed)
    return float(np.average(bins)), float(np.std(bins)), successes


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Calculating R-precision")
    p.add_argument("--image_dir", default="", type=str)
    p.add_argument("--rp_input_file", default="captions/CUB_RP_captions.pkl", type=str)
    p.add_argument("--saved_file_path", default=None, type=str)
    p.add_argument("--gpu_id", default="0", type=str, help="accepted for the reference's command lines; ignored")
    p.add_argument("--captions_pickle", type=str, required=True, help="vocab source (captions.pickle)")
    p.add_argument("--text_encoder", type=str, required=True, help="text_encoder200.pth or .npz")
    p.add_argument("--image_encoder", type=str, required=True, help="image_encoder200.pth or .npz")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--legacy-compat", action="store_true")
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

    ixtoword, wordtoix = load_vocab(args.captions_pickle)
    scorer = DamsmScorer(damsm.load_rnn_state_dict(args.text_encoder), damsm.load_cnn_state_dict(args.image_encoder),
                         device, fast=args.precision == "fast")
    ntoken = scorer.rnn.encoder.num_embeddings
    if ntoken != len(ixtoword):
        raise ValueError(f"{args.text_encoder} embeds {ntoken} words; {args.captions_pickle} holds {len(ixtoword)}")
    rp_input = result_io.load_pickle(args.rp_input_file)
    mean, std, _ = compute_rp_cub(rp_input, args.image_dir, scorer, wordtoix, batch_size=args.batch_size,
                                  legacy_compat=args.legacy_compat, seed=args.seed,
                                  snapshot_path=args.snapshot_file)
    if args.saved_file_path is not None:
        result_io.write_rp_cub_result(args.saved_file_path, mean, std)
    print("R mean:{:.6f} std:{:.6f}".format(mean, std))


if __name__ == "__main__":
    main()
