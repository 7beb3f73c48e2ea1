"""Text-image training dataset (the port's copy of
tise_tpu/models/datasets.py; reference: AttnGAN++/datasets.py).  numpy and
PIL only.

The reference's layout, so that its released data drops in:
  * ``captions.pickle``: [train_caps, test_caps, ixtoword, wordtoix]
    (datasets.py:203-233); the vocabulary is built from \\w+-tokenised,
    lowercased, ascii-filtered captions with <end> = 0 (:131-201);
  * ``<split>/filenames.pickle`` and ``<split>/class_info.pickle`` (:235-251);
  * ``<key>.jpg`` (under ``CUB_200_2011/images`` for CUB and under
    ``train2014``/``val2014`` for COCO);
  * the CUB bbox crop, 0.75 x max(w, h) around the box's centre, when
    ``birds`` is in the path (:54-65);
  * a random caption of an image's CAPTIONS_PER_IMAGE, padded or subsampled
    to WORDS_NUM (:253-271, 294-297), and 99 mismatched captions for the
    train-time R-precision (:300-319).

Batches carry uint8 NHWC images at every scale; the trainer normalizes them
on the device (K1 under ``half``).  A pool of threads decodes a batch's
images, and the next batch is assembled while the caller works on the
current one.  ``self.rng`` is shared by the caption draws and, with
``augment``, by the crops and flips that the pool's threads draw: then the
draws interleave, as in the JAX package; without ``augment`` (or with one
worker) the batches are those of the JAX dataset.
"""

from __future__ import annotations

import os
import pickle
import re
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from tise_tpu_torch.models.attngan_pp.trainer import Batch

_WORD_RE = re.compile(r"\w+")


def tokenize(caption: str) -> List[str]:
    """\\w+ tokens, lowercased, ascii-filtered (datasets.py:141-156)."""
    caption = caption.replace("��", " ")
    out = []
    for tok in _WORD_RE.findall(caption.lower()):
        tok = tok.encode("ascii", "ignore").decode("ascii")
        if tok:
            out.append(tok)
    return out


def build_dictionary(train_captions: Sequence[List[str]], test_captions: Sequence[List[str]]
                     ) -> Tuple[List[List[int]], List[List[int]], Dict[int, str], Dict[str, int]]:
    """The vocabulary over train and test tokens; id 0 is <end> (datasets.py:164-201)."""
    counts: Dict[str, float] = defaultdict(float)
    for sent in list(train_captions) + list(test_captions):
        for w in sent:
            counts[w] += 1
    ixtoword = {0: "<end>"}
    wordtoix = {"<end>": 0}
    for i, w in enumerate(counts, start=1):
        wordtoix[w] = i
        ixtoword[i] = w

    def encode(caps):
        return [[wordtoix[w] for w in sent if w in wordtoix] for sent in caps]

    return encode(train_captions), encode(test_captions), ixtoword, wordtoix


def cub_bbox_crop(im: Image.Image, bbox: Sequence[int]) -> Image.Image:
    """The 0.75 x max(w, h) crop around the box's centre (datasets.py:57-65)."""
    width, height = im.size
    r = int(np.maximum(bbox[2], bbox[3]) * 0.75)
    cx = int((2 * bbox[0] + bbox[2]) / 2)
    cy = int((2 * bbox[1] + bbox[3]) / 2)
    y1, y2 = max(0, cy - r), min(height, cy + r)
    x1, x2 = max(0, cx - r), min(width, cx + r)
    return im.crop((x1, y1, x2, y2))


def _read_columns(path: str) -> List[List[str]]:
    """A whitespace-separated table without a header, one row a line."""
    with open(path) as f:
        return [line.split() for line in f if line.strip()]


class TextImageDataset:
    """Caption-conditioned image dataset over the reference's layout."""

    def __init__(self, data_dir: str, split: str = "train", *, base_size: int = 64, branch_num: int = 3,
                 words_num: int = 18, captions_per_image: int = 10, seed: int = 0, augment: bool = False):
        self.data_dir = data_dir
        self.split = split
        self.augment = augment
        self.words_num = words_num
        self.embeddings_num = captions_per_image
        self.imsizes = [base_size * (2 ** i) for i in range(branch_num)]
        self.rng = np.random.RandomState(seed)

        self.filenames = self._load_filenames(split)
        self.captions, self.ixtoword, self.wordtoix = self._load_text_data(split)
        self.n_words = len(self.ixtoword)
        self.class_id = self._load_class_id(split)
        self.bbox = self._load_bbox() if "birds" in data_dir else None

    # -- the reference's files ----------------------------------------------
    def _load_filenames(self, split: str) -> List[str]:
        path = os.path.join(self.data_dir, split, "filenames.pickle")
        if os.path.isfile(path):
            with open(path, "rb") as f:
                return pickle.load(f, encoding="latin1")
        return []

    def _load_class_id(self, split: str) -> np.ndarray:
        path = os.path.join(self.data_dir, split, "class_info.pickle")
        if os.path.isfile(path):
            with open(path, "rb") as f:
                return np.asarray(pickle.load(f, encoding="latin1"))
        return np.arange(len(self.filenames))

    def _load_bbox(self) -> Optional[Dict[str, List[int]]]:
        """CUB's bounding_boxes.txt and images.txt (the JAX package reads
        them with pandas; the rows are "<index> <x> <y> <w> <h>" and
        "<index> <path>")."""
        root = os.path.join(self.data_dir, "CUB_200_2011")
        if not os.path.isdir(root):
            return None
        boxes = [[int(float(v)) for v in row[1:5]] for row in _read_columns(os.path.join(root, "bounding_boxes.txt"))]
        names = [row[1] for row in _read_columns(os.path.join(root, "images.txt"))]
        return {name[:-4]: boxes[i] for i, name in enumerate(names)}

    def _read_raw_captions(self, filenames: Sequence[str]) -> List[List[str]]:
        out = []
        for name in filenames:
            with open(os.path.join(self.data_dir, "text", f"{name}.txt"), "r", errors="ignore") as f:
                cnt = 0
                for cap in f.read().split("\n"):
                    toks = tokenize(cap) if cap else []
                    if not toks:
                        continue
                    out.append(toks)
                    cnt += 1
                    if cnt == self.embeddings_num:
                        break
        return out

    def _load_text_data(self, split: str):
        """The captions.pickle cache, written on first use (datasets.py:203-233)."""
        path = os.path.join(self.data_dir, "captions.pickle")
        if os.path.isfile(path):
            with open(path, "rb") as f:
                x = pickle.load(f, encoding="latin1")
            train_caps, test_caps, ixtoword, wordtoix = x[0], x[1], x[2], x[3]
        else:
            train_caps, test_caps, ixtoword, wordtoix = build_dictionary(
                self._read_raw_captions(self._load_filenames("train")),
                self._read_raw_captions(self._load_filenames("test")))
            with open(path, "wb") as f:
                pickle.dump([train_caps, test_caps, ixtoword, wordtoix], f, protocol=2)
        caps = train_caps if split == "train" else test_caps
        return caps, ixtoword, wordtoix

    # -- sampling -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.filenames)

    def _image_path(self, key: str) -> str:
        if self.bbox is not None:
            return os.path.join(self.data_dir, "CUB_200_2011", "images", f"{key}.jpg")
        if "coco" in self.data_dir:
            sub = "train2014" if self.split == "train" else "val2014"
            return os.path.join(self.data_dir, sub, f"{key}.jpg")
        return os.path.join(self.data_dir, f"{key}.jpg")

    def _augment(self, im: Image.Image) -> Image.Image:
        """Train-time augmentation (pretrain_DAMSM.py:296-301, main.py's
        image_transform): the shorter side to 76/64 of the finest scale,
        a random crop of the finest scale, a random horizontal flip."""
        crop = self.imsizes[-1]
        short = int(crop * 76 / 64)
        w, h = im.size
        scale = short / min(w, h)
        im = im.resize((max(crop, int(round(w * scale))), max(crop, int(round(h * scale)))), Image.BILINEAR)
        w, h = im.size
        x = int(self.rng.randint(0, w - crop + 1))
        y = int(self.rng.randint(0, h - crop + 1))
        im = im.crop((x, y, x + crop, y + crop))
        if self.rng.rand() < 0.5:
            im = im.transpose(Image.FLIP_LEFT_RIGHT)
        return im

    def load_multiscale_image(self, index: int) -> List[np.ndarray]:
        """-> uint8 HWC arrays at the branch scales."""
        key = self.filenames[index]
        with Image.open(self._image_path(key)) as im:
            im = im.convert("RGB")
            if self.bbox is not None:
                im = cub_bbox_crop(im, self.bbox[key])
            if self.augment:
                im = self._augment(im)
            return [np.asarray(im.resize((size, size), Image.BILINEAR), dtype=np.uint8) for size in self.imsizes]

    def pad_caption(self, ids: Sequence[int]) -> Tuple[np.ndarray, int]:
        """Pad with 0, or subsample an overlong caption keeping word order
        (datasets.py:253-271)."""
        ids = np.asarray(ids, np.int32)
        x = np.zeros((self.words_num,), np.int32)
        if len(ids) <= self.words_num:
            x[: len(ids)] = ids
            return x, max(1, len(ids))
        keep = np.sort(self.rng.permutation(len(ids))[: self.words_num])
        x[:] = ids[keep]
        return x, self.words_num

    def sample_caption(self, index: int) -> Tuple[np.ndarray, int]:
        sent_ix = self.rng.randint(0, self.embeddings_num)
        return self.pad_caption(self.captions[index * self.embeddings_num + sent_ix])

    def get_mis_captions(self, cls_id: int, n: int = 99) -> Tuple[np.ndarray, np.ndarray]:
        """n captions of other classes (train-time R-precision, datasets.py:300-319)."""
        caps = np.zeros((n, self.words_num), np.int32)
        lens = np.zeros((n,), np.int32)
        i = 0
        while i < n:
            idx = self.rng.randint(0, len(self))
            if self.class_id[idx] == cls_id:
                continue
            sent_ix = self.rng.randint(0, self.embeddings_num)
            caps[i], lens[i] = self.pad_caption(self.captions[idx * self.embeddings_num + sent_ix])
            i += 1
        return caps, lens

    # -- batching -------------------------------------------------------------
    def _assemble(self, pool: ThreadPoolExecutor, idxs: np.ndarray) -> Batch:
        multi = list(pool.map(self.load_multiscale_image, idxs))
        images = tuple(np.stack([m[s] for m in multi]) for s in range(len(self.imsizes)))
        caps = np.zeros((len(idxs), self.words_num), np.int32)
        lens = np.zeros((len(idxs),), np.int32)
        for j, idx in enumerate(idxs):
            caps[j], lens[j] = self.sample_caption(idx)
        return Batch(images=images, captions=caps, cap_lens=lens, class_ids=self.class_id[idxs].astype(np.int32))

    def batches(self, batch_size: int, *, shuffle: bool = True, num_workers: int = 8,
                drop_last: bool = True) -> Iterator[Batch]:
        """Yield Batches of uint8 NHWC images at all scales, the next one
        assembled while the caller works on this one."""
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        n_batches = len(order) // batch_size if drop_last else -(-len(order) // batch_size)
        with ThreadPoolExecutor(max_workers=num_workers) as pool, ThreadPoolExecutor(max_workers=1) as ahead:
            pending = None
            for b in range(n_batches):
                idxs = order[b * batch_size: (b + 1) * batch_size]
                job = ahead.submit(self._assemble, pool, idxs)
                if pending is not None:
                    yield pending.result()
                pending = job
            if pending is not None:
                yield pending.result()
