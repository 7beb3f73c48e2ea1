"""Host-side image-folder dataset with threaded decode and prefetch
(mirrors tise_tpu/core/data.py; numpy and PIL only).

Folder conventions match the reference: a recursive walk collecting
``*.jpg``/``*.png`` (image_realism/FID/img_data.py:27-35), sorted for
determinism.  Decoding and the exact PIL resize run on host worker threads;
normalization runs on the device (ops/preprocess.py).  Batches have a static
shape (pad + mask), so the tail batch reuses the same buffers and kernels.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import numpy as np
from PIL import Image

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png")

BILINEAR = Image.BILINEAR
BICUBIC = Image.BICUBIC


def list_images(root: str) -> List[str]:
    """Recursive, sorted walk collecting jpg/png files."""
    out: List[str] = []
    for path, _dirs, files in sorted(os.walk(root)):
        for name in sorted(files):
            if name.lower().endswith(IMG_EXTENSIONS):
                out.append(os.path.join(path, name))
    return out


def load_image(path: str, size: Tuple[int, int], resample=BILINEAR) -> np.ndarray:
    """Decode one image -> uint8 HWC RGB resized with PIL (``transforms.Resize``
    on a PIL image, fid_score.py:208-213)."""
    with Image.open(path) as im:
        im = im.convert("RGB")
        if im.size != (size[1], size[0]):
            im = im.resize((size[1], size[0]), resample)
        return np.asarray(im, dtype=np.uint8)


def center_crop_resize(path: str, size: int, resample=BICUBIC) -> np.ndarray:
    """CLIP's preprocessing geometry: resize the shorter side to ``size``
    (bicubic; the new size rounded with Python's ``round``), then crop the
    centre ``size`` x ``size`` (openai/CLIP ``_transform``; RP_coco.py:64,
    PA.py:34)."""
    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        scale = size / min(w, h)
        nw, nh = round(w * scale), round(h * scale)
        im = im.resize((nw, nh), resample)
        left = (nw - size) // 2
        top = (nh - size) // 2
        im = im.crop((left, top, left + size, top + size))
        return np.asarray(im, dtype=np.uint8)


@dataclass
class Batch:
    """A fixed-shape host batch."""

    images: np.ndarray  # uint8 [B, H, W, 3]
    mask: np.ndarray  # bool [B]; False rows are padding
    paths: Sequence[str]


class ImageFolderLoader:
    """Threaded decode + prefetch over a list of image files: a thread pool
    decodes and PIL-resizes one batch while the device consumes the previous
    one (the reference's DataLoader, num_workers=8, fid_score.py:215-217).
    ``center_crop`` decodes with :func:`center_crop_resize` (CLIP's geometry)
    instead of resizing both sides."""

    def __init__(
        self,
        files: Sequence[str],
        batch_size: int,
        image_size: int,
        *,
        resample=BILINEAR,
        center_crop: bool = False,
        drop_last: bool = False,
        num_workers: int = 8,
        prefetch: int = 2,
    ):
        self.files = list(files)
        self.batch_size = batch_size
        self.image_size = image_size
        self.resample = resample
        self.center_crop = center_crop
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch

    @classmethod
    def from_dir(cls, root: str, batch_size: int, image_size: int, **kw) -> "ImageFolderLoader":
        return cls(list_images(root), batch_size, image_size, **kw)

    def __len__(self) -> int:
        n = len(self.files)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def num_images(self) -> int:
        n = len(self.files)
        return (n // self.batch_size) * self.batch_size if self.drop_last else n

    def _decode(self, path: str) -> np.ndarray:
        if self.center_crop:
            return center_crop_resize(path, self.image_size, self.resample)
        return load_image(path, (self.image_size, self.image_size), self.resample)

    def _make_batch(self, pool: ThreadPoolExecutor, chunk: Sequence[str]) -> Batch:
        imgs = list(pool.map(self._decode, chunk))
        b = len(imgs)
        out = np.zeros((self.batch_size, self.image_size, self.image_size, 3), dtype=np.uint8)
        out[:b] = np.stack(imgs)
        mask = np.zeros((self.batch_size,), dtype=bool)
        mask[:b] = True
        return Batch(images=out, mask=mask, paths=chunk)

    def __iter__(self) -> Iterator[Batch]:
        files = self.files
        n_full = len(files) // self.batch_size
        chunks = [files[i * self.batch_size : (i + 1) * self.batch_size] for i in range(n_full)]
        tail = files[n_full * self.batch_size :]
        if tail and not self.drop_last:
            chunks.append(tail)
        if not chunks:
            return

        q: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()

        def put(item) -> bool:
            # bounded waits so an abandoned iterator never strands the thread
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for chunk in chunks:
                        if not put(self._make_batch(pool, chunk)):
                            return
            except Exception as e:  # noqa: BLE001 — handed to the consumer, which re-raises
                put(e)
                return
            put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
