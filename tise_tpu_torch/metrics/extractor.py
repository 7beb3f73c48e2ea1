"""Feature-extraction engine for one device (mirrors tise_tpu/metrics/extractor.py).

Every metric's hot loop has one shape: stream uint8 batches from an image
folder, normalize on the device (kernel K1), run a backbone forward, collect
features.  The host sends uint8 (a quarter of the float32 bytes) from pinned
memory with a non-blocking copy, and keeps one batch in flight: batch k's
results are pulled to the host only after batch k+1 has been launched, so
host decode and transfer overlap device compute.
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tise_tpu_torch.core.data import Batch, ImageFolderLoader
from tise_tpu_torch.ops.preprocess import normalize, resize_and_normalize
from tise_tpu_torch.parallel import multihost


class BatchedExtractor:
    """(uint8 NHWC batch) -> {name: features} on one device.

    ``apply_fn`` takes the normalized float NHWC batch on ``device`` and
    returns a dict of tensors whose first axis is the batch.

    ``device_resize_to``: the host sends native-size uint8 and the device
    normalizes (K1) and resizes to this size (the library's antialiased
    bilinear resize ~= PIL, a documented deviation) — the decode-only host
    path of ``--device-resize-from``.
    """

    def __init__(
        self,
        apply_fn: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
        *,
        recipe: str,
        device,
        device_resize_to: Optional[int] = None,
    ):
        self.apply_fn = apply_fn
        self.recipe = recipe
        self.device = torch.device(device)
        self.device_resize_to = device_resize_to

    def __call__(self, images_u8: np.ndarray) -> Dict[str, torch.Tensor]:
        """Launch one batch; returns device tensors (not synchronised)."""
        x = torch.from_numpy(np.ascontiguousarray(images_u8))
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        else:
            x = x.to(self.device)
        with torch.inference_mode():
            if self.device_resize_to is not None:
                return self.apply_fn(resize_and_normalize(x, self.recipe, self.device_resize_to))
            return self.apply_fn(normalize(x, self.recipe))

    def run(self, loader: Iterable[Batch], keys: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
        """Drain a loader; returns host arrays with padding rows removed.

        Across processes (``parallel.multihost``) the loader's file list is
        sharded, each process extracts its shard on its own device, and the
        rows are allgathered back into global file order: the result is the
        same on every process and bit-equal to one process's."""
        if multihost.is_distributed() and hasattr(loader, "files"):
            files = list(loader.files)
            if loader.drop_last:
                # legacy drop_last acts on the GLOBAL list (fid_score.py:216)
                files = files[: len(files) // loader.batch_size * loader.batch_size]
            local_files, idx = multihost.shard_items(files)
            sub = type(loader)(local_files, loader.batch_size, loader.image_size, resample=loader.resample,
                               center_crop=loader.center_crop, num_workers=loader.num_workers,
                               prefetch=loader.prefetch)
            local = self._run_local(sub, keys)
            if not local:
                # an empty shard (fewer files than processes) still enters the
                # SAME allgathers as every other process, or the cluster
                # deadlocks: a dummy forward gives the keys and row shapes
                size = loader.image_size
                dummy = self(np.zeros((1, size, size, 3), np.uint8))
                local = {k: np.zeros((0,) + tuple(v.shape[1:]), v.cpu().numpy().dtype)
                         for k, v in dummy.items() if keys is None or k in keys}
            return {k: multihost.allgather_rows(v, idx, len(files)) for k, v in local.items()}
        return self._run_local(loader, keys)

    def _run_local(self, loader: Iterable[Batch], keys: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
        pending: List[Tuple[Dict[str, torch.Tensor], np.ndarray]] = []
        chunks: Dict[str, List[np.ndarray]] = {}

        def collect(out: Dict[str, torch.Tensor], mask: np.ndarray) -> None:
            for name, val in out.items():
                if keys is None or name in keys:
                    chunks.setdefault(name, []).append(val.cpu().numpy()[mask])

        for batch in loader:
            pending.append((self(batch.images), batch.mask))
            if len(pending) > 1:
                collect(*pending.pop(0))
        while pending:
            collect(*pending.pop(0))
        return {k: np.concatenate(v, axis=0) for k, v in chunks.items()}


def _snapshot_fingerprint(files: Sequence[str], image_size: int, keys) -> str:
    h = hashlib.sha256()
    for f in files:
        h.update(f.encode())
        h.update(b"\0")
    h.update(f"|{image_size}|{','.join(sorted(keys or ()))}".encode())
    return h.hexdigest()


def _load_snapshot(path: str, fingerprint: str) -> Tuple[Dict[str, List[np.ndarray]], int]:
    """-> (chunks dict, images-consumed cursor) or ({}, 0) when absent/stale."""
    if not os.path.exists(path):
        return {}, 0
    try:
        with np.load(path, allow_pickle=False) as z:
            if str(z["fingerprint"]) != fingerprint:
                return {}, 0
            cursor = int(z["cursor"])
            chunks = {k[len("rows_"):]: [z[k]] for k in z.files if k.startswith("rows_")}
            return chunks, cursor
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):  # torn/corrupt: start over
        return {}, 0


def _save_snapshot(path: str, fingerprint: str, chunks: Dict[str, List[np.ndarray]], cursor: int) -> None:
    payload = {f"rows_{k}": np.concatenate(v, axis=0) for k, v in chunks.items()}
    tmp = path + ".tmp.npz"  # np.savez appends .npz to bare names
    np.savez(tmp, fingerprint=fingerprint, cursor=cursor, **payload)
    os.replace(tmp, path)  # atomic: a kill mid-write never leaves a torn file


def run_resumable(
    build_extractor: Callable[[], BatchedExtractor],
    files: Sequence[str],
    *,
    batch_size: int,
    image_size: int,
    snapshot_path: str,
    keys: Optional[Sequence[str]] = None,
    snapshot_every: int = 4096,
) -> Dict[str, np.ndarray]:
    """Resumable extractor drain: the same result as
    ``build_extractor().run(loader, keys)``, bit for bit, because the
    collected rows are a prefix of the file order.

    Every ``snapshot_every`` images the rows so far and the file cursor are
    written atomically to ``snapshot_path`` (npz, fingerprinted by the file
    list, image size and keys).  A run that fails re-raises and leaves the
    snapshot; running the same command again resumes from it.  A finished
    run deletes the snapshot.  (The JAX package also resets its TPU backend
    in-process and retries; a CUDA context that faulted cannot be reset in
    process, so the port re-raises.)
    """
    if multihost.is_distributed():
        raise NotImplementedError("run_resumable is one process's; a multi-process run shards the file list "
                                  "across processes instead (BatchedExtractor.run)")
    files = list(files)
    fingerprint = _snapshot_fingerprint(files, image_size, keys)
    chunks, cursor = _load_snapshot(snapshot_path, fingerprint)
    extractor = build_extractor()
    loader = ImageFolderLoader(files[cursor:], batch_size, image_size)
    pending: List[tuple] = []
    since_snap = 0

    def collect(out, mask, paths) -> None:
        nonlocal cursor, since_snap
        for name, val in out.items():
            if keys is None or name in keys:
                chunks.setdefault(name, []).append(val.cpu().numpy()[mask])
        cursor += len(paths)
        since_snap += len(paths)

    for batch in loader:
        pending.append((extractor(batch.images), batch.mask, batch.paths))
        if len(pending) > 1:
            collect(*pending.pop(0))
        if since_snap >= snapshot_every:
            # flush in-flight work so the snapshot cursor is exact
            while pending:
                collect(*pending.pop(0))
            _save_snapshot(snapshot_path, fingerprint, chunks, cursor)
            since_snap = 0
    while pending:
        collect(*pending.pop(0))
    if os.path.exists(snapshot_path):
        os.remove(snapshot_path)
    return {k: np.concatenate(v, axis=0) for k, v in chunks.items()}
