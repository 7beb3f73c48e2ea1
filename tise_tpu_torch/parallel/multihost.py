"""Multi-process metric execution on ``torch.distributed`` (mirrors
tise_tpu/parallel/multihost.py).

Metric extraction is embarrassingly parallel over images, so each process
runs its own device over a strided shard of the work items
(:func:`shard_items`), and one collective, :func:`allgather_rows`,
reassembles the per-item outputs in global item order once extraction ends.
Every process then computes the same final metric, bit-equal to one
process over the same item order, so order-dependent steps (IS* split
binning, RP bins) see the order of one process.  Every participating
process runs the same CLI; there is no primary.

The rows are host numpy arrays, so they travel over the default process
group, which is gloo (``parallel.init_distributed``): gloo takes CPU
tensors, NCCL does not.  Without a process group every function here acts
as one process: a shard is the whole list and a gather only scatters.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def is_distributed() -> bool:
    return process_count() > 1


def shard_items(items: Sequence) -> Tuple[List, np.ndarray]:
    """This process's strided shard: (items[p::n], their global indices).

    Strided, not blocked, so shards stay balanced when the cost of an item
    drifts with its position (SOA's label folders are sorted by class)."""
    p, n = process_index(), process_count()
    idx = np.arange(p, len(items), n, dtype=np.int64)
    return [items[i] for i in idx], idx


def _gather_bytes(rows: np.ndarray) -> np.ndarray:
    """[per, nbytes] uint8 from every process -> [nproc, per, nbytes]."""
    local = torch.from_numpy(np.ascontiguousarray(rows))
    out = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(out, local)
    return torch.stack(out).numpy()


def allgather_rows(local: np.ndarray, idx: np.ndarray, total: int) -> np.ndarray:
    """Reassemble per-item rows from every process into global item order.

    ``local``: [k, ...] rows this process produced for the global items
    ``idx``; returns [total, ...] with every process's rows scattered into
    place, the same on every process.  One process: scatter only, no
    collective.  Rows are padded to the largest shard so every process
    sends the same shape, and they travel as raw bytes (a ``uint8`` view),
    so every dtype, f64 and int64 included, arrives bit for bit."""
    local = np.asarray(local)
    row_shape = local.shape[1:]
    out = np.zeros((total,) + row_shape, local.dtype)
    if not is_distributed() or total == 0:
        out[idx[: len(local)]] = local
        return out
    per = -(-total // process_count())
    buf = np.zeros((per,) + row_shape, local.dtype)
    buf[: len(local)] = local
    ibuf = np.full((per,), -1, np.int64)
    ibuf[: len(idx)] = idx
    vals = _gather_bytes(buf.reshape(per, -1).view(np.uint8))
    idxs = _gather_bytes(ibuf.reshape(per, 1).view(np.uint8))
    flat_v = vals.reshape(-1, vals.shape[-1]).view(local.dtype).reshape((-1,) + row_shape)
    flat_i = idxs.reshape(-1, 8).view(np.int64).reshape(-1)
    m = flat_i >= 0
    out[flat_i[m]] = flat_v[m]
    return out


def barrier(name: str) -> None:
    """A point every process reaches before any goes on (SOA's pickles are
    all written before any process reads them); ``name`` says which."""
    if not is_distributed():
        return
    dist.barrier()
