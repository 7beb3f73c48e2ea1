"""Multi-process layer on ``torch.distributed`` (mirrors tise_tpu/parallel).

  * :func:`init_distributed` joins a cluster of ``num_processes`` processes
    through a TCP rendezvous at ``coordinator`` (``host:port``), on a gloo
    default group: the metrics' host collectives (``multihost.py``) move
    numpy bytes, which NCCL cannot take.  Each process takes the card
    ``process_id % torch.cuda.device_count()``, or the CPU when asked for,
    as each JAX process drives its own local devices
    (tise_tpu/core/mesh.py:24-41).
  * :func:`step_group` is the group of a sharded train step's reductions of
    device tensors: NCCL when every process has a card of its own, gloo
    (through the host) when processes share a card, since NCCL refuses two
    ranks on one device, and gloo on the CPU.  The choice is made from the
    processes' (host, card) pairs before the group is made, and printed; a
    failed NCCL group raises, it never becomes gloo.
  * :func:`gather_rows` is the step's all-gather under autograd, with its
    backward stated: each process's loss is its share of a global loss, the
    global loss is their sum, so the gradient that reaches a process's rows
    is the SUM over processes of the gradients they computed for them.

Without counterparts: the JAX mesh object, ``batch_sharding`` and
``pad_to_multiple`` (the port drives one device a process and pads its
batches itself), and ``jax.distributed``'s detection of a cluster from its
environment (``--num-processes`` and ``--process-id`` are given).
"""

from __future__ import annotations

import datetime
import socket
import torch
import torch.distributed as dist

from tise_tpu_torch.core.config import resolve_device
from tise_tpu_torch.parallel import multihost  # noqa: F401

#: how long a collective waits for the other processes before it raises
TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(coordinator: str, num_processes: int, process_id: int, device: str = "cuda") -> torch.device:
    """Join the cluster (or check that this process has joined it with the
    same size and rank) and return this process's device: the card
    ``process_id % torch.cuda.device_count()`` for a CUDA ``device``, which
    raises where there is no card, else ``device`` itself."""
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator needs --num-processes and --process-id")
    base = resolve_device(device)
    if base.type == "cuda":
        base = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(base)
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes, process_id):
            raise RuntimeError(f"this process already joined a cluster as rank {dist.get_rank()} of "
                               f"{dist.get_world_size()}, not {process_id} of {num_processes}")
        return base
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id, timeout=TIMEOUT)
    return base


def step_group(device: torch.device):
    """A new process group of all processes for a sharded step on
    ``device``: NCCL where every process drives a card of its own (their
    (host, card) pairs are gathered over the default group), else gloo;
    the choice is printed.  Every process of the cluster calls it, in the
    same order."""
    backend = "gloo"
    if device.type == "cuda":
        seats = [None] * dist.get_world_size()
        dist.all_gather_object(seats, (socket.gethostname(), str(torch.cuda.get_device_properties(device).uuid)))
        backend = "nccl" if len(set(seats)) == len(seats) else "gloo"
    group = dist.new_group(backend=backend, timeout=TIMEOUT)
    print(f"[parallel] rank {dist.get_rank()} of {dist.get_world_size()}: the step's group is {backend} on {device}",
          flush=True)
    return group


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


class _GatherRows(torch.autograd.Function):
    """[b, ...] on each process -> [n b, ...], process p's rows at p b; the
    gradient of a process's rows is the sum over processes of the gradient
    of those rows.  Made of one all-reduce of a zero-padded buffer (adding
    zeros is exact), which every backend takes for device tensors."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rank, ctx.rows = group, dist.get_rank(group), x.shape[0]
        y = x.new_zeros((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
        y[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows] = x
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous().clone()
        dist.all_reduce(dy, group=ctx.group)
        return dy[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-gather along dim 0 in rank order; every process
    passes the same number of rows.  ``None`` is one process."""
    return x if group is None else _GatherRows.apply(x, group)
