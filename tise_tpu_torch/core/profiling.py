"""Tracing and throughput observability (mirrors tise_tpu/core/profiling.py).

``trace(log_dir)`` records the enclosed section with ``torch.profiler`` (the
host's operators and, where a card is present, its kernels through CUPTI)
and writes a Chrome/Perfetto trace into ``log_dir``, in TensorBoard's layout
(``<worker>.<time>.pt.trace.json``).  ``ThroughputMeter`` is the JAX
package's images/s counter, with the same log line and ``summary()``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace of the enclosed section into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


@dataclass
class ThroughputMeter:
    """Streaming images/sec counter with periodic logging."""

    name: str = "extract"
    log_every: int = 50
    _count: int = 0
    _batches: int = 0
    _start: Optional[float] = None

    def update(self, n: int) -> None:
        if self._start is None:
            self._start = time.perf_counter()
        self._count += n
        self._batches += 1
        if self.log_every and self._batches % self.log_every == 0:
            print(f"[{self.name}] {self.rate():.1f} images/sec ({self._count} done)", flush=True)

    def rate(self) -> float:
        if not self._start:
            return 0.0
        dt = time.perf_counter() - self._start
        return self._count / dt if dt > 0 else 0.0

    def summary(self) -> str:
        return json.dumps({"name": self.name, "images": self._count, "images_per_sec": round(self.rate(), 2)})
