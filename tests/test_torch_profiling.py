"""The port's ``core/profiling.py`` against the JAX package's: the
``ThroughputMeter`` prints the same lines and the same ``summary()`` for the
same updates on the same clock, and ``trace`` writes a Chrome trace of the
enclosed section on the CPU (the card's kernels join it where there is one).
"""

import glob
import json
import os
import time

import numpy as np
import torch

from tise_tpu.core import profiling as jprofiling
from tise_tpu_torch.core import profiling


def test_throughput_meter_matches_jax(monkeypatch, capsys):
    """Seven updates of 3, 5, 64, ... images, logging every second batch,
    on a clock that advances 0.25 s a reading: the lines, ``rate()`` and
    ``summary()`` equal the JAX meter's; an unstarted meter's rate is 0."""
    out = {}
    for name, module in (("jax", jprofiling), ("port", profiling)):
        ticks = iter(np.arange(0.0, 100.0, 0.25))
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
        meter = module.ThroughputMeter(name="gen", log_every=2)
        assert meter.rate() == 0.0
        for n in (3, 5, 64, 64, 7, 64, 1):
            meter.update(n)
        out[name] = (capsys.readouterr().out.splitlines(), meter.rate(), meter.summary())
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) == 3 and out["port"][0][0].startswith("[gen] ")
    assert json.loads(out["port"][2])["images"] == 208


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace(log_dir)`` around a matrix product writes one
    ``*.pt.trace.json`` into the folder (made if missing) whose events hold
    the product's operator."""
    log_dir = os.path.join(str(tmp_path), "trace")
    x = torch.randn(64, 64)
    with profiling.trace(log_dir):
        torch.mm(x, x)
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
