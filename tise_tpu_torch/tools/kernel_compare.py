"""Time the redesigned kernels K2 (``csrc/avg_pool3x3.cu``) and P2
(``csrc/layout_probes.cu::dma_minor27``) beside their earlier designs and
their library calls on the card.

K2: the nine f32 pools of one batch of 64 at 299 px (the pool branches of
Mixed_5b-d, 6b-e and 7b-c) and the nine thin pools of the fast trunk, each set
as one run of launches, against the bytes they must move (each input element
read once, each output element written once, at 3.35 TB/s): CUDA events
around ten runs, in turns, and the kernels' own time from ``torch.profiler``.
P2: its time on the device (``torch.profiler``) at [8, 128, 27] for runs of
4 to 32 rows a block, beside ``torch.mul(x, 2.0)``.

``--before-pool FILE.cu`` adds a source with the C entry of the 8x8-tile K2
(``tise_avg_pool3x3_s1_p1(x, out, B, H, W, C, dtype, include_pad, stream)``)
and ``--before-probes FILE.cu`` one with the 4-block P2
(``tise_probe_dma_minor27(x, out, B, BB, R, M, stream)``, BB = 2): each is
compiled next to the committed source, held bit for bit against it, and timed
in turns with it inside one process, so that the numbers compare on one card
under one power limit.  ``--sweep`` also times K2 under other constants of
the wrapper's geometry rule (``ops/fast_pool.py::_geometry``: threads a block
aims at, blocks a grid aims at, the least band).

Usage: python -m tise_tpu_torch.tools.kernel_compare [--before-pool FILE.cu] [--before-probes FILE.cu] [--sweep]
(needs one CUDA card and nvcc)
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from tise_tpu_torch.core.config import resolve_device
from tise_tpu_torch.ops import fast_pool, native
from tise_tpu_torch.tools import mosaic_probe

BATCH = 64
#: (shape, launches per batch): the pool branches of Mixed_5b-d, 6b-e, 7b-c at 299 px
POOL_SHAPES = [
    ((BATCH, 35, 35, 192), 1), ((BATCH, 35, 35, 256), 1), ((BATCH, 35, 35, 288), 1),
    ((BATCH, 17, 17, 768), 4), ((BATCH, 8, 8, 1280), 1), ((BATCH, 8, 8, 2048), 1),
]
#: the thin fan-out slices the fast trunk pools instead (f32, padding counted)
THIN_POOL_SHAPES = [
    ((BATCH, 35, 35, 32), 1), ((BATCH, 35, 35, 64), 2), ((BATCH, 17, 17, 192), 4), ((BATCH, 8, 8, 192), 2),
]
PEAK_BYTES_S = 3.35e12  # device memory of one H100 SXM (NVIDIA's data sheet)
#: (target threads, blocks aimed at, least band) tried by --sweep beside the wrapper's own; the
#: first is the rule's first setting (half the blocks, bands of 8 rows or more)
SWEEP = [(512, fast_pool.MIN_BLOCKS // 2, 8), (512, fast_pool.MIN_BLOCKS, fast_pool.MIN_BAND),
         (1024, fast_pool.MIN_BLOCKS, fast_pool.MIN_BAND), (fast_pool.TARGET_THREADS, 0, fast_pool.MIN_BAND),
         (fast_pool.TARGET_THREADS, 2 * fast_pool.MIN_BLOCKS, 2)]
DMA_RUN_ROWS = (4, 8, 16, 32)


class _Counter:
    launches = 0


def device_us(fn, calls: int = 20) -> Optional[float]:
    """Device time of one call from torch.profiler (the sum over the kernels
    it launches), in µs, or None where the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)  # kernel rows only: an op's row repeats its kernels' time
    return total / calls if total > 0 else None


def bound_ms(shapes) -> float:
    return sum(n * 2 * torch.Size(s).numel() * 4 for s, n in shapes) / PEAK_BYTES_S * 1e3


def build_before(src: Path, symbol: str, ints: int) -> native.CFunction:
    """Compile an earlier source; its entry ``symbol`` (x, out, ``ints``
    ints, stream)."""
    out_dir = native.BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"{src.stem}_before.so"
    done = subprocess.run([native.nvcc(), *native.NVCC_FLAGS, "-o", str(lib), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{done.stdout}")
    native._LIBS[str(lib)] = ctypes.CDLL(str(lib))  # native.library() then finds it under its path
    return native.CFunction(str(lib), symbol, [ctypes.c_void_p] * 2 + [ctypes.c_int] * ints + [ctypes.c_void_p])


def run_before_pool(fn: native.CFunction, x: torch.Tensor, include_pad: bool = True) -> torch.Tensor:
    out = torch.empty_like(x)
    native.launch(fn, _Counter, x.device, x.data_ptr(), out.data_ptr(), *x.shape,
                  fast_pool._DTYPES[x.dtype], int(include_pad))
    return out


def run_geometry(g: fast_pool.PoolGeometry, x: torch.Tensor, include_pad: bool = True) -> torch.Tensor:
    """The committed K2 under a geometry of the caller's choosing."""
    out = torch.empty_like(x)
    native.launch(fast_pool._AVG_POOL, _Counter, x.device, x.data_ptr(), out.data_ptr(), *x.shape,
                  fast_pool._DTYPES[x.dtype], int(include_pad), g.vec, g.cvb, g.chunk_w, g.n_chunks, g.band_h,
                  g.n_bands)
    return out


def run_dma(x: torch.Tensor, run_rows: int, before: Optional[native.CFunction] = None) -> torch.Tensor:
    """P2 with runs of ``run_rows`` rows, or the earlier source's P2."""
    b, r, m = x.shape
    out = torch.empty_like(x)
    if before is None:
        native.launch(mosaic_probe._DMA_MINOR27, _Counter, x.device, x.data_ptr(), out.data_ptr(), b * r, m, run_rows)
    else:
        native.launch(before, _Counter, x.device, x.data_ptr(), out.data_ptr(), b, 2, r, m)
    return out


def set_ms(pool: Callable, xs: List[Tuple[torch.Tensor, int]], inner: int = 10) -> float:
    """Events around ``inner`` runs of every pool of ``xs`` (each as often as
    it runs in a batch); ms per run."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(inner):
        for x, n in xs:
            for _ in range(n):
                pool(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / inner


def in_turns(variants: Dict[str, Callable], xs, rounds: int) -> Dict[str, float]:
    """Median ms of each variant by events, timed in turns (forwards, then backwards)."""
    for fn in variants.values():
        set_ms(fn, xs, inner=2)
    times = {k: [] for k in variants}
    order = list(variants)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(set_ms(variants[k], xs))
    return {k: statistics.median(v) for k, v in times.items()}


def on_device(variants: Dict[str, Callable], xs, rounds: int = 2) -> Dict[str, float]:
    """Device ms of one run of the set per variant (torch.profiler), the
    median of ``rounds`` turns."""
    times = {k: [] for k in variants}
    order = list(variants)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            us = device_us(lambda: [variants[k](x) for x, n in xs for _ in range(n)], calls=5)
            times[k].append(float("nan") if us is None else us / 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def compare_pool(before: Optional[native.CFunction], sweep: bool, rounds: int, device) -> List[Callable]:
    """K2's sets by events, in turns; returns the profiler's part, to be run
    after every event and host-clock timing (the profiler stays attached)."""
    gen = torch.Generator(device=device).manual_seed(0)
    later = []
    for label, shapes in (("nine f32 pools", POOL_SHAPES), ("nine thin pools", THIN_POOL_SHAPES)):
        xs = [(torch.randn(s, generator=gen, device=device), n) for s, n in shapes]
        variants = {"committed": fast_pool.avg_pool_kernel}
        if before is not None:
            for x, _ in xs:
                for include_pad in (True, False):
                    for dtype in (torch.float32, torch.bfloat16):
                        xi = x.to(dtype)
                        if not torch.equal(fast_pool.avg_pool_kernel(xi, include_pad),
                                           run_before_pool(before, xi, include_pad)):
                            raise AssertionError(f"{tuple(x.shape)} {dtype} pad={include_pad}: committed != before")
            variants["before"] = lambda x: run_before_pool(before, x)
        if sweep:
            for t, mb, band in SWEEP:
                geometry = {tuple(x.shape): fast_pool._geometry(x.shape, 4, True, t, mb, band) for x, _ in xs}
                variants[f"threads {t}, blocks {mb}, band {band}"] = (
                    lambda x, geometry=geometry: run_geometry(geometry[tuple(x.shape)], x))
        least = bound_ms(shapes)
        for name, ms in in_turns(variants, xs, rounds).items():
            print(f"[K2 {label}] {name}: events {ms:.4f} ms ({least / ms:.1%} of the {least:.4f} ms bound)")

        def profile(label=label, shapes=shapes, xs=xs, variants=variants, least=least):
            for name, ms in on_device(variants, xs).items():
                print(f"[K2 {label}] {name}: on the device {ms:.4f} ms ({least / ms:.1%} of the {least:.4f} ms bound)")
            pair = {k: variants[k] for k in variants if k in ("committed", "before")}
            for (s, n), (x, _) in zip(shapes, xs):
                g = fast_pool.pool_geometry(s, torch.float32)
                b = bound_ms([(s, 1)])
                print(f"[K2 {label}] {s} x{n}: {g.instance}, slice {g.cvb} vectors, bands of {g.band_h} rows, "
                      f"grid {g.grid}, {g.threads} threads; bound {b:.4f} ms; on the device " +
                      ", ".join(f"{k} {v:.4f} ms ({b / v:.1%})" for k, v in on_device(pair, [(x, 1)]).items()))

        later.append(profile)
    return later


def compare_dma(before: Optional[native.CFunction], device) -> None:
    x = torch.from_numpy(mosaic_probe.probe_input("dma_minor27", seed=1)).to(device)
    ref = mosaic_probe.dma_minor27_plain(x)
    variants = {f"runs of {rows} rows": (lambda x, rows=rows: run_dma(x, rows)) for rows in DMA_RUN_ROWS}
    if before is not None:
        variants["before (4 blocks of 256 rows)"] = lambda x: run_dma(x, 0, before)
    variants["torch.mul(x, 2.0)"] = lambda x: torch.mul(x, 2.0)
    for name, fn in variants.items():
        if not torch.equal(fn(x), ref):
            raise AssertionError(f"P2 {name} disagrees with the plain version")
    times = {k: [] for k in variants}
    order = list(variants)
    for r in range(4):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(device_us(lambda: variants[k](x)))
    run, blocks = mosaic_probe.dma_minor27_runs(tuple(x.shape))
    print(f"[P2 dma_minor27] {list(x.shape)} on the device (torch.profiler, median of 4 turns); the wrapper takes "
          f"runs of {run} rows ({blocks} blocks): " +
          ", ".join(f"{k} {statistics.median(v):.3f} us" for k, v in times.items()))


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--before-pool", type=str, default=None, help="a .cu with the 8x8-tile K2's C entry")
    p.add_argument("--before-probes", type=str, default=None, help="a .cu with the 4-block P2's C entry")
    p.add_argument("--sweep", action="store_true", help="also time other constants of K2's geometry rule")
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("kernel_compare times CUDA kernels; it has nothing to measure on the CPU")
    native.library("avg_pool3x3")
    for line in native.BUILD_LOG.get("avg_pool3x3", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[ptxas] avg_pool3x3: {line.strip()}")
    pool_before = build_before(Path(args.before_pool), "tise_avg_pool3x3_s1_p1", 6) if args.before_pool else None
    dma_before = build_before(Path(args.before_probes), "tise_probe_dma_minor27", 4) if args.before_probes else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} / {smi}")
    profiles = compare_pool(pool_before, args.sweep, args.rounds, device)
    compare_dma(dma_before, device)
    for profile in profiles:
        profile()
    return 0


if __name__ == "__main__":
    sys.exit(main())
