"""Time the redesigned kernels beside their earlier designs and their
library calls on the card: K1 (``csrc/normalize.cu``), K2
(``csrc/avg_pool3x3.cu``), P2 (``csrc/layout_probes.cu::dma_minor27``) and
P6 (``csrc/stem_mm.cu``).

K2: the nine f32 pools of one batch of 64 at 299 px (the pool branches of
Mixed_5b-d, 6b-e and 7b-c) and the nine thin pools of the fast trunk, each set
as one run of launches, against the bytes they must move (each input element
read once, each output element written once, at 3.35 TB/s): CUDA events
around ten runs, in turns, and the kernels' own time from ``torch.profiler``.
P2: its time on the device (``torch.profiler``) at [8, 128, 27] for runs of
4 to 32 rows a block, beside ``torch.mul(x, 2.0)``.  K1: the "fid" recipe in
f32 at the main paths' [64, 299, 299, 3] and [64, 64, 64, 3], by events, by
the host's clock and on the device, against the bytes bound, beside
``torch.addcmul(shift, x, scale)``.  P6: µs a dot
at the probe's five shapes (a long chain less a short one, as the probe
times it) and the device time of one launch of 512 dots.

``--before-pool FILE.cu`` adds a source with the C entry of the 8x8-tile K2
(``tise_avg_pool3x3_s1_p1(x, out, B, H, W, C, dtype, include_pad, stream)``),
``--before-probes FILE.cu`` one with the 4-block P2
(``tise_probe_dma_minor27(x, out, B, BB, R, M, stream)``, BB = 2),
``--before-stem FILE.cu`` one with the wmma P6 (``tise_stem_mm(x, w, s_out,
y_part, sink, m, k, n, nsteps, stream)``, 16 rows and min(n, 64) columns a
block), and ``--before-normalize FILE.py`` a module with the Triton K1
(``normalize_kernel(x, recipe, dtype)``, loaded by path): each is held
against the committed kernel (bit for bit; P6's last dot within chip_smoke.py's
tolerances) and timed in turns with it inside one process, so that the
numbers compare on one card under one power limit.  ``--sweep`` also times
K2 under other constants of the wrapper's geometry rule
(``ops/fast_pool.py::_geometry``: threads a block aims at, blocks a grid aims
at, the least band) and P6 at every wgmma n that fits each shape
(``tools/stem_mm_probe.py::stem_geometry`` picks one).

Usage: python -m tise_tpu_torch.tools.kernel_compare [--before-pool FILE.cu] [--before-probes FILE.cu]
       [--before-stem FILE.cu] [--before-normalize FILE.py] [--sweep]      (needs one CUDA card and nvcc)
"""

from __future__ import annotations

import ctypes
import importlib.util
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from tise_tpu_torch.core.config import resolve_device
from tise_tpu_torch.ops import fast_pool, native, preprocess
from tise_tpu_torch.tools import mosaic_probe, stem_mm_probe

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


#: profiled runs device_us takes before it gives up: on an H100 torch.profiler has been seen to
#: come back with no kernel at all for a call whose kernels ran
PROFILE_TRIES = 3


def device_us(fn, calls: int = 20) -> Optional[float]:
    """Device time of one call from torch.profiler (the sum over the kernels
    it launches), in µs, or None where the profiler shows no device time in
    any of PROFILE_TRIES profiled runs."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)  # kernel rows only: an op's row repeats its kernels' time
        if total > 0:
            return total / calls
    return None


def _us(t: Optional[float]) -> str:
    return "not measured" if t is None else f"{t:.2f} us"


def host_us(fn, calls: int = 1000, reps: int = 3) -> tuple:
    """(host µs per call, µs per call with the queue drained): a host clock
    around ``calls`` calls with no synchronise inside, then one synchronise;
    the median of ``reps``.  The first says how fast the host can enqueue the
    call; where the second is no larger, the device kept up and the call is
    bound by the host."""
    for _ in range(20):
        fn()
    enqueue, drained = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        enqueue.append((t1 - t0) / calls * 1e6)
        drained.append((t2 - t0) / calls * 1e6)
    return statistics.median(enqueue), statistics.median(drained)


def bound_ms(shapes) -> float:
    return sum(n * 2 * torch.Size(s).numel() * 4 for s, n in shapes) / PEAK_BYTES_S * 1e3


def build_before(src: Path, symbol: str, ints: int, pointers: int = 2) -> native.CFunction:
    """Compile an earlier source; its entry ``symbol`` (``pointers``
    pointers, ``ints`` ints, stream)."""
    out_dir = native.BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"{src.stem}_before.so"
    done = subprocess.run([native.nvcc(), *native.NVCC_FLAGS, "-o", str(lib), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{done.stdout}")
    for line in done.stdout.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[ptxas] {src.name}: {line.strip()}")
    native._LIBS[str(lib)] = ctypes.CDLL(str(lib))  # native.library() then finds it under its path
    return native.CFunction(str(lib), symbol, [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p])


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
            us = device_us(lambda: variants[k](x))
            if us is not None:
                times[k].append(us)
    run, blocks = mosaic_probe.dma_minor27_runs(tuple(x.shape))
    print(f"[P2 dma_minor27] {list(x.shape)} on the device (torch.profiler, median of 4 turns); the wrapper takes "
          f"runs of {run} rows ({blocks} blocks): " +
          ", ".join(f"{k} {statistics.median(v):.3f} us" if v else f"{k} not measured" for k, v in times.items()))


def load_before_normalize(path: Path):
    """An earlier ops/preprocess.py, loaded by path as a module of its own."""
    spec = importlib.util.spec_from_file_location("before_preprocess", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def compare_normalize(before, rounds: int, device) -> Callable:
    """K1 against the earlier K1: bit for bit in every recipe, f32 and bf16,
    then the "fid" recipe in f32 at both main-path shapes by events (in
    turns) and by the host's clock, beside its library call
    ``torch.addcmul(shift, x, scale)`` (one fused multiply-add: within an ulp
    of K1, not bit-equal); returns the profiler's part."""
    gen = torch.Generator(device=device).manual_seed(0)
    u8 = torch.randint(0, 256, (BATCH, 299, 299, 3), generator=gen, device=device, dtype=torch.uint8)
    xs = {"299 px": u8, "64 px": u8[:, :64, :64].contiguous()}
    scale, shift = (c.to(device) for c in preprocess._constants("fid", torch.float32))
    variants = {"committed": lambda x: preprocess.normalize_kernel(x, "fid"),
                "torch.addcmul": lambda x: torch.addcmul(shift, x, scale)}
    if before is not None:
        for x in xs.values():
            for recipe in sorted(preprocess.RECIPES):
                for dtype in (torch.float32, torch.bfloat16):
                    if not torch.equal(preprocess.normalize_kernel(x, recipe, dtype),
                                       before.normalize_kernel(x, recipe, dtype)):
                        raise AssertionError(f"K1 {tuple(x.shape)} {recipe} {dtype}: committed != before")
        print("[K1 normalize] committed == before, bit for bit, in every recipe, f32 and bf16, at both shapes")
        variants["before"] = lambda x: before.normalize_kernel(x, "fid")
    for label, x in xs.items():
        least = x.numel() * 5 / PEAK_BYTES_S * 1e6
        for name, ms in in_turns(variants, [(x, 1)], rounds).items():
            enqueue, drained = host_us(lambda: variants[name](x))
            print(f"[K1 normalize] {label} {name}: events {ms * 1e3:.2f} us, host {enqueue:.2f} us a call "
                  f"({drained:.2f} us with the queue drained); bound {least:.2f} us")

    def profile():
        for label, x in xs.items():
            least = x.numel() * 5 / PEAK_BYTES_S * 1e6
            times = {k: [] for k in variants}
            order = list(variants)
            for r in range(4):
                for k in (order if r % 2 == 0 else order[::-1]):
                    us = device_us(lambda: variants[k](x))
                    if us is not None:
                        times[k].append(us)
            print(f"[K1 normalize] {label} on the device (torch.profiler, median of 4 turns): " + ", ".join(
                f"{k} {statistics.median(v):.2f} us ({least / statistics.median(v):.1%} of {least:.2f} us)" if v
                else f"{k} not measured" for k, v in times.items()))

    return profile


def run_before_stem(fn: native.CFunction, x: torch.Tensor, w: torch.Tensor, nsteps: int, return_last: bool = False):
    """The wmma P6 (16 rows and min(n, 64) columns a block, 8 warps split
    into column tiles and K slices), as its wrapper called it."""
    (m, k), n = x.shape, w.shape[1]
    nb, m_pad = min(n, 64), -(-m // 16) * 16
    k_slices = 8 // (nb // 16)
    s = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    sink = torch.empty(((m_pad // 16) * (n // nb) * 256,), dtype=torch.float32, device=x.device)
    y_part = torch.empty((k_slices, m_pad, n), dtype=torch.float32, device=x.device) if return_last else None
    native.launch(fn, _Counter, x.device, x.data_ptr(), w.data_ptr(), s.data_ptr(),
                  y_part.data_ptr() if return_last else None, sink.data_ptr(), m, k, n, nsteps)
    return (s, y_part.sum(0)[:m]) if return_last else s


def run_stem_geometry(g: stem_mm_probe.StemGeometry):
    """The committed P6 under a geometry of the caller's choosing (one of
    ``stem_geometries``)."""
    def kernel(x, w, nsteps):
        (m, k), n = x.shape, w.shape[1]
        s = torch.empty((1, 1), dtype=torch.float32, device=x.device)
        sink = torch.empty((g.grid[0] * g.grid[1] * stem_mm_probe.THREADS,), dtype=torch.float32, device=x.device)
        native.launch(stem_mm_probe._STEM_MM, _Counter, x.device, x.data_ptr(), w.data_ptr(), s.data_ptr(), None,
                      sink.data_ptr(), m, k, n, g.nb, g.smem_bytes, nsteps)
        return s
    return kernel


STEM_NSTEPS = 512  # dots in one launch of P6 where it is timed on the device and held against its plain loop


def compare_stem(before: Optional[native.CFunction], sweep: bool, device) -> Callable:
    """P6 against the earlier P6 at the probe's five shapes: the last dot of
    each within rtol 1e-4, atol 1e-4 of its scale at 1 and 5 steps, then µs a
    dot in turns (committed, before, before, committed); returns the
    profiler's part (one launch of STEM_NSTEPS dots on the device)."""
    variants = {"committed": stem_mm_probe.stem_mm_kernel}
    if before is not None:
        variants["before"] = lambda x, w, nsteps, return_last=False: run_before_stem(before, x, w, nsteps, return_last)
    inputs = {}
    for label, m, k, n in stem_mm_probe.SHAPES:
        x, w = (torch.from_numpy(a).to(device=device, dtype=torch.bfloat16)
                for a in stem_mm_probe.probe_inputs(m, k, n, seed=1))
        inputs[label] = (x, w)
        if before is not None:
            for nsteps in (1, 5):
                (_, y), (_, y_before) = (fn(x, w, nsteps, return_last=True) for fn in variants.values())
                scale = float(y_before.abs().max())
                if not torch.allclose(y, y_before, rtol=1e-4, atol=1e-4 * scale):
                    raise AssertionError(f"P6 {label} nsteps {nsteps}: committed and before differ by "
                                         f"{float((y - y_before).abs().max())}")
        per_dot = {k: [] for k in variants}
        order = list(variants)
        for r in range(4):
            for name in (order if r % 2 == 0 else order[::-1]):
                per_dot[name].append(stem_mm_probe.time_shape(m, k, n, device, nsteps=2048, reps=1,
                                                              kernel=variants[name])["us_per_dot"])
        g = stem_mm_probe.stem_geometry(m, k, n)
        flops = 2.0 * m * k * n
        nb_before = min(n, 64)
        smem_before = (16 + nb_before) * (g.kp + 8) * 2 + 8 // (nb_before // 16) * 1024
        print(f"[P6 stem_mm] {label}: committed wgmma n {g.nb}, grid {g.grid}, {g.smem_bytes} bytes of shared memory "
              f"a block; before 16 x {nb_before} tiles, grid {(-(-m // 16), n // nb_before)}, {smem_before} bytes")
        print(f"[P6 stem_mm] {label}: " + ", ".join(
            f"{name} {statistics.median(v):.3f} us a dot ({flops / (statistics.median(v) * 1e-6) / 1e12:.1f} TFLOP/s, "
            f"{flops / (statistics.median(v) * 1e-6) / stem_mm_probe.PEAK_BF16:.2%} of the bf16 peak)"
            for name, v in per_dot.items()) + " (median of 4 turns)")
        if sweep:
            times = {o.nb: stem_mm_probe.time_shape(m, k, n, device, nsteps=2048, kernel=run_stem_geometry(o))["us_per_dot"]
                     for o in stem_mm_probe.stem_geometries(m, k, n)}
            print(f"[P6 stem_mm] {label} by wgmma n: " + ", ".join(f"{nb} {t:.3f} us" for nb, t in times.items()))

    def profile():
        for label, m, k, n in stem_mm_probe.SHAPES:
            x, w = inputs[label]
            bound = STEM_NSTEPS * 2.0 * m * k * n / stem_mm_probe.PEAK_BF16 * 1e6
            print(f"[P6 stem_mm] {label} {STEM_NSTEPS} dots on the device (torch.profiler): " + ", ".join(
                f"{name} {_us(device_us(lambda: fn(x, w, STEM_NSTEPS), calls=3))}" for name, fn in variants.items())
                + f"; operations bound {bound:.1f} us")

    return profile


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--before-pool", type=str, default=None, help="a .cu with the 8x8-tile K2's C entry")
    p.add_argument("--before-probes", type=str, default=None, help="a .cu with the 4-block P2's C entry")
    p.add_argument("--before-stem", type=str, default=None, help="a .cu with the wmma P6's C entry")
    p.add_argument("--before-normalize", type=str, default=None, help="a preprocess.py with the Triton K1")
    p.add_argument("--sweep", action="store_true",
                   help="also time other constants of K2's geometry rule and every wgmma n of P6")
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("kernel_compare times CUDA kernels; it has nothing to measure on the CPU")
    native.build_all()
    for name in ("normalize", "avg_pool3x3", "stem_mm"):
        for line in native.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[ptxas] {name}: {line.strip()}")
    pool_before = build_before(Path(args.before_pool), "tise_avg_pool3x3_s1_p1", 6) if args.before_pool else None
    dma_before = build_before(Path(args.before_probes), "tise_probe_dma_minor27", 4) if args.before_probes else None
    stem_before = build_before(Path(args.before_stem), "tise_stem_mm", 4, pointers=5) if args.before_stem else None
    normalize_before = load_before_normalize(Path(args.before_normalize)) if args.before_normalize else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} / {smi}")
    profiles = compare_pool(pool_before, args.sweep, args.rounds, device)
    compare_dma(dma_before, device)
    profiles.append(compare_normalize(normalize_before, args.rounds, device))
    profiles.append(compare_stem(stem_before, args.sweep, device))
    for profile in profiles:
        profile()
    return 0


if __name__ == "__main__":
    sys.exit(main())
