"""In-shared-memory bf16 matmul throughput at the Inception stem's shapes:
kernel P6 (mirrors tools/stem_mm_probe.py).

The question, asked of a CUDA card: how fast does a chain of dots
``y = x @ w`` run when both operands stay in shared memory, at the stem's
narrow output widths (conv2a N = 32, conv2b N = 64)?  That rate decides
whether a fused stem kernel could beat the library's convolutions of
``backbones/inception_fast.py``.  The probe times the chain through the
hand-written kernel ``csrc/stem_mm.cu`` (the weights are re-rounded through
f32 after every dot, so no dot can be hoisted) and prints, per shape, the
time of one dot, the achieved TFLOP/s and its share of the card's dense bf16
peak; beside them it prints the time of the library's bf16 stem
(Conv2d_1a_3x3 .. Conv2d_2b_3x3 of FastInception at batch 64), which is what
a fused stem would have to beat.

Usage: python -m tise_tpu_torch.tools.stem_mm_probe     (needs one CUDA card)
"""

from __future__ import annotations

import ctypes
import sys
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from tise_tpu_torch.core.config import resolve_device
from tise_tpu_torch.ops import native

#: dense bf16 tensor-core peak of one H100 SXM (NVIDIA's data sheet), FLOP/s
PEAK_BF16 = 989e12
#: shared memory one block may use on sm_90, and one SM holds (each block also reserves 1 KB), bytes
SMEM_LIMIT, SMEM_PER_SM, SMEM_RESERVED = 232448, 233472, 1024
SMS = 132                      # streaming multiprocessors of one H100
THREADS = 128                  # one warpgroup a block
MAX_THREADS_PER_SM = 2048
#: rows of x a block owns (the m of one wgmma), and the wgmma n's the kernel is built for
BLOCK_ROWS, WGMMA_N = 64, (8, 16, 32)
#: k, rounded up to 16, up to which a step is one or two k16 wgmmas, whose latency sets its time
LATENCY_KP = 32

#: (label, m, k, n): the stem's and one A block's matmul shapes, and a wide control
SHAPES = (
    ("conv1a  K27 N32 ", 2384, 27, 32),
    ("conv2a  K288 N32", 2352, 288, 32),
    ("conv2b  K288 N64", 2352, 288, 64),
    ("ablock5x5 K1200 N64", 1225, 1200, 64),
    ("control K1152 N128", 1176, 1152, 128),
)


def stem_mm_plain(x: torch.Tensor, w: torch.Tensor, nsteps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of P6: ``nsteps`` dependent dots in f32 on the
    bf16 values (products of bf16 are exact in f32; run with TF32 off), the
    running sum of ``y[0, 0]`` as [1, 1], and the last dot's ``y``."""
    xf = x.float()
    s = torch.zeros((), dtype=torch.float32, device=x.device)
    y = None
    for _ in range(nsteps):
        y = xf @ w.float()
        s = s + y[0, 0]
        w = (w.float() + y[0, 0] * 1e-30).to(w.dtype)
    return s.reshape(1, 1), y


class StemGeometry(NamedTuple):
    """How P6 cuts one [m, k] x [k, n] chain over blocks: what
    ``tise_stem_mm`` is given (``nb``) and what it launches from it."""

    nb: int                  # columns of w a block owns: the wgmma n
    kp: int                  # k rounded up to 16
    grid: Tuple[int, int]    # (strips of BLOCK_ROWS rows of x, slices of nb columns of w)
    smem_bytes: int          # shared memory of one block
    occupancy: int           # blocks one SM can hold
    step_bytes: int          # shared-memory bytes the busiest SM moves a step


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def stem_geometries(m: int, k: int, n: int) -> List[StemGeometry]:
    """One geometry for each nb of WGMMA_N that divides n and fits
    SMEM_LIMIT.  Its cost, ``step_bytes``: a block's step reads its x strip
    and w slice into the tensor cores (128 kp + 2 nb kp bytes) and reads and
    writes the slice in the rewrite (4 nb kp); an SM runs ceil(blocks / SMS)
    blocks."""
    kp = _cdiv(k, 16) * 16
    options = []
    for nb in WGMMA_N:
        smem = (BLOCK_ROWS + nb) * kp * 2 + 16
        if n % nb != 0 or smem > SMEM_LIMIT:
            continue
        grid = (_cdiv(m, BLOCK_ROWS), n // nb)
        occupancy = min(SMEM_PER_SM // (smem + SMEM_RESERVED), MAX_THREADS_PER_SM // THREADS)
        cost = _cdiv(grid[0] * grid[1], SMS) * kp * (128 + 6 * nb)
        options.append(StemGeometry(nb, kp, grid, smem, occupancy, cost))
    return options


def stem_geometry(m: int, k: int, n: int) -> StemGeometry:
    """Up to LATENCY_KP, where a step's latency sets its time: the narrowest
    slice whose grid runs in one wave at its occupancy (a narrower wgmma
    finishes sooner, and blocks that share an SM overlap their latencies).
    Beyond it, where shared-memory bytes do: the geometry that gives the
    busiest SM the fewest bytes a step; ties go to the wider slice (fewer
    blocks)."""
    options = stem_geometries(m, k, n)
    if not options:
        raise ValueError(f"[{m}, {k}] x [{k}, {n}]: n must be a multiple of 8, and k = {k} leaves no slice of w "
                         f"that fits {SMEM_LIMIT} bytes of shared memory beside a {BLOCK_ROWS}-row strip of x")
    one_wave = [g for g in options if g.grid[0] * g.grid[1] <= SMS * g.occupancy]
    if options[0].kp <= LATENCY_KP and one_wave:
        return min(one_wave, key=lambda g: g.nb)
    return min(options, key=lambda g: (g.step_bytes, -g.nb))


_STEM_MM = native.CFunction("stem_mm", "tise_stem_mm",
                            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def stem_mm_kernel(x: torch.Tensor, w: torch.Tensor, nsteps: int, return_last: bool = False):
    """P6 on CUDA tensors: bf16 ``x`` [m, k] and ``w`` [k, n] (n a multiple
    of 8) -> the [1, 1] f32 sum of ``y[0, 0]`` over ``nsteps`` dependent
    dots; with ``return_last`` also the last dot's ``y`` [m, n] in f32.

    ``return_last`` exists for comparisons with the plain version only (the
    kernel then stores its accumulators on the last step); the probe itself
    never asks for ``y``."""
    if not (x.is_cuda and w.is_cuda) or x.device != w.device:
        raise ValueError("stem_mm_kernel takes two CUDA tensors on one device")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"expected bfloat16, got {x.dtype} and {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] or min(*x.shape, *w.shape) == 0:
        raise ValueError(f"expected [m, k] and [k, n], got {tuple(x.shape)} and {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("stem_mm_kernel takes contiguous row-major matrices")
    if nsteps < 1:
        raise ValueError("nsteps must be at least 1")
    (m, k), n = x.shape, w.shape[1]
    g = stem_geometry(m, k, n)
    s = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    sink = torch.empty((g.grid[0] * g.grid[1] * THREADS,), dtype=torch.float32, device=x.device)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device) if return_last else None
    native.launch(_STEM_MM, stem_mm_kernel, x.device, x.data_ptr(), w.data_ptr(), s.data_ptr(),
                  y.data_ptr() if return_last else None, sink.data_ptr(), m, k, n, g.nb, g.smem_bytes, nsteps)
    return (s, y) if return_last else s


stem_mm_kernel.launches = 0


def stem_mm(x: torch.Tensor, w: torch.Tensor, nsteps: int) -> torch.Tensor:
    """The [1, 1] sum of the chain: P6 on CUDA tensors, the plain version on
    CPU tensors."""
    if x.device.type == "cpu":
        return stem_mm_plain(x, w, nsteps)[0]
    return stem_mm_kernel(x, w, nsteps)


def probe_inputs(m: int, k: int, n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded standard-normal x [m, k] and w [k, n] (f32; callers cast to bf16)."""
    rng = np.random.RandomState(seed)
    return rng.randn(m, k).astype(np.float32), rng.randn(k, n).astype(np.float32)


def _event_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_shape(m: int, k: int, n: int, device, nsteps: int = 4096, reps: int = 3,
               kernel=None) -> Dict[str, float]:
    """Best-of-``reps`` time of one dot inside the chain, by differencing a
    long and a short launch (which removes the launch and the one-time load of
    the operands into shared memory).  ``kernel(x, w, nsteps)`` is P6 unless
    the caller names another."""
    kernel = kernel or stem_mm_kernel
    x, w = (torch.from_numpy(a).to(device=device, dtype=torch.bfloat16) for a in probe_inputs(m, k, n))
    short = max(1, nsteps // 8)
    kernel(x, w, short)  # warm-up (and the build, at first use)
    torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(reps):
        t_long = _event_ms(lambda: kernel(x, w, nsteps))
        t_short = _event_ms(lambda: kernel(x, w, short))
        best = min(best, (t_long - t_short) / (nsteps - short))
    flops = 2.0 * m * k * n
    return {"us_per_dot": best * 1e3, "tflops": flops / (best * 1e-3) / 1e12,
            "peak_share": flops / (best * 1e-3) / PEAK_BF16}


def library_stem_ms(device, batch: int = 64, reps: int = 5, inner: int = 10) -> float:
    """Median device time of the library's bf16 stem: Conv2d_1a_3x3,
    Conv2d_2a_3x3 and Conv2d_2b_3x3 of FastInception (cuDNN, channels_last,
    f32 bias + relu epilogues) on a [batch, 299, 299, 3] input, up to but not
    including the first max pool."""
    from tise_tpu_torch.backbones.inception_fast import FastInception
    from tise_tpu_torch.backbones.inception_v3 import random_state_dict

    net = FastInception(random_state_dict(0), torch.bfloat16, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((batch, 3, 299, 299), generator=gen, device=device).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)

    def stem():
        y = net._conv(x, "Conv2d_1a_3x3", stride=2)
        y = net._conv(y, "Conv2d_2a_3x3")
        return net._conv(y, "Conv2d_2b_3x3", padding=1)

    with torch.no_grad():
        for _ in range(3):
            stem()
        torch.cuda.synchronize(device)
        times = sorted(_event_ms(lambda: [stem() for _ in range(inner)]) / inner for _ in range(reps))
    return times[len(times) // 2]


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--nsteps", type=int, default=4096, help="dots in the long launch of each shape")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("stem_mm_probe times a CUDA kernel; it has nothing to measure on the CPU")
    print(f"torch {torch.__version__} / device {torch.cuda.get_device_name(device)}")
    for label, m, k, n in SHAPES:
        r = time_shape(m, k, n, device, nsteps=args.nsteps)
        g = stem_geometry(m, k, n)
        print(f"{label}: {r['us_per_dot']:7.3f} us/dot  {r['tflops']:7.2f} TFLOP/s "
              f"({r['peak_share'] * 100:5.2f}% of the dense bf16 peak of {PEAK_BF16 / 1e12:.0f} TFLOP/s); "
              f"wgmma n {g.nb}, grid {g.grid}, {g.smem_bytes} bytes of shared memory a block")
    print(f"library bf16 stem (conv1a..conv2b, batch 64, cuDNN): {library_stem_ms(device):.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
