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
from typing import Dict, Tuple

import numpy as np
import torch

from tise_tpu_torch.core.config import resolve_device
from tise_tpu_torch.ops import native

#: dense bf16 tensor-core peak of one H100 SXM (NVIDIA's data sheet), FLOP/s
PEAK_BF16 = 989e12
#: shared memory one block may use on sm_90, bytes
SMEM_LIMIT = 232448
#: rows of x and (at most) columns of w one block of the kernel owns
BLOCK_ROWS, BLOCK_COLS = 16, 64

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


_STEM_MM = native.CFunction("stem_mm", "tise_stem_mm",
                            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# a host-side size query, no launch: called through bind(), not native.launch
_STEM_MM_SMEM_BYTES = native.CFunction("stem_mm", "tise_stem_mm_smem_bytes", [ctypes.c_int] * 2)


def stem_mm_kernel(x: torch.Tensor, w: torch.Tensor, nsteps: int, return_last: bool = False):
    """P6 on CUDA tensors: bf16 ``x`` [m, k] and ``w`` [k, n] (n a multiple
    of 32) -> the [1, 1] f32 sum of ``y[0, 0]`` over ``nsteps`` dependent
    dots; with ``return_last`` also the last dot's ``y`` [m, n] in f32.

    ``return_last`` exists for comparisons with the plain version only (the
    kernel then writes its per-warp partial sums of the last dot, added up
    here); the probe itself never asks for ``y``."""
    if not (x.is_cuda and w.is_cuda) or x.device != w.device:
        raise ValueError("stem_mm_kernel takes two CUDA tensors on one device")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"expected bfloat16, got {x.dtype} and {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] or min(*x.shape, *w.shape) == 0:
        raise ValueError(f"expected [m, k] and [k, n], got {tuple(x.shape)} and {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("stem_mm_kernel takes contiguous row-major matrices")
    (m, k), n = x.shape, w.shape[1]
    nb = min(n, BLOCK_COLS)
    if n % 32 != 0 or n % nb != 0:
        raise ValueError(f"n = {n} must be a multiple of 32 (and of {BLOCK_COLS} above it)")
    if nsteps < 1:
        raise ValueError("nsteps must be at least 1")
    smem = _STEM_MM_SMEM_BYTES.bind()(k, nb)
    if smem > SMEM_LIMIT:
        raise ValueError(f"k = {k} needs {smem} bytes of shared memory per block; the card gives {SMEM_LIMIT}")
    m_pad = -(-m // BLOCK_ROWS) * BLOCK_ROWS
    k_slices = 8 // (nb // 16)
    s = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    sink = torch.empty(((m_pad // BLOCK_ROWS) * (n // nb) * 256,), dtype=torch.float32, device=x.device)
    y_part = torch.empty((k_slices, m_pad, n), dtype=torch.float32, device=x.device) if return_last else None
    native.launch(_STEM_MM, stem_mm_kernel, x.device,
                  x.data_ptr(), w.data_ptr(), s.data_ptr(), y_part.data_ptr() if return_last else None,
                  sink.data_ptr(), m, k, n, nsteps)
    if return_last:
        return s, y_part.sum(0)[:m]
    return s


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


def time_shape(m: int, k: int, n: int, device, nsteps: int = 4096, reps: int = 3) -> Dict[str, float]:
    """Best-of-``reps`` time of one dot inside the chain, by differencing a
    long and a short launch (which removes the launch and the one-time load of
    the operands into shared memory)."""
    x, w = (torch.from_numpy(a).to(device=device, dtype=torch.bfloat16) for a in probe_inputs(m, k, n))
    short = max(1, nsteps // 8)
    stem_mm_kernel(x, w, short)  # warm-up (and the build, at first use)
    torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(reps):
        t_long = _event_ms(lambda: stem_mm_kernel(x, w, nsteps))
        t_short = _event_ms(lambda: stem_mm_kernel(x, w, short))
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
        print(f"{label}: {r['us_per_dot']:7.3f} us/dot  {r['tflops']:7.2f} TFLOP/s "
              f"({r['peak_share'] * 100:5.2f}% of the dense bf16 peak of {PEAK_BF16 / 1e12:.0f} TFLOP/s)")
    print(f"library bf16 stem (conv1a..conv2b, batch 64, cuDNN): {library_stem_ms(device):.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
