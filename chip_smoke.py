#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tise_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

It builds the port's hand-written kernels from the sources in this checkout
(nvcc for csrc/*.cu, all in parallel; Triton for the normalize kernel), holds
each of the nine kernels against its plain PyTorch version on the card at the
shapes the main paths give it, then drives every main path through the entry
point a user would call, at the full width of InceptionV3 at 299 x 299 with
seeded random weights (BatchNorm statistics calibrated on seeded images):

  * FID (``metrics.fid.main``) on two seeded folders of 20,480 PNGs with
    ``--sqrtm ns-pallas``, again from the two folders' statistics with
    ``--sqrtm scipy``, and a short O-FID pass through the same engine;
  * FID with ``--precision fast --device-resize-from 64`` on the same folders
    (native 64 x 64 uint8 up, normalize and resize on the device, bf16 folded
    trunk), held against the f32 host-resize value;
  * IS* COCO (2015-layout weights), IS* CUB (slim-layout weights, 51
    classes) and O-IS (80-class head), each held against the same logits
    scored on the host with numpy; IS* CUB once more with ``--precision
    fast`` (TF32 inside the forward only), held against the ``highest`` run;
  * the two probe entry points (``tools.mosaic_probe``, ``tools.stem_mm_probe``).

Launch counters, set to 0 before each path and read after it, show that each
path ran its kernels.

Output: one line per check, the card's name and power limit as nvidia-smi
gives them, a ``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
with no result line; so does a machine with no CUDA card.  Scratch files go
under build/chip_smoke/ and are removed at the end.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tise_tpu_torch.backbones import inception_slim
from tise_tpu_torch.backbones.inception_v3 import BasicConv2d, InceptionV3, random_state_dict
from tise_tpu_torch.core import io as result_io
from tise_tpu_torch.core.config import (IS_STAR_TEMPERATURE_COCO, IS_STAR_TEMPERATURE_CUB, NUM_SPLITS,
                                        O_IS_TEMPERATURE, configure_precision)
from tise_tpu_torch.core.data import ImageFolderLoader, list_images
from tise_tpu_torch.metrics import fid, is_star, o_fid, o_is
from tise_tpu_torch.ops import native, sqrtm, stats
from tise_tpu_torch.ops.fast_pool import avg_pool_kernel, avg_pool_plain
from tise_tpu_torch.ops.pallas_kernels import (epilogue_matmul_kernel, epilogue_matmul_plain,
                                               newton_schulz_sqrtm_pallas)
from tise_tpu_torch.ops.preprocess import RECIPES, normalize_kernel, normalize_plain, resize_and_normalize
from tise_tpu_torch.tools import mosaic_probe, stem_mm_probe


ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(ROOT, "build", "chip_smoke")
# per side: ten times the 2048 features, so each sample covariance keeps
# its smallest eigenvalues within about half of the population's
# (Marchenko–Pastur) and f32 Newton–Schulz converges on it
N_IMAGES = 20480
N_COCO = 5120      # IS* COCO: every image is scored
N_CUB = 2600       # IS* CUB: shuffled, then the tail beyond 40 batches of 64 is dropped
N_CROPS = 256      # O-FID and O-IS
BATCH = 64
NATIVE = 64        # side of the PNGs on disk
POOL_SHAPES = [  # (shape, launches per batch): the pool branches of Mixed_5b-d, 6b-e, 7b-c at 299 px
    ((BATCH, 35, 35, 192), 1), ((BATCH, 35, 35, 256), 1), ((BATCH, 35, 35, 288), 1),
    ((BATCH, 17, 17, 768), 4), ((BATCH, 8, 8, 1280), 1), ((BATCH, 8, 8, 2048), 1),
]
# the thin fan-out slices the fast trunk pools instead (f32, padding counted)
THIN_POOL_SHAPES = [
    ((BATCH, 35, 35, 32), 1), ((BATCH, 35, 35, 64), 2), ((BATCH, 17, 17, 192), 4), ((BATCH, 8, 8, 192), 2),
]
EDGE_POOL_SHAPES = [(2, 1, 1, 2048), (2, 1, 5, 8), (2, 5, 1, 8)]
STEM_NSTEPS = 512  # dots per launch where P6 is held against its plain loop and timed for the kernels line
# published peaks of one H100 SXM (NVIDIA's data sheet): device memory, f32
# outside the tensor cores, dense bf16 in them
PEAK_BYTES_S, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
_PROBE_SRC = "tise_tpu_torch/csrc/layout_probes.cu"
KERNELS = {  # name -> (launch counter owner, route, source, TPU kernel it replaces)
    "normalize": (normalize_kernel, "triton", "tise_tpu_torch/ops/preprocess.py",
                  "tise_tpu/ops/preprocess.py:82"),
    "avg_pool_3x3_s1_p1": (avg_pool_kernel, "cuda", "tise_tpu_torch/csrc/avg_pool3x3.cu",
                           "tise_tpu/ops/fast_pool.py:49"),
    "epilogue_matmul": (epilogue_matmul_kernel, "cuda", "tise_tpu_torch/csrc/epilogue_matmul.cu",
                        "tise_tpu/ops/pallas_kernels.py:32"),
    "lane_split": (mosaic_probe.lane_split_kernel, "cuda", _PROBE_SRC, "tools/mosaic_probe.py:51"),
    "dma_minor27": (mosaic_probe.dma_minor27_kernel, "cuda", _PROBE_SRC, "tools/mosaic_probe.py:63"),
    "strided_slice": (mosaic_probe.strided_slice_kernel, "cuda", _PROBE_SRC, "tools/mosaic_probe.py:78"),
    "lane_concat": (mosaic_probe.lane_concat_kernel, "cuda", _PROBE_SRC, "tools/mosaic_probe.py:89"),
    "scratch_stage": (mosaic_probe.scratch_stage_kernel, "cuda", _PROBE_SRC, "tools/mosaic_probe.py:104"),
    "stem_mm": (stem_mm_probe.stem_mm_kernel, "cuda", "tise_tpu_torch/csrc/stem_mm.cu",
                "tools/stem_mm_probe.py:38"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def median_ms(fn, reps: int = 7, inner: int = 10, warmup: int = 3) -> float:
    """Median device time of one call: CUDA events around ``inner`` calls in
    a row (so the host's launch time hides behind the queue), over ``reps``
    repeats."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place between two f32 or bf16
    tensors (ordered-integer view of the bits)."""
    int_t = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    sign = torch.iinfo(int_t).max

    def ordered(t):
        i = t.contiguous().view(int_t).long()
        return torch.where(i < 0, -(i & sign), i)

    return int((ordered(a) - ordered(b)).abs().max())


def bound(nbytes: float, ops: float = 0.0, peak_ops: float = PEAK_F32) -> dict:
    """The least time the card could take: the larger of the bytes that must
    move over the memory rate and the operations over their peak rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def reset_counters() -> None:
    for counter, *_ in KERNELS.values():
        counter.launches = 0


def counts() -> dict:
    return {name: counter.launches for name, (counter, *_) in KERNELS.items()}


# ---------------------------------------------------------------------------
# 1. set-up
# ---------------------------------------------------------------------------


def setup() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card")
    configure_precision("highest")
    require(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32, "TF32 is off")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device 0: {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = native.build_all()
    log(f"[build] {len(libs)} CUDA libraries in {time.perf_counter() - t0:.1f} s (nvcc, parallel)")
    for name, text in native.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return smi


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------


def check_normalize(gen: torch.Generator) -> dict:
    u8 = torch.randint(0, 256, (BATCH, 299, 299, 3), generator=gen, device="cuda", dtype=torch.uint8)
    native_u8 = u8[:, :NATIVE, :NATIVE].contiguous()  # what the device-resize path hands K1
    max_err = 0.0
    for recipe in sorted(RECIPES):
        for x in (u8, native_u8):
            for dtype, max_ulp in ((torch.float32, 1), (torch.bfloat16, 1)):
                got, ref = normalize_kernel(x, recipe, dtype), normalize_plain(x, recipe, dtype)
                torch.cuda.synchronize()
                require(got.shape == ref.shape and got.dtype == ref.dtype, f"normalize {recipe} shape/dtype")
                ulps = ulp_distance(got, ref)
                err = float((got.float() - ref.float()).abs().max())
                log(f"[K1 normalize] {recipe:13s} {x.shape[1]:3d} px {str(dtype):15s} max_abs_err {err:.3e} max_ulp {ulps}")
                require(ulps <= max_ulp, f"normalize {recipe} {dtype}: {ulps} ulp > {max_ulp}")
                if dtype == torch.float32:
                    max_err = max(max_err, err)
    ms = median_ms(lambda: normalize_kernel(u8, "fid"))
    plain_ms = median_ms(lambda: normalize_plain(u8, "fid"))
    log(f"[K1 normalize] fid f32 {list(u8.shape)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
        f"{list(native_u8.shape)}: kernel {median_ms(lambda: normalize_kernel(native_u8, 'fid')):.4f} ms")
    # one uint8 read and one f32 write per element; no single library call does both
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "library_ms": None, **bound(u8.numel() * 5)}


def check_avg_pool(gen: torch.Generator) -> dict:
    max_err, ms, plain_ms, library_ms, nbytes = 0.0, 0.0, 0.0, 0.0, 0
    thin = {"kernel": 0.0, "plain": 0.0}
    shapes = [(s, n, "trunk") for s, n in POOL_SHAPES] + [(s, n, "thin") for s, n in THIN_POOL_SHAPES]
    for shape, per_batch, kind in shapes + [(s, 0, "edge") for s in EDGE_POOL_SHAPES]:
        x = torch.randn(shape, generator=gen, device="cuda")
        for include_pad in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                xi = x.to(dtype)
                got, ref = avg_pool_kernel(xi, include_pad), avg_pool_plain(xi, include_pad)
                torch.cuda.synchronize()
                require(got.dtype == dtype and got.shape == ref.shape, f"pool {shape} dtype/shape")
                err = float((got.float() - ref.float()).abs().max())
                if dtype == torch.float32:
                    require(torch.allclose(got, ref, rtol=1e-6, atol=1e-6), f"pool {shape} pad={include_pad} f32: {err}")
                    max_err = max(max_err, err)
                else:
                    require(ulp_distance(got, ref) <= 1, f"pool {shape} pad={include_pad} bf16: {err}")
                log(f"[K2 avg_pool] {str(shape):22s} include_pad={include_pad!s:5s} {str(dtype):15s} max_abs_err {err:.3e}")
        if kind == "edge":
            continue
        k = median_ms(lambda: avg_pool_kernel(x, True))
        p = median_ms(lambda: avg_pool_plain(x, True))
        if kind == "thin":
            thin["kernel"] += per_batch * k
            thin["plain"] += per_batch * p
            continue
        nchw = x.permute(0, 3, 1, 2)  # channels_last view of the same memory
        lib = median_ms(lambda: torch.nn.functional.avg_pool2d(nchw, 3, 1, 1))
        # F.avg_pool2d divides once by 9 where K2 multiplies twice by 1/3: the same function to f32 rounding
        require(torch.allclose(torch.nn.functional.avg_pool2d(nchw, 3, 1, 1).permute(0, 2, 3, 1),
                               avg_pool_kernel(x, True), rtol=1e-5, atol=1e-6), f"pool {shape} vs F.avg_pool2d")
        log(f"[K2 avg_pool] {str(shape):22s} f32: kernel {k:.4f} ms, plain {p:.4f} ms, F.avg_pool2d {lib:.4f} ms "
            f"(x{per_batch} per batch)")
        ms += per_batch * k
        plain_ms += per_batch * p
        library_ms += per_batch * lib
        nbytes += per_batch * 2 * x.numel() * 4
    log(f"[K2 avg_pool] the nine pools of one f32 batch of {BATCH}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"F.avg_pool2d {library_ms:.4f} ms; the nine thin pools of the fast trunk: kernel {thin['kernel']:.4f} ms, "
        f"plain {thin['plain']:.4f} ms")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bound(nbytes)}


def _psd(gen: torch.Generator, n: int) -> torch.Tensor:
    a = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    return a @ a.T / n + 0.1 * torch.eye(n, device="cuda", dtype=torch.float64)


def check_epilogue_matmul(gen: torch.Generator) -> dict:
    max_err, out = 0.0, {}
    for n in (2048, 1000):
        a = torch.randn(n, n, generator=gen, device="cuda")
        b = torch.randn(n, n, generator=gen, device="cuda")
        got, ref = epilogue_matmul_kernel(a, b, 1.5, -0.5), epilogue_matmul_plain(a, b, 1.5, -0.5)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        # f32 sums of n products in another order: rtol 1e-4, atol 1e-4 of the output's scale
        require(torch.allclose(got, ref, rtol=1e-4, atol=1e-4 * scale), f"epilogue_matmul n={n}: {err} (scale {scale})")
        max_err = max(max_err, err)
        ms = median_ms(lambda: epilogue_matmul_kernel(a, b, 1.5, -0.5))
        plain_ms = median_ms(lambda: epilogue_matmul_plain(a, b, 1.5, -0.5))
        eye = 1.5 * torch.eye(n, device="cuda")
        library_ms = median_ms(lambda: torch.addmm(eye, a, b, beta=1.0, alpha=-0.5))  # the one call: cuBLAS f32
        gflops = 2 * n ** 3 / ms / 1e6
        log(f"[K3 epilogue_matmul] n={n}: max_abs_err {err:.3e} (scale {scale:.1f}); kernel {ms:.4f} ms "
            f"({gflops:.0f} GFLOP/s), plain {plain_ms:.4f} ms, torch.addmm {library_ms:.4f} ms")
        if n == 2048:
            out = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bound(3 * n * n * 4, 2 * n ** 3, PEAK_F32)}
    prod = (_psd(gen, 2048) @ _psd(gen, 2048)).float()
    t_k = median_ms(lambda: newton_schulz_sqrtm_pallas(prod), reps=3, inner=1, warmup=1)
    t_p = median_ms(lambda: sqrtm.newton_schulz_sqrtm(prod), reps=3, inner=1, warmup=1)
    tr_k = float(torch.trace(newton_schulz_sqrtm_pallas(prod)))
    tr_p = float(torch.trace(sqrtm.newton_schulz_sqrtm(prod)))
    rel = abs(tr_k - tr_p) / abs(tr_p)
    log(f"[K3 ns trace] n=2048, 30 steps: K3 iteration {tr_k:.8f} ({t_k:.1f} ms), plain iteration {tr_p:.8f} "
        f"({t_p:.1f} ms), rel {rel:.3e}")
    require(rel <= 1e-4, f"NS trace through K3 differs from the plain iteration by {rel}")
    out["max_abs_err"] = max_err
    return out


def check_layout_probes() -> dict:
    """P1-P5 at the TPU probes' shapes on seeded random input: P2-P5 bit-equal
    to plain, P1 (three f32 adds) within rtol 1e-6."""
    row = torch.cat([torch.full((32,), 2.0), torch.full((32,), 3.0)]).cuda()  # P5's constant row, built once outside the timing
    library = {  # the one PyTorch call that computes the same function, where there is one
        "lane_split": lambda x: torch.sum(x.view(x.shape[0], -1, 3), -1),
        "dma_minor27": lambda x: torch.mul(x, 2.0),
        "strided_slice": lambda x: x[:, ::2].contiguous(),
        "scratch_stage": lambda x: torch.mul(x, row),
    }
    # bytes the function must move: every input element it needs once, every output element once
    needed = {"strided_slice": lambda x, got: 2 * got.numel() * 4}  # only the even columns are read
    out = {}
    for name, (kernel, plain, shape, rtol) in mosaic_probe.PROBES.items():
        x = torch.from_numpy(mosaic_probe.probe_input(name, seed=1)).cuda()
        got, ref = kernel(x), plain(x)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok = got.shape == ref.shape and (torch.equal(got, ref) if rtol == 0.0 else torch.allclose(got, ref, rtol=rtol, atol=rtol))
        ms, plain_ms = median_ms(lambda: kernel(x)), median_ms(lambda: plain(x))
        library_ms = None
        if name in library:
            lib = library[name](x)
            require(torch.equal(lib, ref) if rtol == 0.0 else torch.allclose(lib, ref, rtol=rtol, atol=rtol),
                    f"probe {name}: the library call computes another function than the plain version")
            library_ms = median_ms(lambda: library[name](x))
        nbytes = needed[name](x, got) if name in needed else (x.numel() + got.numel()) * 4
        log(f"[probe {name}] {list(shape)} max_abs_err {err:.3e} ({'bit-equal' if torch.equal(got, ref) else f'rtol {rtol}'}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library call "
            f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}; {nbytes} bytes")
        require(ok, f"probe {name} disagrees with its plain version: {err}")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bound(nbytes)}
    return out


def check_stem_mm() -> dict:
    """P6 at all five shapes: the [1, 1] sum and the whole last dot against
    the plain loop (f32 sums of k exact products in another order: rtol 1e-4,
    atol 1e-4 of y's scale), then the time of one launch of STEM_NSTEPS dots."""
    max_err, ms, plain_ms, nbytes, ops = 0.0, 0.0, 0.0, 0, 0.0
    for label, m, k, n in stem_mm_probe.SHAPES:
        x, w = (torch.from_numpy(a).to(device="cuda", dtype=torch.bfloat16)
                for a in stem_mm_probe.probe_inputs(m, k, n, seed=1))
        for nsteps in (1, 5):
            (s, y), (s_ref, y_ref) = stem_mm_probe.stem_mm_kernel(x, w, nsteps, return_last=True), \
                stem_mm_probe.stem_mm_plain(x, w, nsteps)
            torch.cuda.synchronize()
            scale = float(y_ref.abs().max())
            err = float((y - y_ref).abs().max())
            require(s.shape == (1, 1) and y.shape == (m, n), f"stem_mm {label} shapes")
            require(torch.allclose(y, y_ref, rtol=1e-4, atol=1e-4 * scale), f"stem_mm {label}: last dot off by {err}")
            require(abs(float(s) - float(s_ref)) <= 1e-4 * nsteps * scale, f"stem_mm {label}: sum {float(s)} vs {float(s_ref)}")
            max_err = max(max_err, err)
        t = median_ms(lambda: stem_mm_probe.stem_mm_kernel(x, w, STEM_NSTEPS), reps=3, inner=1, warmup=1)
        p = median_ms(lambda: stem_mm_probe.stem_mm_plain(x, w, STEM_NSTEPS), reps=3, inner=1, warmup=1)
        log(f"[P6 stem_mm] {label} [{m},{k}]x[{k},{n}]: last dot max_abs_err {err:.3e} (scale {scale:.1f}); "
            f"{STEM_NSTEPS} dots: kernel {t:.4f} ms, plain loop {p:.4f} ms")
        ms += t
        plain_ms += p
        nbytes += (m * k + k * n) * 2 + 4
        ops += STEM_NSTEPS * 2.0 * m * k * n
    # a chain of dependent dots is no single library call
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "library_ms": None, **bound(nbytes, ops, PEAK_BF16)}


# ---------------------------------------------------------------------------
# 3. data and weights
# ---------------------------------------------------------------------------


def noise_images(n: int, seed: int, lo: int) -> np.ndarray:
    """n seeded 64x64 RGB images of uniform pixel noise in [lo, 255 - lo]."""
    return np.random.RandomState(seed).randint(lo, 256 - lo, (n, NATIVE, NATIVE, 3)).astype(np.uint8)


def write_folder(root: str, images: np.ndarray) -> str:
    """One PNG per image; the loader PIL-resizes them to 299 (the
    reference's host-resize path) or hands them on as they are."""
    os.makedirs(root, exist_ok=True)
    from PIL import Image

    def save(i):
        Image.fromarray(images[i]).save(os.path.join(root, f"{i:05d}.png"))

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(save, range(len(images))))
    return root


def calibrated_state(seed: int, num_classes: int, images: np.ndarray, recipe: str):
    """``random_state_dict(seed)`` with every BatchNorm's running mean and
    variance set to the statistics of its convolution's output on
    ``images`` normalized under ``recipe`` (a data-dependent init; the
    recipes differ in range by a factor of four, so a trunk is calibrated for
    the one it will see), as CPU tensors; and the mean norm of pool3 on those
    images.  The fc is rescaled to a standard deviation of
    1 / that norm, so that logits are of order 1 and no softmax saturates to
    an exact 0 (which the split KL turns into NaN).

    The raw random trunk maps every image to nearly the same pool3 vector
    (per-feature std about 3e-4 of the mean, 220 features always 0), so the
    covariance is singular and f32 Newton–Schulz diverges on it, in the JAX
    package as here.  With calibrated statistics every feature varies
    (std about 0.3 of the mean) and none is dead."""
    from PIL import Image

    model = InceptionV3.from_state_dict(random_state_dict(seed, num_classes), device="cuda")

    def set_stats(bn, _conv, _inputs, out):
        bn.running_mean.copy_(out.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(out.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.conv.register_forward_hook(functools.partial(set_stats, m.bn))
             for m in model.modules() if isinstance(m, BasicConv2d)]
    x = np.stack([np.asarray(Image.fromarray(im).resize((fid.IMAGE_SIZE,) * 2, Image.BILINEAR)) for im in images])
    with torch.no_grad():
        x = normalize_kernel(torch.from_numpy(x).cuda(), recipe)
        model(x)
        for h in hooks:
            h.remove()
        norm = float(model(x)["pool3"].norm(dim=1).mean())
        model.fc.weight.mul_(1.0 / (norm * float(model.fc.weight.std())))
    return {k: v.cpu().contiguous() for k, v in model.state_dict().items()}, norm


def tf_layout_vars(state: dict, layout: str, seed: int, head_std: float) -> dict:
    """The trunk of a torchvision-layout state dict under the TF-slim
    variable names or the 2015 GraphDef node names (kernels OIHW -> HWIO; the
    inverse of the maps in backbones/inception_slim.py), with a seeded head
    of standard deviation ``head_std``: 51-way ``logits/logits`` for slim,
    bias-free ``softmax/weights`` over 1008 classes for 2015."""
    stem, mixed, branches, kernel, bn = {
        "slim": (inception_slim._STEM, inception_slim._MIXED, inception_slim._BRANCHES, "weights", "BatchNorm"),
        "2015": (inception_slim._STEM_2015, inception_slim._MIXED_2015, inception_slim._BRANCHES_2015,
                 "conv2d_params", "batchnorm"),
    }[layout]
    units = dict((scope, mod) for scope, mod in stem.items())
    for scope, mod in mixed.items():
        for sub, name in branches[inception_slim._BLOCK_KIND[mod]].items():
            units[f"{scope}/{sub}"] = f"{mod}.{name}"
    out = {}
    for scope, prefix in units.items():
        out[f"{scope}/{kernel}"] = state[f"{prefix}.conv.weight"].permute(2, 3, 1, 0).contiguous().numpy()
        for tf_name, key in (("gamma", "weight"), ("beta", "bias"), ("moving_mean", "running_mean"),
                             ("moving_variance", "running_var")):
            out[f"{scope}/{bn}/{tf_name}"] = state[f"{prefix}.bn.{key}"].numpy()
    rng = np.random.RandomState(seed)
    if layout == "slim":
        out["logits/logits/weights"] = rng.normal(0.0, head_std, (2048, 51)).astype(np.float32)
        out["logits/logits/biases"] = rng.normal(0.0, 0.02, (51,)).astype(np.float32)
    else:
        out["softmax/weights"] = rng.normal(0.0, head_std, (2048, 1008)).astype(np.float32)
    return out


def make_data() -> dict:
    shutil.rmtree(SCRATCH, ignore_errors=True)
    t0 = time.perf_counter()
    d = {
        # side a: full-range noise; side b: noise at lower contrast
        "a": write_folder(os.path.join(SCRATCH, "a"), noise_images(N_IMAGES, seed=1, lo=0)),
        "b": write_folder(os.path.join(SCRATCH, "b"), noise_images(N_IMAGES, seed=2, lo=48)),
        "crops_a": write_folder(os.path.join(SCRATCH, "oa"), noise_images(N_CROPS, seed=3, lo=0)),
        "crops_b": write_folder(os.path.join(SCRATCH, "ob"), noise_images(N_CROPS, seed=4, lo=48)),
        "coco": write_folder(os.path.join(SCRATCH, "coco"), np.concatenate(
            [noise_images(N_COCO // 2, seed=5, lo=0), noise_images(N_COCO // 2, seed=6, lo=48)])),
        "cub": write_folder(os.path.join(SCRATCH, "cub"), np.concatenate(
            [noise_images(N_CUB // 2, seed=7, lo=0), noise_images(N_CUB // 2, seed=8, lo=48)])),
    }
    calibration = np.concatenate([noise_images(128, seed=11, lo=0), noise_images(128, seed=12, lo=48)])
    state, _ = calibrated_state(0, 1000, calibration, "fid")
    d["weights"] = os.path.join(SCRATCH, "inception.pth")
    torch.save(state, d["weights"])
    state80, _ = calibrated_state(1, 80, calibration, "half")  # O-IS's recipe; O-FID needs no more than finite features
    state_is, pool3_norm = calibrated_state(2, 1000, calibration, "is_star")
    d["weights80"] = os.path.join(SCRATCH, "inception80.pth")
    torch.save(state80, d["weights80"])
    d["slim"], d["g2015"] = os.path.join(SCRATCH, "slim.npz"), os.path.join(SCRATCH, "g2015.npz")
    np.savez(d["slim"], **tf_layout_vars(state_is, "slim", seed=21, head_std=1.0 / pool3_norm))
    np.savez(d["g2015"], **tf_layout_vars(state_is, "2015", seed=22, head_std=1.0 / pool3_norm))
    log(f"[data] 2 x {N_IMAGES} + {N_COCO} + {N_CUB} + 2 x {N_CROPS} PNGs and three calibrated trunks in four weight files "
        f"in {time.perf_counter() - t0:.1f} s (mean pool3 norm of the IS* trunk {pool3_norm:.1f})")
    return d


# ---------------------------------------------------------------------------
# 4. the main paths, each counted on its own
# ---------------------------------------------------------------------------


def check_trunks_against_cpu(state_dict) -> None:
    """The f32 trunk on the card (K1, K2, cuDNN with TF32 off) against the
    same trunk on the CPU (plain versions) on 4 images: pool3 within rtol
    1e-4, atol 1e-4 of its scale (tests/test_inception.py's tolerance); the
    bf16 fast trunk on the card within 0.04 of the scale of both (that
    file's bf16 tolerance)."""
    u8 = np.random.RandomState(7).randint(0, 256, (4, 299, 299, 3)).astype(np.uint8)
    gpu = fid.make_pool3_extractor(state_dict, "cuda")(u8)["pool3"].cpu()
    cpu = fid.make_pool3_extractor(state_dict, "cpu")(u8)["pool3"]
    fast = fid.make_pool3_extractor(state_dict, "cuda", fast=True)(u8)["pool3"].cpu()
    err = float((gpu - cpu).abs().max())
    scale = float(cpu.abs().max())
    fast_err = float((fast - cpu).abs().max())
    log(f"[trunk] pool3 card vs CPU on 4 images: max_abs_err {err:.3e} (scale {scale:.3f}); "
        f"bf16 fast trunk on the card vs CPU f32: {fast_err:.3e} ({fast_err / scale:.2e} of scale)")
    require(bool(torch.isfinite(gpu).all()) and bool(torch.isfinite(fast).all()), "pool3 is finite")
    require(torch.allclose(gpu, cpu, rtol=1e-4, atol=1e-4 * scale), f"pool3 card vs CPU: {err}")
    require(fast_err <= 0.04 * scale, f"fast pool3 vs f32: {fast_err} > 0.04 x {scale}")


def read_fid(path: str) -> float:
    with open(path) as f:
        text = f.read()
    require(text.startswith("FID: "), f"result file format: {text!r}")
    value = float(text[len("FID: "):])
    require(np.isfinite(value), f"{path} holds {text!r}")
    return value


def path_fid_f32(d: dict, state_dict) -> dict:
    """FID in f32 with host resize and the K3 square root, its stages one by
    one, the scipy run from cached statistics, and a short O-FID pass."""
    saved = os.path.join(SCRATCH, "fid_ns_pallas.txt")
    reset_counters()
    t0 = time.perf_counter()
    fid.main(["--path1", d["a"], "--path2", d["b"], "--weights", d["weights"], "--sqrtm", "ns-pallas",
              "--batch-size", str(BATCH), "--saved_file", saved])
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t0
    launches = counts()
    rate = 2 * N_IMAGES / t_cli
    log(f"[fid ns-pallas] CLI {t_cli:.2f} s ({rate:.1f} images/s end to end); launches {launches}")
    batches = 2 * -(-N_IMAGES // BATCH)
    require(launches["normalize"] == batches, f"K1 launched once per batch ({batches})")
    require(launches["avg_pool_3x3_s1_p1"] == 9 * batches, f"K2 launched 9x per batch ({9 * batches})")
    require(launches["epilogue_matmul"] == 30, "K3 launched once per Newton–Schulz step (30)")
    fid_ns_pallas = read_fid(saved)

    # --- the same stages timed one by one; the scipy run reads their stats ---
    extractor = fid.make_pool3_extractor(state_dict, "cuda")
    stage, acts = {}, {}
    for side in ("a", "b"):
        t0 = time.perf_counter()
        acts[side] = extractor.run(ImageFolderLoader.from_dir(d[side], BATCH, fid.IMAGE_SIZE), keys=("pool3",))["pool3"]
        stage[f"extract_{side}"] = time.perf_counter() - t0
        require(acts[side].shape == (N_IMAGES, 2048) and np.isfinite(acts[side]).all(), f"pool3 of {side}")
    t0 = time.perf_counter()
    (m1, s1), (m2, s2) = stats.exact_stats(acts["a"]), stats.exact_stats(acts["b"])
    stage["stats"] = time.perf_counter() - t0
    npz_a, npz_b = os.path.join(SCRATCH, "a.npz"), os.path.join(SCRATCH, "b.npz")
    result_io.save_stats_npz(npz_a, m1, s1)
    result_io.save_stats_npz(npz_b, m2, s2)
    saved = os.path.join(SCRATCH, "fid_scipy.txt")
    t0 = time.perf_counter()
    fid.main(["--path1", npz_a, "--path2", npz_b, "--sqrtm", "scipy", "--saved_file", saved])
    stage["frechet_scipy_cli"] = time.perf_counter() - t0
    fid_scipy = result_io.read_fid_result(saved)
    values = {}
    for method in ("ns-pallas", "ns", "eigh"):
        t0 = time.perf_counter()
        values[method] = sqrtm.frechet_distance(m1, s1, m2, s2, method=method, device="cuda")
        torch.cuda.synchronize()
        stage[f"frechet_{method}"] = time.perf_counter() - t0
    img_s = 2 * N_IMAGES / (stage["extract_a"] + stage["extract_b"])
    log("[stages] " + ", ".join(f"{k} {v:.3f} s" for k, v in stage.items()) + f"; extraction {img_s:.1f} images/s")
    # where the extraction time goes: the host loader alone, the device forward alone
    files = list_images(d["a"])[:40 * BATCH]
    t0 = time.perf_counter()
    for batch in ImageFolderLoader(files, BATCH, fid.IMAGE_SIZE):
        pass
    host_img_s = len(files) / (time.perf_counter() - t0)
    x = torch.from_numpy(batch.images).cuda()
    fwd_ms = median_ms(lambda: extractor.apply_fn(normalize_kernel(x, "fid")), reps=5, inner=4, warmup=2)
    log(f"[time] host loader alone (decode + PIL resize) {host_img_s:.1f} images/s; device forward (K1 + f32 trunk "
        f"to pool3) {fwd_ms:.2f} ms per batch of {BATCH}, {BATCH * 1e3 / fwd_ms:.1f} images/s")
    for side, s in (("a", s1), ("b", s2)):
        w = np.linalg.eigvalsh(s)
        log(f"[stats] sigma_{side}: {int((np.diag(s) == 0).sum())} zero-variance features; eigenvalues "
            f"{w.min():.3e}..{w.max():.3e}, condition {w.max() / w.min():.3e}")
        require(w.min() > 0, f"sigma_{side} has full rank")
    trace_scale = float(np.trace(s1) + np.trace(s2))
    gap = abs(fid_ns_pallas - fid_scipy)
    log(f"[fid] ns-pallas {fid_ns_pallas!r}  scipy {fid_scipy!r}  |gap| {gap:.3e}  relative gap "
        f"{gap / abs(fid_scipy):.3e}  (tr S1 + tr S2 = {trace_scale:.6e}); ns {values['ns']!r}  eigh {values['eigh']!r}")
    require(all(np.isfinite(v) for v in (fid_ns_pallas, fid_scipy, *values.values())), "FID values are finite")
    require(abs(values["ns-pallas"] - fid_ns_pallas) <= 1e-6 * trace_scale, "staged ns-pallas FID vs the CLI's")
    # the f32 Newton–Schulz trace against the float64 Schur square root: the
    # "ns" accuracy class (tise_tpu/ops/sqrtm.py:27-29, up to 4e-3 of the
    # sqrt trace, which is at most half the trace terms)
    require(gap <= 5e-3 * trace_scale, f"ns-pallas vs scipy gap {gap} > 5e-3 x {trace_scale}")
    require(abs(values["ns"] - fid_ns_pallas) <= 1e-4 * trace_scale, "ns-pallas vs ns (both f32 NS)")
    require(abs(values["eigh"] - fid_scipy) <= 1e-5 * trace_scale, "eigh vs scipy (both float64)")

    # --- O-FID on the same engine, a short pass with the 80-class head ---
    saved = os.path.join(SCRATCH, "o_fid.txt")
    before = counts()
    o_fid.main(["--path1", d["crops_a"], "--path2", d["crops_b"], "--weights", d["weights80"], "--sqrtm", "eigh",
                "--batch-size", str(BATCH), "--saved_file", saved])
    with open(saved) as f:
        text = f.read()
    ofid_launches = counts()["avg_pool_3x3_s1_p1"] - before["avg_pool_3x3_s1_p1"]
    log(f"[o-fid] {text} ({N_CROPS} images per side, 80-class weights); K2 launches {ofid_launches}")
    require(text.startswith("O-FID: ") and np.isfinite(result_io.read_fid_result(saved)), "O-FID result")
    require(ofid_launches == 9 * 2 * N_CROPS // BATCH, "O-FID ran through K2")
    return {"launches": launches, "fid": fid_ns_pallas, "rate": rate, "fwd_ms": fwd_ms, "trace_scale": trace_scale}


def path_fid_fast(d: dict, state_dict, f32: dict) -> dict:
    """FID with --precision fast --device-resize-from 64 on the same folders:
    native 64 x 64 uint8 up, K1 at 64 x 64, the device resize, the bf16 folded
    trunk with K2 on its thin fan-out slices, the K3 square root."""
    saved = os.path.join(SCRATCH, "fid_fast.txt")
    reset_counters()
    t0 = time.perf_counter()
    fid.main(["--path1", d["a"], "--path2", d["b"], "--weights", d["weights"], "--sqrtm", "ns-pallas",
              "--batch-size", str(BATCH), "--saved_file", saved, "--precision", "fast",
              "--device-resize-from", str(NATIVE)])
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t0
    launches = counts()
    rate = 2 * N_IMAGES / t_cli
    batches = 2 * -(-N_IMAGES // BATCH)
    require(launches["normalize"] == batches, f"fast path: K1 launched once per batch ({batches})")
    require(launches["avg_pool_3x3_s1_p1"] == 9 * batches, f"fast path: K2 launched 9x per batch ({9 * batches})")
    require(launches["epilogue_matmul"] == 30, "fast path: K3 launched once per Newton–Schulz step (30)")
    require(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
            "--precision fast left TF32 off")
    value = read_fid(saved)
    # bf16 features (8 bits of mantissa) and the device's resize instead of
    # PIL's uint8-rounded one: the distance within 2% of the f32 host-resize one
    rel = abs(value - f32["fid"]) / abs(f32["fid"])
    log(f"[fid fast] CLI {t_cli:.2f} s ({rate:.1f} images/s end to end, f32 host-resize run {f32['rate']:.1f}); "
        f"FID {value!r} vs f32 {f32['fid']!r}: relative difference {rel:.3e}; launches {launches}")
    require(rel <= 2e-2, f"fast FID {value} differs from the f32 one {f32['fid']} by {rel} > 2e-2")
    # where the time goes: the decode-only host loader, the device forward alone
    files = list_images(d["a"])[:40 * BATCH]
    t0 = time.perf_counter()
    for batch in ImageFolderLoader(files, BATCH, NATIVE):
        pass
    host_img_s = len(files) / (time.perf_counter() - t0)
    extractor = fid.make_pool3_extractor(state_dict, "cuda", device_resize_from=NATIVE, fast=True)
    x = torch.from_numpy(batch.images).cuda()
    pre_ms = median_ms(lambda: resize_and_normalize(x, "fid", fid.IMAGE_SIZE), reps=5, inner=4, warmup=2)
    x299 = resize_and_normalize(x, "fid", fid.IMAGE_SIZE)
    fwd_ms = median_ms(lambda: extractor.apply_fn(x299), reps=5, inner=4, warmup=2)
    log(f"[time fast] host loader alone (decode only) {host_img_s:.1f} images/s; K1 + device resize {pre_ms:.3f} ms, "
        f"bf16 trunk to pool3 {fwd_ms:.2f} ms per batch of {BATCH} ({BATCH * 1e3 / (pre_ms + fwd_ms):.1f} images/s; "
        f"f32 forward {f32['fwd_ms']:.2f} ms)")
    return launches


def host_score(logits: np.ndarray, temperature: float, splits: int):
    """(mean, std) of the split scores of a logits matrix in numpy alone:
    f32 logits / T, softmax and split KL in float64."""
    z = logits.astype(np.float32) / np.float32(temperature)
    z = z.astype(np.float64)
    z -= z.max(axis=1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=1, keepdims=True)
    n, scores = len(p), []
    for i in range(splits):
        part = p[i * n // splits:(i + 1) * n // splits]
        marginal = part.mean(axis=0, keepdims=True)
        scores.append(np.exp((part * (np.log(part) - np.log(marginal))).sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def check_score(label: str, got, logits: np.ndarray, temperature: float, decimals=None) -> None:
    """The CLI's (mean, std) against the same logits scored on the host: 1e-6
    relative (the card's f32 softmax against numpy's f64), or the file
    format's rounding where it keeps ``decimals`` places."""
    ref = host_score(logits, temperature, NUM_SPLITS)
    tol = [max(1e-6 * abs(r), 0.0 if decimals is None else 0.51 * 10.0 ** -decimals) for r in ref]
    tol[1] = max(tol[1], 1e-6 * abs(ref[0]))  # the std is a difference of scores near the mean
    log(f"[{label}] (mean, std) {got} vs host numpy {ref}")
    require(np.isfinite(got[0]) and np.isfinite(got[1]) and got[0] >= 1.0, f"{label}: {got}")
    require(abs(got[0] - ref[0]) <= tol[0] and abs(got[1] - ref[1]) <= tol[1], f"{label}: {got} vs host {ref}")


def path_is_star(d: dict) -> dict:
    """IS* COCO (2015-layout weights, tf2015 pools, every image) and IS* CUB
    (slim-layout weights, tf pools, seeded shuffle, tail dropped)."""
    total = {}
    for flavor, folder, weights, n_scored, pools, temperature in (
            ("coco", d["coco"], d["g2015"], N_COCO, 8, IS_STAR_TEMPERATURE_COCO),  # Mixed_7c max-pools
            ("cub", d["cub"], d["slim"], N_CUB // BATCH * BATCH, 9, IS_STAR_TEMPERATURE_CUB)):
        saved = os.path.join(SCRATCH, f"is_star_{flavor}.txt")
        reset_counters()
        t0 = time.perf_counter()
        is_star.main(["--image_folder", folder, "--flavor", flavor, "--weights", weights, "--batch_size", str(BATCH),
                      "--seed", "0", "--saved_file", saved])
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t0
        launches = counts()
        batches = -(-n_scored // BATCH)
        log(f"[is* {flavor}] CLI {t_cli:.2f} s ({n_scored / t_cli:.1f} images/s end to end); launches {launches}")
        require(launches["normalize"] == batches, f"IS* {flavor}: K1 launched once per batch ({batches})")
        require(launches["avg_pool_3x3_s1_p1"] == pools * batches, f"IS* {flavor}: K2 launched {pools}x per batch")
        # the same logits, extracted again in the CLI's file order, scored on the host
        files = list_images(folder)
        if flavor == "cub":
            files = [files[i] for i in np.random.RandomState(0).permutation(len(files))][:n_scored]
        extractor = inception_slim.make_logits_extractor(weights, flavor, "cuda")
        logits = extractor.run(ImageFolderLoader(files, BATCH, fid.IMAGE_SIZE), keys=("logits",))["logits"]
        require(logits.shape == (n_scored, 50 if flavor == "cub" else 1008), f"IS* {flavor} logits {logits.shape}")
        if flavor == "cub":
            with open(saved) as f:
                require(f.read().startswith("IS = "), "IS* CUB result file format")
            check_score("is* cub", result_io.read_is_result(saved), logits, temperature)
        else:
            with open(saved) as f:
                require(f.read().startswith("[Inception Score] mean: "), "IS* COCO result file format")
            check_score("is* coco", result_io.read_is_coco_result(saved), logits, temperature, decimals=5)
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
    fast = is_star_cub_tf32(d, files, logits)
    return {k: total[k] + fast[k] for k in total}


def is_star_cub_tf32(d: dict, files: list, logits: np.ndarray) -> dict:
    """IS* CUB once more with --precision fast: this trunk stays f32 and the
    flag allows TF32 inside the forward only.  The flag must change the
    logits (TF32 rounds the operands of every convolution to 10 bits of
    mantissa, and 94 convolutions of a random calibrated trunk carry that on),
    keep every logit within 5e-2 of the logits' scale and the score within
    1e-2 relative of the ``highest`` run, and leave TF32 off afterwards."""
    saved, saved_fast = (os.path.join(SCRATCH, f"is_star_cub{tag}.txt") for tag in ("", "_tf32"))
    reset_counters()
    t0 = time.perf_counter()
    is_star.main(["--image_folder", d["cub"], "--flavor", "cub", "--weights", d["slim"], "--batch_size", str(BATCH),
                  "--seed", "0", "--saved_file", saved_fast, "--precision", "fast"])
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t0
    launches = counts()
    require(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
            "IS* --precision fast left TF32 off after the run")
    extractor = inception_slim.make_logits_extractor(d["slim"], "cub", "cuda", fast=True)
    logits_fast = extractor.run(ImageFolderLoader(files, BATCH, fid.IMAGE_SIZE), keys=("logits",))["logits"]
    require(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
            "the TF32 forward left TF32 off after the block")
    check_score("is* cub tf32", result_io.read_is_result(saved_fast), logits_fast, IS_STAR_TEMPERATURE_CUB)
    diff, scale = float(np.abs(logits_fast - logits).max()), float(np.abs(logits).max())
    (mean, _), (mean_fast, _) = result_io.read_is_result(saved), result_io.read_is_result(saved_fast)
    rel = abs(mean_fast - mean) / mean
    rms = float(np.sqrt(np.mean((logits_fast - logits).astype(np.float64) ** 2)))
    log(f"[is* cub tf32] CLI {t_cli:.2f} s ({len(files) / t_cli:.1f} images/s end to end); logits differ from the "
        f"highest run by at most {diff:.3e}, rms {rms:.3e} (scale {scale:.3f}); score {mean_fast!r} vs {mean!r}: relative {rel:.3e}")
    require(diff > 0.0, "--precision fast changed nothing in the IS* forward: TF32 was not on inside it")
    require(diff <= 5e-2 * scale and rel <= 1e-2, f"IS* TF32 run too far from highest: logits {diff}, score {rel}")
    require(launches["normalize"] == len(files) // BATCH, "IS* tf32: K1 launched once per batch")
    return launches


def path_o_is(d: dict) -> dict:
    """O-IS over the crops folder: 80-class head, recipe "half", batch 32."""
    saved = os.path.join(SCRATCH, "o_is.txt")
    reset_counters()
    o_is.main(["--image_dir", d["crops_a"], "--weights", d["weights80"], "--saved_file", saved])
    torch.cuda.synchronize()
    launches = counts()
    batches = -(-N_CROPS // 32)
    log(f"[o-is] launches {launches}")
    require(launches["normalize"] == batches and launches["avg_pool_3x3_s1_p1"] == 9 * batches,
            f"O-IS: K1 once and K2 9x per batch of 32 ({batches} batches)")
    extractor = o_is.make_logits_extractor(fid.load_weights(d["weights80"], "weights"), "cuda")
    logits = extractor.run(ImageFolderLoader.from_dir(d["crops_a"], 32, fid.IMAGE_SIZE), keys=("logits",))["logits"]
    require(logits.shape == (N_CROPS, 80), f"O-IS logits {logits.shape}")
    with open(saved) as f:
        require(f.read().startswith("O-IS: "), "O-IS result file format")
    check_score("o-is", result_io.read_o_is_result(saved), logits, O_IS_TEMPERATURE)
    return launches


def path_probes() -> dict:
    """The two probe entry points, as a user runs them."""
    reset_counters()
    require(mosaic_probe.main([]) == 0, "mosaic_probe reported a FAIL")
    require(stem_mm_probe.main([]) == 0, "stem_mm_probe failed")
    torch.cuda.synchronize()
    launches = counts()
    log(f"[probes] launches {launches}")
    for name in mosaic_probe.PROBES:
        require(launches[name] == 1, f"probe {name} launched once")
    require(launches["stem_mm"] >= len(stem_mm_probe.SHAPES), "P6 launched at every shape")
    return launches


def main() -> None:
    t_start = time.perf_counter()
    smi = setup()
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {
        "normalize": check_normalize(gen),
        "avg_pool_3x3_s1_p1": check_avg_pool(gen),
        "epilogue_matmul": check_epilogue_matmul(gen),
        **check_layout_probes(),
        "stem_mm": check_stem_mm(),
    }
    d = make_data()
    state_dict = fid.load_weights(d["weights"], "weights")
    check_trunks_against_cpu(state_dict)
    f32 = path_fid_f32(d, state_dict)
    per_path = [f32["launches"], path_fid_fast(d, state_dict, f32), path_is_star(d), path_o_is(d), path_probes()]
    shutil.rmtree(SCRATCH)
    kernels = []
    for name, (_, route, source, replaces) in KERNELS.items():
        launches = sum(p[name] for p in per_path)
        require(launches > 0, f"no main path launched {name}")
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": launches, **results[name]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
