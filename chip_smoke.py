#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tise_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

It builds the port's hand-written kernels from the sources in this checkout
(nvcc for csrc/*.cu, Triton for the normalize kernel), holds each kernel
against its plain PyTorch version on the card at the shapes the FID path
gives it, then drives the FID slice through its CLI
(``tise_tpu_torch.metrics.fid.main``) on two seeded folders of 20,480 PNGs
each with random seeded InceptionV3 weights (BatchNorm statistics calibrated
on seeded images), with ``--sqrtm ns-pallas``, and again from the two
folders' statistics with ``--sqrtm scipy``, and a short O-FID pass through
the same engine.  Launch counters show that the main path ran every kernel.

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

from tise_tpu_torch.backbones.inception_v3 import BasicConv2d, InceptionV3, random_state_dict
from tise_tpu_torch.core import io as result_io
from tise_tpu_torch.core.config import configure_precision
from tise_tpu_torch.core.data import ImageFolderLoader, list_images
from tise_tpu_torch.metrics import fid, o_fid
from tise_tpu_torch.ops import native, sqrtm, stats
from tise_tpu_torch.ops.fast_pool import avg_pool_kernel, avg_pool_plain
from tise_tpu_torch.ops.pallas_kernels import (epilogue_matmul_kernel, epilogue_matmul_plain,
                                               newton_schulz_sqrtm_pallas)
from tise_tpu_torch.ops.preprocess import RECIPES, normalize_kernel, normalize_plain

ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(ROOT, "build", "chip_smoke")
# per side: ten times the 2048 features, so each sample covariance keeps
# its smallest eigenvalues within about half of the population's
# (Marchenko–Pastur) and f32 Newton–Schulz converges on it
N_IMAGES = 20480
BATCH = 64
POOL_SHAPES = [  # (shape, launches per batch): the pool branches of Mixed_5b-d, 6b-e, 7b-c at 299 px
    ((BATCH, 35, 35, 192), 1), ((BATCH, 35, 35, 256), 1), ((BATCH, 35, 35, 288), 1),
    ((BATCH, 17, 17, 768), 4), ((BATCH, 8, 8, 1280), 1), ((BATCH, 8, 8, 2048), 1),
]
EDGE_POOL_SHAPES = [(2, 1, 1, 2048), (2, 1, 5, 8), (2, 5, 1, 8)]
KERNELS = {  # name -> (launch counter owner, route, source, TPU kernel it replaces)
    "normalize": (normalize_kernel, "triton", "tise_tpu_torch/ops/preprocess.py",
                  "tise_tpu/ops/preprocess.py:82"),
    "avg_pool_3x3_s1_p1": (avg_pool_kernel, "cuda", "tise_tpu_torch/csrc/avg_pool3x3.cu",
                           "tise_tpu/ops/fast_pool.py:49"),
    "epilogue_matmul": (epilogue_matmul_kernel, "cuda", "tise_tpu_torch/csrc/epilogue_matmul.cu",
                        "tise_tpu/ops/pallas_kernels.py:32"),
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
    max_err = 0.0
    for recipe in sorted(RECIPES):
        for dtype, max_ulp in ((torch.float32, 1), (torch.bfloat16, 1)):
            got, ref = normalize_kernel(u8, recipe, dtype), normalize_plain(u8, recipe, dtype)
            torch.cuda.synchronize()
            require(got.shape == ref.shape and got.dtype == ref.dtype, f"normalize {recipe} shape/dtype")
            ulps = ulp_distance(got, ref)
            err = float((got.float() - ref.float()).abs().max())
            log(f"[K1 normalize] {recipe:13s} {str(dtype):15s} max_abs_err {err:.3e} max_ulp {ulps}")
            require(ulps <= max_ulp, f"normalize {recipe} {dtype}: {ulps} ulp > {max_ulp}")
            if dtype == torch.float32:
                max_err = max(max_err, err)
    ms = median_ms(lambda: normalize_kernel(u8, "fid"))
    plain_ms = median_ms(lambda: normalize_plain(u8, "fid"))
    log(f"[K1 normalize] fid f32 {list(u8.shape)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def check_avg_pool(gen: torch.Generator) -> dict:
    max_err, ms, plain_ms = 0.0, 0.0, 0.0
    for shape, per_batch in POOL_SHAPES + [(s, 0) for s in EDGE_POOL_SHAPES]:
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
        if per_batch:
            k = median_ms(lambda: avg_pool_kernel(x, True))
            p = median_ms(lambda: avg_pool_plain(x, True))
            log(f"[K2 avg_pool] {str(shape):22s} f32: kernel {k:.4f} ms, plain {p:.4f} ms (x{per_batch} per batch)")
            ms += per_batch * k
            plain_ms += per_batch * p
    log(f"[K2 avg_pool] the nine pools of one batch of {BATCH}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


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
        gflops = 2 * n ** 3 / ms / 1e6
        log(f"[K3 epilogue_matmul] n={n}: max_abs_err {err:.3e} (scale {scale:.1f}); kernel {ms:.4f} ms "
            f"({gflops:.0f} GFLOP/s), plain {plain_ms:.4f} ms")
        if n == 2048:
            out = {"ms": ms, "plain_ms": plain_ms}
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


# ---------------------------------------------------------------------------
# 3. the main path: FID through the CLI, then O-FID
# ---------------------------------------------------------------------------


def noise_images(n: int, seed: int, lo: int) -> np.ndarray:
    """n seeded 64x64 RGB images of uniform pixel noise in [lo, 255 - lo]."""
    return np.random.RandomState(seed).randint(lo, 256 - lo, (n, 64, 64, 3)).astype(np.uint8)


def write_folder(root: str, images: np.ndarray) -> str:
    """One PNG per image; the loader PIL-resizes them to 299, the
    reference's host-resize path."""
    os.makedirs(root, exist_ok=True)
    from PIL import Image

    def save(i):
        Image.fromarray(images[i]).save(os.path.join(root, f"{i:05d}.png"))

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(save, range(len(images))))
    return root


def calibrated_weights(path: str, seed: int, num_classes: int, images: np.ndarray) -> str:
    """``random_state_dict(seed)`` with every BatchNorm's running mean and
    variance set to the statistics of its convolution's output on
    ``images`` (a data-dependent init), saved as a torchvision .pth.

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
        model(normalize_kernel(torch.from_numpy(x).cuda(), "fid"))
    for h in hooks:
        h.remove()
    torch.save({k: v.cpu().contiguous() for k, v in model.state_dict().items()}, path)
    return path


def check_trunk_against_cpu(state_dict) -> None:
    """The trunk on the card (K1, K2, cuDNN with TF32 off) against the same
    trunk on the CPU (plain versions) on 4 images: pool3 within rtol 1e-4,
    atol 1e-4 of its scale (tests/test_inception.py's tolerance)."""
    u8 = torch.from_numpy(np.random.RandomState(7).randint(0, 256, (4, 299, 299, 3)).astype(np.uint8))
    gpu = fid.make_pool3_extractor(state_dict, "cuda")(u8.numpy())["pool3"].cpu()
    cpu = fid.make_pool3_extractor(state_dict, "cpu")(u8.numpy())["pool3"]
    err = float((gpu - cpu).abs().max())
    scale = float(cpu.abs().max())
    log(f"[trunk] pool3 card vs CPU on 4 images: max_abs_err {err:.3e} (scale {scale:.3f})")
    require(bool(torch.isfinite(gpu).all()), "pool3 is finite")
    require(torch.allclose(gpu, cpu, rtol=1e-4, atol=1e-4 * scale), f"pool3 card vs CPU: {err}")


def main_path() -> dict:
    shutil.rmtree(SCRATCH, ignore_errors=True)
    t0 = time.perf_counter()
    # side a: full-range noise; side b: noise at lower contrast
    dir_a = write_folder(os.path.join(SCRATCH, "a"), noise_images(N_IMAGES, seed=1, lo=0))
    dir_b = write_folder(os.path.join(SCRATCH, "b"), noise_images(N_IMAGES, seed=2, lo=48))
    calibration = np.concatenate([noise_images(128, seed=11, lo=0), noise_images(128, seed=12, lo=48)])
    weights = calibrated_weights(os.path.join(SCRATCH, "inception.pth"), 0, 1000, calibration)
    log(f"[data] 2 x {N_IMAGES} PNGs and calibrated weights in {time.perf_counter() - t0:.1f} s")
    state_dict = fid.load_weights(weights, "weights")
    check_trunk_against_cpu(state_dict)

    # --- the main path, counted: FID with the K3 square root ---
    saved = os.path.join(SCRATCH, "fid_ns_pallas.txt")
    reset_counters()
    t0 = time.perf_counter()
    fid.main(["--path1", dir_a, "--path2", dir_b, "--weights", weights, "--sqrtm", "ns-pallas",
              "--batch-size", str(BATCH), "--saved_file", saved])
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t0
    launches = counts()
    log(f"[fid ns-pallas] CLI {t_cli:.2f} s ({2 * N_IMAGES / t_cli:.1f} images/s end to end); launches {launches}")
    batches = 2 * -(-N_IMAGES // BATCH)
    require(launches["normalize"] == batches, f"K1 launched once per batch ({batches})")
    require(launches["avg_pool_3x3_s1_p1"] == 9 * batches, f"K2 launched 9x per batch ({9 * batches})")
    require(launches["epilogue_matmul"] == 30, "K3 launched once per Newton–Schulz step (30)")
    with open(saved) as f:
        text = f.read()
    require(text.startswith("FID: "), f"result file format: {text!r}")
    fid_ns_pallas = float(text[len("FID: "):])
    require(np.isfinite(fid_ns_pallas), f"--sqrtm ns-pallas wrote {text!r}")

    # --- the same stages timed one by one; the scipy run reads their stats ---
    extractor = fid.make_pool3_extractor(state_dict, "cuda")
    stage, acts = {}, {}
    for side, d in (("a", dir_a), ("b", dir_b)):
        t0 = time.perf_counter()
        acts[side] = extractor.run(ImageFolderLoader.from_dir(d, BATCH, fid.IMAGE_SIZE), keys=("pool3",))["pool3"]
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
    files = list_images(dir_a)[:40 * BATCH]
    t0 = time.perf_counter()
    for batch in ImageFolderLoader(files, BATCH, fid.IMAGE_SIZE):
        pass
    host_img_s = len(files) / (time.perf_counter() - t0)
    x = torch.from_numpy(batch.images).cuda()
    fwd_ms = median_ms(lambda: extractor.apply_fn(normalize_kernel(x, "fid")), reps=5, inner=4, warmup=2)
    log(f"[time] host loader alone {host_img_s:.1f} images/s; device forward (K1 + trunk to pool3) "
        f"{fwd_ms:.2f} ms per batch of {BATCH}, {BATCH * 1e3 / fwd_ms:.1f} images/s")
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
    n_small = 4 * BATCH
    small_a = write_folder(os.path.join(SCRATCH, "oa"), noise_images(n_small, seed=3, lo=0))
    small_b = write_folder(os.path.join(SCRATCH, "ob"), noise_images(n_small, seed=4, lo=48))
    w80 = os.path.join(SCRATCH, "inception80.pth")
    torch.save({k: torch.from_numpy(v) for k, v in random_state_dict(1, 80).items()}, w80)
    saved = os.path.join(SCRATCH, "o_fid.txt")
    before = counts()
    o_fid.main(["--path1", small_a, "--path2", small_b, "--weights", w80, "--sqrtm", "eigh",
                "--batch-size", str(BATCH), "--saved_file", saved])
    with open(saved) as f:
        text = f.read()
    ofid_launches = counts()["avg_pool_3x3_s1_p1"] - before["avg_pool_3x3_s1_p1"]
    log(f"[o-fid] {text} ({n_small} images per side, 80-class weights); K2 launches {ofid_launches}")
    require(text.startswith("O-FID: ") and np.isfinite(result_io.read_fid_result(saved)), "O-FID result")
    require(ofid_launches == 9 * 2 * n_small // BATCH, "O-FID ran through K2")
    shutil.rmtree(SCRATCH)
    return launches


def main() -> None:
    t_start = time.perf_counter()
    smi = setup()
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {
        "normalize": check_normalize(gen),
        "avg_pool_3x3_s1_p1": check_avg_pool(gen),
        "epilogue_matmul": check_epilogue_matmul(gen),
    }
    launches = main_path()
    kernels = []
    for name, (_, route, source, replaces) in KERNELS.items():
        r = results[name]
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
