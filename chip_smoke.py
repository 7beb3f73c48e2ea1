#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tise_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

It builds the port's hand-written kernels from the sources in this checkout
(nvcc for csrc/*.cu, all in parallel), holds
each of the nine kernels against its plain PyTorch version on the card at the
shapes the main paths give it, then drives every main path through the entry
point a user would call, at the full width of InceptionV3 at 299 x 299 with
seeded random weights (BatchNorm statistics calibrated on seeded images) and
of CLIP ViT-B/32 at 224 x 224:

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
  * the two probe entry points (``tools.mosaic_probe``, ``tools.stem_mm_probe``);
  * RP-COCO (``metrics.rp_coco.main``) and PA (``metrics.pa.main``) at the
    full width of CLIP ViT-B/32 with seeded random weights, a merge table the
    script writes and synthetic captions: RP on 2,048 items of 100 captions
    with the text bank in ``--precision highest`` and ``fast``, and on the
    first 256 with ``--no-dedup-text`` (the same success bits); PA on 4
    phrases x 256 items, held to the PA recomputed on the host from the same
    logits; then the scorers themselves (fast against highest, the bank
    against the direct path, the card's logits against the CPU's);
  * the CUB track at the full width of the DAMSM encoders (a vocabulary of
    5,450 words, embedding 300, 2 x 128 LSTM units, InceptionV3 at 299, nef
    256) with seeded weights written as the reference's ``.pth`` files: the
    card's cnn_code and sent_emb against the CPU's on one batch; RP-CUB
    (``metrics.rp_cub.main``) on 2,048 items of 100 captions over 256 x 256
    PNGs in ``highest`` and ``fast``, each result file held to the bins
    recomputed here from its per-item successes, and a run that fails partway
    resumed from its snapshot to the same bytes; then the track runner
    (``benchmark.main(["--track", "cub", ...])``) over the reference's layout,
    each value held to its CLI run on the same inputs, and its ``--resume``;
  * the detection stack at the full width of Faster R-CNN R50-FPN (800 x
    800, 1,000 proposals, ROIAlign sampling 2, 80 classes) with seeded
    detectron2-layout weights whose classifier is calibrated on seeded
    256 x 256 PNGs of blobs on noise: the card's FPN maps and detections
    against the CPU's on 4 images; SOA (``metrics.soa.main``) over 80
    label folders of 4 images, its result file held to SOA recomputed here
    from its pickles, a run that fails after 10 labels resumed to the same
    bytes, and the fast preset (bf16, sampling 1, 256 proposals) on the same
    layout; ``metrics.crop_objects.main`` on 256 images (512-4,096 crops,
    one a valid box), a run killed after its first slab resumed to the same
    files; then the crops through O-IS and O-FID, with K1 and K2 counted;
    the stages of a batch timed by events, NCHW against channels last;
  * the counter at its full width (ResNet-50 at 448 x 448, 240 maps, batch
    32) with seeded CountSeg-layout weights whose classifier is calibrated
    on the card's res5 features of 32 seeded 256 x 256 PNGs of blobs on
    noise: the card against the CPU on 4 images; CA (``metrics.ca.main``)
    on 1,024 items of 1-3 classes with counts 1-5 in ``highest`` (its
    result held to CA recomputed here from its counts, which must take at
    least 3 values with the gate open and shut) and ``fast`` (counts equal
    to highest's on at least 99% of the items), and a run killed after its
    first snapshot resumed to the same bytes; the forward, peak stimulation
    and host decode at 448 timed;
  * the COCO track runner (``benchmark.main(["--track", "coco", ...])``)
    over the reference's layout built from the earlier phases' data and
    weights (256 images): all nine stages, the methods JSON and the RS table
    with the 11 published methods; a ``--resume`` that parses every stage;
    and a ``--resume`` without ``crop.done``, in which crop, O-IS and O-FID
    run again.

Launch counters, set to 0 before each path and read after it, show that each
path ran its kernels.  K1 is held to its plain version bit for bit in every
recipe, f32 and bf16, at the four main-path shapes (299, 64, CLIP's 224 and
CA's 448 px), a ragged size and an unaligned view, and under ``half`` at
RP-CUB's [32, 256, 256, 3]; at those shapes (CLIP's in f32 and bf16, CA's
under ``imagenet``) it prints its time by events, by the host's clock and on
the device (a reading it requires; CA's read cold) beside its bytes bound and
its library call, ``torch.addcmul``.  The launch floor, the device time of P3's kernel on an
f32 [1, 2] input, is printed beside K1's and the probes' device times.  K2 is held to its
plain version bit for bit at every shape of the main paths, at 1-wide edge
shapes and at ragged ones, which between them reach each of its instances;
each trunk and thin shape prints its time against its bytes bound.  For the five layout probes and their
library calls it also prints the host's time per call (a host clock around
1,000 calls with no synchronise inside) beside the event time; the kernels'
own durations from ``torch.profiler`` (K2's shapes and sets, K1, the probes
beside their library calls) come last, after every other timing, so that a
reader can tell the host's share from the device's.

Output: one line per check, the card's name and power limit as nvidia-smi
gives them, a ``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
with no result line; so does a machine with no CUDA card.  Scratch files go
under build/chip_smoke/ and are removed at the end.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tise_tpu_torch import benchmark
from tise_tpu_torch.backbones import clip_vit, counter, damsm, inception_slim
from tise_tpu_torch.backbones.clip_tokenizer import SimpleTokenizer
from tise_tpu_torch.backbones.detection import predictor, rcnn
from tise_tpu_torch.backbones.detection import weights as det_weights
from tise_tpu_torch.backbones.detection.coco_classes import COCO_CLASSES
from tise_tpu_torch.backbones.inception_v3 import BasicConv2d, InceptionV3, random_state_dict
from tise_tpu_torch.core import io as result_io
from tise_tpu_torch.core.config import (IS_STAR_TEMPERATURE_COCO, IS_STAR_TEMPERATURE_CUB, NUM_SPLITS,
                                        O_IS_TEMPERATURE, PA_SUCCESS_THRESHOLD, configure_precision,
                                        tf32_forward)
from tise_tpu_torch.core.data import BICUBIC, ImageFolderLoader, center_crop_resize, list_images, load_image
from tise_tpu_torch.metrics import ca, crop_objects, fid, is_star, o_fid, o_is, pa, rp_coco, rp_cub, soa
from tise_tpu_torch.metrics.clip_scorer import ClipPairScorer
from tise_tpu_torch.ops import fast_pool, native, sqrtm, stats
from tise_tpu_torch.ranking import ranking_score
from tise_tpu_torch.ops.fast_pool import avg_pool_kernel, avg_pool_plain
from tise_tpu_torch.ops.pallas_kernels import (KERNEL_INSTANCES, epilogue_matmul_instance, epilogue_matmul_kernel,
                                               epilogue_matmul_plain, newton_schulz_sqrtm_pallas)
from tise_tpu_torch.ops.preprocess import RECIPES, normalize_kernel, normalize_plain, resize_and_normalize
from tise_tpu_torch.tools import mosaic_probe, stem_mm_probe
from tise_tpu_torch.tools.kernel_compare import (POOL_SHAPES, PROFILE_TRIES, STEM_NSTEPS, THIN_POOL_SHAPES, device_us,
                                                 host_us)


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
CUB_BATCH = 32       # rp_cub's default batch: the DAMSM trunk pools at this batch
NATIVE = 64        # side of the PNGs on disk
CLIP_SIZE = 224    # CLIP's input side
CA_SIZE = 448      # the counter's input side
EDGE_POOL_SHAPES = [(2, 1, 1, 2048), (2, 1, 5, 8), (2, 5, 1, 8)]
# C not a multiple of 8 (bf16 scalar instance), C not a multiple of 4 (f32 scalar), rows cut into column chunks
RAGGED_POOL_SHAPES = [(2, 17, 17, 36), (2, 6, 300, 30), (2, 5, 300, 64)]
# the trunk's six pool shapes at RP-CUB's batch, which the geometry cuts otherwise than at 64
DAMSM_POOL_SHAPES = [(CUB_BATCH, *shape[1:]) for shape, _ in POOL_SHAPES]
# published peaks of one H100 SXM (NVIDIA's data sheet): device memory, f32
# outside the tensor cores, dense bf16 in them
PEAK_BYTES_S, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
_PROBE_SRC = "tise_tpu_torch/csrc/layout_probes.cu"
KERNELS = {  # name -> (launch counter owner, route, source, TPU kernel it replaces)
    "normalize": (normalize_kernel, "cuda", "tise_tpu_torch/csrc/normalize.cu", "tise_tpu/ops/preprocess.py:82"),
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
            if "registers" in line or "spill" in line or "Compiling entry function" in line:
                log(f"[build] {name}: {line.strip()}")
    return smi


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------


def normalize_inputs(gen: torch.Generator) -> dict:
    """K1's inputs: the four main-path shapes (a batch at 299, the
    device-resize path's native 64 x 64, CLIP's 224 x 224 and CA's batch of
    32 at 448 x 448), a ragged size
    (n not a multiple of 48 or of a block's 6,144 elements) and an unaligned
    view of it."""
    u8 = torch.randint(0, 256, (BATCH, 299, 299, 3), generator=gen, device="cuda", dtype=torch.uint8)
    ragged = (2, 37, 61, 3)
    flat = torch.randint(0, 256, (torch.Size(ragged).numel() + 1,), generator=gen, device="cuda", dtype=torch.uint8)
    ca_u8 = torch.randint(0, 256, (CA_BATCH, CA_SIZE, CA_SIZE, 3), generator=gen, device="cuda", dtype=torch.uint8)
    return {"299 px": u8, f"{NATIVE} px": u8[:, :NATIVE, :NATIVE].contiguous(),
            f"{CLIP_SIZE} px": u8[:, :CLIP_SIZE, :CLIP_SIZE].contiguous(), f"{CA_SIZE} px": ca_u8,
            "ragged": flat[:-1].view(ragged), "unaligned": flat[1:].view(ragged)}


def normalize_library_call(recipe: str = "fid", dtype: torch.dtype = torch.float32):
    """The one PyTorch call that computes K1's function in ``dtype``:
    ``torch.addcmul(shift, x, scale)`` promotes the uint8 input and
    broadcasts the three channels' constants over the last dimension.  It
    fuses the multiply and the add, so it agrees with K1 to an ulp, not bit
    for bit.  Timed here only; the port never calls it."""
    scale, shift = (torch.tensor(c, dtype=dtype, device="cuda") for c in RECIPES[recipe])
    return lambda x: torch.addcmul(shift, x, scale)


#: K1's timed cases: (input label, recipe, output dtype)
NORMALIZE_TIMED = [("299 px", "fid", torch.float32), (f"{NATIVE} px", "fid", torch.float32),
                   (f"{CLIP_SIZE} px", "clip", torch.float32), (f"{CLIP_SIZE} px", "clip", torch.bfloat16),
                   (f"{CA_SIZE} px", "imagenet", torch.float32)]


def normalize_bytes(x: torch.Tensor, dtype: torch.dtype) -> int:
    """One uint8 read and one output write per element."""
    return x.numel() * (1 + torch.empty((), dtype=dtype).element_size())


def check_normalize(gen: torch.Generator) -> dict:
    """K1 bit for bit (``torch.equal``) against its plain version in every
    recipe, f32 and bf16, on normalize_inputs; then, in each case of
    NORMALIZE_TIMED, its time by events and the host's time a call beside the
    bytes bound and its library call (its device time:
    normalize_device_times)."""
    xs = normalize_inputs(gen)
    require(xs["unaligned"].data_ptr() % 4 != 0 and xs["ragged"].numel() % 48 != 0, "K1's edge inputs")
    max_err = 0.0
    for label, x in xs.items():
        for recipe in sorted(RECIPES):
            for dtype in (torch.float32, torch.bfloat16):
                got, ref = normalize_kernel(x, recipe, dtype), normalize_plain(x, recipe, dtype)
                torch.cuda.synchronize()
                require(got.shape == ref.shape and got.dtype == ref.dtype, f"normalize {recipe} shape/dtype")
                err = float((got.float() - ref.float()).abs().max())
                require(torch.equal(got, ref), f"normalize {label} {recipe} {dtype}: max_abs_err {err}")
                if dtype == torch.float32:
                    max_err = max(max_err, err)
        log(f"[K1 normalize] {label} {list(x.shape)}: torch.equal to the plain version in all {len(RECIPES)} recipes, "
            f"f32 and bf16")
    out = {}
    for label, recipe, dtype in NORMALIZE_TIMED:
        x, library = xs[label], normalize_library_call(recipe, dtype)
        ref = normalize_plain(x, recipe, dtype).float()
        lib_err = float((library(x).float() - ref).abs().max())
        # each rounds the product v*scale and the sum at most once: half an ulp of each, eps * |value| bounds an ulp
        tol = torch.finfo(dtype).eps * (255 * max(map(abs, RECIPES[recipe][0])) + float(ref.abs().max()))
        require(lib_err <= tol, f"torch.addcmul differs from K1's plain version by {lib_err} > {tol} at {label} {dtype}")
        ms = median_ms(lambda: normalize_kernel(x, recipe, dtype))
        plain_ms = median_ms(lambda: normalize_plain(x, recipe, dtype))
        library_ms = median_ms(lambda: library(x))
        enqueue, drained = host_us(lambda: normalize_kernel(x, recipe, dtype))
        lib_enqueue, _ = host_us(lambda: library(x))
        nbytes = normalize_bytes(x, dtype)
        least = bound(nbytes)
        log(f"[K1 normalize] {recipe} {str(dtype)[6:]} {list(x.shape)}: events {ms:.4f} ms, host {enqueue:.2f} us a call "
            f"({drained:.2f} us with the queue drained), plain {plain_ms:.4f} ms, torch.addcmul {library_ms:.4f} ms "
            f"(host {lib_enqueue:.2f} us a call, max_abs_err {lib_err:.3e} to plain); bound {least['bound_ms']:.5f} ms "
            f"({nbytes / 1e6:.2f} MB)")
        if label == "299 px":
            out = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **least}
    return out


def check_avg_pool(gen: torch.Generator) -> dict:
    """K2 bit for bit (``torch.equal``) against its plain version in f32 and
    bf16, both count modes, at every shape of the main paths (the trunk's at
    batch 64 and at the DAMSM trunk's 32, the thin ones), the 1-wide edge
    shapes and the ragged ones, which between them reach every instance the
    wrapper chooses, each with the cut it chose; then each trunk, thin and
    DAMSM shape timed by events against its bytes bound, and the nine pools
    of a batch, the nine thin ones and the nine of a DAMSM batch as sums
    (their device times: pool_device_times)."""
    max_err, ms, plain_ms, library_ms, nbytes = 0.0, 0.0, 0.0, 0.0, 0
    thin = {"kernel": 0.0, "plain": 0.0, "bytes": 0}
    seen = set()
    damsm = {"kernel": 0.0, "bytes": 0}
    shapes = ([(s, n, "trunk") for s, n in POOL_SHAPES] + [(s, n, "thin") for s, n in THIN_POOL_SHAPES]
              + [(s, n, "damsm") for s, (_, n) in zip(DAMSM_POOL_SHAPES, POOL_SHAPES)])
    for shape, per_batch, kind in shapes + [(s, 0, "edge") for s in EDGE_POOL_SHAPES + RAGGED_POOL_SHAPES]:
        x = torch.randn(shape, generator=gen, device="cuda")
        for include_pad in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                xi = x.to(dtype)
                got, ref = avg_pool_kernel(xi, include_pad), avg_pool_plain(xi, include_pad)
                torch.cuda.synchronize()
                g = fast_pool.pool_geometry(shape, dtype, xi.data_ptr() % 16 == 0)
                seen.add(g.instance)
                require(got.dtype == dtype and got.shape == ref.shape, f"pool {shape} dtype/shape")
                err = float((got.float() - ref.float()).abs().max())
                log(f"[K2 avg_pool] {str(shape):22s} include_pad={include_pad!s:5s} {str(dtype):15s} {g.instance:7s} "
                    f"slice {g.cvb} vectors, bands of {g.band_h} rows, grid {g.grid}: max_abs_err {err:.3e}")
                require(torch.equal(got, ref), f"pool {shape} pad={include_pad} {dtype} ({g.instance}): {err}")
                if dtype == torch.float32:
                    max_err = max(max_err, err)
        if kind == "edge":
            continue
        k = median_ms(lambda: avg_pool_kernel(x, True))
        least = bound(2 * x.numel() * 4)["bound_ms"]
        g = fast_pool.pool_geometry(shape, torch.float32)
        where = (f"{g.instance}, slice {g.cvb} vectors, bands of {g.band_h} rows, grid {g.grid}, {g.threads} threads; "
                 f"kernel {k:.4f} ms, bound {least:.4f} ms ({least / k:.1%} of it)")
        if kind == "damsm":
            log(f"[K2 avg_pool] damsm {str(shape):22s} f32: {where} (x{per_batch} per RP-CUB batch)")
            damsm["kernel"] += per_batch * k
            damsm["bytes"] += per_batch * 2 * x.numel() * 4
            continue
        p = median_ms(lambda: avg_pool_plain(x, True))
        where += f", plain {p:.4f} ms"
        if kind == "thin":
            log(f"[K2 avg_pool] thin {str(shape):22s} f32: {where} (x{per_batch} per batch)")
            thin["kernel"] += per_batch * k
            thin["plain"] += per_batch * p
            thin["bytes"] += per_batch * 2 * x.numel() * 4
            continue
        nchw = x.permute(0, 3, 1, 2)  # channels_last view of the same memory
        lib = median_ms(lambda: torch.nn.functional.avg_pool2d(nchw, 3, 1, 1))
        # F.avg_pool2d divides once by 9 where K2 multiplies twice by 1/3: the same function to f32 rounding
        require(torch.allclose(torch.nn.functional.avg_pool2d(nchw, 3, 1, 1).permute(0, 2, 3, 1),
                               avg_pool_kernel(x, True), rtol=1e-5, atol=1e-6), f"pool {shape} vs F.avg_pool2d")
        log(f"[K2 avg_pool] {str(shape):22s} f32: {where}, F.avg_pool2d {lib:.4f} ms (x{per_batch} per batch)")
        ms += per_batch * k
        plain_ms += per_batch * p
        library_ms += per_batch * lib
        nbytes += per_batch * 2 * x.numel() * 4
    require(seen == set(fast_pool.KERNEL_INSTANCES),
            f"the shapes reached only {sorted(seen)} of K2's instances {fast_pool.KERNEL_INSTANCES}")
    least, thin_least = bound(nbytes)["bound_ms"], bound(thin["bytes"])["bound_ms"]
    log(f"[K2 avg_pool] the nine pools of one f32 batch of {BATCH}: kernel {ms:.4f} ms against a bound of {least:.4f} ms "
        f"({least / ms:.1%} of it), plain {plain_ms:.4f} ms, F.avg_pool2d {library_ms:.4f} ms. The nine thin pools of "
        f"the fast trunk: kernel {thin['kernel']:.4f} ms against {thin_least:.4f} ms ({thin_least / thin['kernel']:.1%}), "
        f"plain {thin['plain']:.4f} ms")
    damsm_least = bound(damsm["bytes"])["bound_ms"]
    log(f"[K2 avg_pool] the nine pools of one DAMSM trunk batch of {CUB_BATCH}: kernel {damsm['kernel']:.4f} ms against "
        f"{damsm_least:.4f} ms ({damsm_least / damsm['kernel']:.1%})")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bound(nbytes)}


def _psd(gen: torch.Generator, n: int) -> torch.Tensor:
    a = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    return a @ a.T / n + 0.1 * torch.eye(n, device="cuda", dtype=torch.float64)


def check_epilogue_matmul(gen: torch.Generator) -> dict:
    """K3 at the main path's n = 2048, at 1000 (16-byte copies with a ragged
    edge) and at sizes whose rows are not 16-byte aligned or that are smaller
    than a tile (4-byte copies): against the plain version, and two runs
    against each other bit for bit."""
    max_err, out, seen = 0.0, {}, set()
    for n in (2048, 1000, 1, 127, 130, 2047):
        a = torch.randn(n, n, generator=gen, device="cuda")
        b = torch.randn(n, n, generator=gen, device="cuda")
        got, ref = epilogue_matmul_kernel(a, b, 1.5, -0.5), epilogue_matmul_plain(a, b, 1.5, -0.5)
        again = epilogue_matmul_kernel(a, b, 1.5, -0.5)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        # f32 sums of n products in another order: rtol 1e-4, atol 1e-4 of the output's scale
        require(torch.allclose(got, ref, rtol=1e-4, atol=1e-4 * scale), f"epilogue_matmul n={n}: {err} (scale {scale})")
        require(torch.equal(got, again), f"epilogue_matmul n={n}: two runs on the same input differ")
        max_err = max(max_err, err)
        instance = epilogue_matmul_instance(a, b, got)
        seen.add(instance)
        ms = median_ms(lambda: epilogue_matmul_kernel(a, b, 1.5, -0.5))
        plain_ms = median_ms(lambda: epilogue_matmul_plain(a, b, 1.5, -0.5))
        eye = 1.5 * torch.eye(n, device="cuda")
        library_ms = median_ms(lambda: torch.addmm(eye, a, b, beta=1.0, alpha=-0.5))  # the one call: cuBLAS f32
        least = bound(3 * n * n * 4, 2 * n ** 3, PEAK_F32)
        gflops = 2 * n ** 3 / ms / 1e6
        log(f"[K3 epilogue_matmul] n={n} ({instance}): max_abs_err {err:.3e} (scale {scale:.1f}), two runs bit-equal; "
            f"kernel {ms:.4f} ms ({gflops:.0f} GFLOP/s), plain {plain_ms:.4f} ms, torch.addmm {library_ms:.4f} ms, "
            f"bound {least['bound_ms']:.4f} ms ({least['bound_by']})")
        if n == 2048:
            out = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **least}
    require(seen == set(KERNEL_INSTANCES), f"the sizes reached only {sorted(seen)} of K3's instances {KERNEL_INSTANCES}")
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


def probe_library_calls() -> dict:
    """For each layout probe the one PyTorch call that computes the same
    function, where there is one."""
    row = torch.cat([torch.full((32,), 2.0), torch.full((32,), 3.0)]).cuda()  # P5's constant row, built once outside the timing
    return {
        "lane_split": lambda x: torch.sum(x.view(x.shape[0], -1, 3), -1),
        "dma_minor27": lambda x: torch.mul(x, 2.0),
        "strided_slice": lambda x: x[:, ::2].contiguous(),
        "scratch_stage": lambda x: torch.mul(x, row),
    }


def against(us, bound_ms: float) -> str:
    """A device time from ``device_us`` beside its bound, or "not measured"
    where the profiler recorded none."""
    if us is None:
        return "not measured"
    return f"{us / 1e3:.5f} ms against a bound of {bound_ms:.5f} ms ({bound_ms * 1e3 / us:.1%} of it)"


def pool_device_times(gen: torch.Generator) -> None:
    """K2's duration on the device from torch.profiler: each trunk and thin
    shape, the nine pools of a batch and the nine thin pools, against their
    bytes bounds.  Run last, with probe_device_times."""
    for label, shapes in (("the nine pools of one f32 batch", POOL_SHAPES), ("the nine thin pools", THIN_POOL_SHAPES)):
        xs, least = [], bound(sum(n * 2 * torch.Size(s).numel() * 4 for s, n in shapes))["bound_ms"]
        for shape, per_batch in shapes:
            x = torch.randn(shape, generator=gen, device="cuda")
            b = bound(2 * x.numel() * 4)["bound_ms"]
            log(f"[K2 avg_pool] {str(shape):22s} on the device (torch.profiler) "
                f"{against(device_us(lambda: avg_pool_kernel(x, True), calls=5), b)}")
            xs += [x] * per_batch
        log(f"[K2 avg_pool] {label} on the device (torch.profiler): "
            f"{against(device_us(lambda: [avg_pool_kernel(x, True) for x in xs], calls=5), least)}")


def epilogue_device_times(gen: torch.Generator) -> None:
    """K3 at the main path's n = 2048 on the device from torch.profiler,
    beside ``torch.addmm``'s, against its operations bound (required).  Run
    last, with probe_device_times."""
    n = 2048
    a, b = (torch.randn(n, n, generator=gen, device="cuda") for _ in range(2))
    eye = 1.5 * torch.eye(n, device="cuda")
    us = device_us(lambda: epilogue_matmul_kernel(a, b, 1.5, -0.5), calls=5)
    require(us is not None, f"torch.profiler recorded no K3 kernel in {PROFILE_TRIES} profiled runs")
    lib_us = device_us(lambda: torch.addmm(eye, a, b, beta=1.0, alpha=-0.5), calls=5)
    log(f"[K3 epilogue_matmul] n=2048 on the device (torch.profiler): "
        f"{against(us, bound(3 * n * n * 4, 2 * n ** 3, PEAK_F32)['bound_ms'])}; torch.addmm "
        f"{'not measured' if lib_us is None else f'{lib_us / 1e3:.5f} ms'}")


def normalize_device_times(gen: torch.Generator, floor_us: float) -> None:
    """K1's duration on the device from torch.profiler in each case of
    NORMALIZE_TIMED, against its bytes bound and in launch floors, beside its
    library call's.  K1's readings are required: a profiler that records none
    fails the run.  Run last, with probe_device_times."""
    xs = normalize_inputs(gen)
    for label, recipe, dtype in NORMALIZE_TIMED:
        x, library = xs[label], normalize_library_call(recipe, dtype)
        us = device_us(lambda: normalize_kernel(x, recipe, dtype))
        require(us is not None, f"torch.profiler recorded no K1 kernel at {label} in {PROFILE_TRIES} profiled runs")
        lib_us = device_us(lambda: library(x))
        log(f"[K1 normalize] {recipe} {str(dtype)[6:]} {list(x.shape)} on the device (torch.profiler): "
            f"{against(us, bound(normalize_bytes(x, dtype))['bound_ms'])}, {us / floor_us:.2f} launch floors; "
            f"torch.addcmul {'not measured' if lib_us is None else f'{lib_us / 1e3:.5f} ms'}")


def launch_floor() -> float:
    """The device time of the smallest launch the port can make: P3's kernel
    on an f32 [1, 2] input, one block and one element (torch.profiler).
    Required."""
    x = torch.randn(1, 2, device="cuda")
    got = mosaic_probe.strided_slice_kernel(x)
    require(torch.equal(got, mosaic_probe.strided_slice_plain(x)), "P3 on [1, 2] disagrees with its plain version")
    us = device_us(lambda: mosaic_probe.strided_slice_kernel(x))
    require(us is not None, f"torch.profiler recorded no kernel for the launch floor in {PROFILE_TRIES} profiled runs")
    log(f"[launch floor] P3 strided_slice on f32 [1, 2] (one block, one element) on the device (torch.profiler): "
        f"{us:.3f} us")
    return us


def probe_device_times(floor_us: float) -> None:
    """The duration on the device of each probe kernel and of its library
    call, from torch.profiler, and the kernel's in launch floors.  Run last:
    nothing timed by events or by the host's clock comes after the profiler
    has been on."""
    library = probe_library_calls()
    for name, (kernel, *_) in mosaic_probe.PROBES.items():
        x = torch.from_numpy(mosaic_probe.probe_input(name, seed=1)).cuda()
        times = [("kernel", device_us(lambda: kernel(x)))]
        if name in library:
            times.append(("library call", device_us(lambda: library[name](x))))
        floors = "" if times[0][1] is None else f" ({times[0][1] / floor_us:.2f} launch floors of {floor_us:.3f} us)"
        log(f"[probe {name}] on the device (torch.profiler): " + ", ".join(
            f"{label} {'not measured' if t is None else f'{t:.2f} us'}" for label, t in times) + floors)


def p5_call_breakdown(row_call) -> None:
    """Where the host's time in one call of P5's wrapper goes, part by part
    (host clock, 1,000 calls each), beside its library call."""
    x = torch.from_numpy(mosaic_probe.probe_input("scratch_stage", seed=1)).cuda()
    out = mosaic_probe.scratch_stage_kernel(x)  # binds the entry
    entry, sink = mosaic_probe._SCRATCH_STAGE, type("Sink", (), {"launches": 0})
    xp, op, stream = x.data_ptr(), out.data_ptr(), native._raw_stream(x.device.index)
    parts = {
        "checks": lambda: mosaic_probe._check_input(x, "scratch_stage", 2),
        "torch.empty_like": lambda: torch.empty_like(x),
        "two data_ptr()": lambda: (x.data_ptr(), out.data_ptr()),
        "the C entry alone (ctypes, cudaLaunchKernel)": lambda: entry.call(xp, op, 8, stream),
        "native.launch (device, stream, C entry, count)": lambda: native.launch(entry, sink, x.device, xp, op, 8),
        "the whole wrapper": lambda: mosaic_probe.scratch_stage_kernel(x),
        "torch.mul(x, row)": lambda: row_call(x),
    }
    log("[probe scratch_stage] host us a call, by part: " + "; ".join(
        f"{label} {host_us(fn)[0]:.2f}" for label, fn in parts.items()))


def check_layout_probes() -> dict:
    """P1-P5 at the TPU probes' shapes on seeded random input: P2-P5 bit-equal
    to plain, P1 (three f32 adds) within rtol 1e-6; then, for each kernel and
    its library call, the host's time per call beside the event time."""
    library = probe_library_calls()
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
        calls = [("kernel", lambda: kernel(x), ms)]
        if name in library:
            calls.append(("library call", lambda: library[name](x), library_ms))
        for label, fn, event_ms in calls:
            enqueue, drained = host_us(fn)
            log(f"[probe {name}] {label}: host {enqueue:.2f} us a call ({drained:.2f} us with the queue drained), "
                f"events around 10 calls {event_ms * 1e3:.2f} us a call")
        log(f"[probe {name}] {list(shape)} max_abs_err {err:.3e} ({'bit-equal' if torch.equal(got, ref) else f'rtol {rtol}'}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library call "
            f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}; {nbytes} bytes")
        require(ok, f"probe {name} disagrees with its plain version: {err}")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bound(nbytes)}
    p5_call_breakdown(library["scratch_stage"])
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
        g = stem_mm_probe.stem_geometry(m, k, n)
        log(f"[P6 stem_mm] {label} [{m},{k}]x[{k},{n}]: last dot max_abs_err {err:.3e} (scale {scale:.1f}); "
            f"{STEM_NSTEPS} dots: kernel {t:.4f} ms, plain loop {p:.4f} ms; wgmma n {g.nb}, grid {g.grid}")
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
    d["state_is"] = state_is
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


# ---------------------------------------------------------------------------
# 5. the CLIP paths: RP-COCO and PA at the full width of ViT-B/32
# ---------------------------------------------------------------------------

N_RP = 2048          # RP-COCO items: an image, its caption and 99 mismatched ones
N_POOL = 4096        # synthetic captions the items draw from
N_NO_DEDUP = 256     # the first RP items, again with --no-dedup-text
N_PA = 256           # PA items a phrase
PA_PHRASES = {"left": ("on the left of", "on the right of"), "right": ("on the right of", "on the left of"),
              "above": ("above", "below"), "below": ("below", "above")}
_SIZES, _COLOURS = ("small", "big", "tiny", "large"), ("red", "blue", "green", "black", "white", "brown", "grey", "pink")
_NOUNS = ("cat", "dog", "man", "woman", "car", "tree", "bird", "table", "horse", "boat", "plate", "clock")
_VERBS, _PREPS = ("sits", "stands", "lies", "waits", "sleeps", "plays"), ("on", "near", "under", "behind", "beside", "by")


def write_merge_table(path: str, words) -> str:
    """A BPE merge table that builds each word left to right into one token
    (the real table, bpe_simple_vocab_16e6.txt.gz, is not in the repository)."""
    merges, seen = ["#version: 0.2"], set()
    for word in words:
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            if (parts[0], parts[1]) not in seen:
                seen.add((parts[0], parts[1]))
                merges.append(f"{parts[0]} {parts[1]}")
            parts = [parts[0] + parts[1]] + parts[2:]
    with open(path, "w") as f:
        f.write("\n".join(merges) + "\n")
    return path


def clip_image(i: int) -> np.ndarray:
    """Seeded image i: 320 x 256 (even i) or 256 x 320, cells of 16 pixels
    with noise, so that the bicubic shorter-side resize and the crop both act."""
    rng = np.random.RandomState(1000 + i)
    h, w = (320, 256) if i % 2 == 0 else (256, 320)
    cells = np.kron(rng.randint(0, 224, (h // 16, w // 16, 3)), np.ones((16, 16, 1)))
    return (cells + rng.randint(0, 32, (h, w, 3))).astype(np.uint8)


def make_clip_data() -> dict:
    """The RP and PA inputs: 2,048 seeded PNGs, a merge table, a pool of
    4,096 synthetic captions, an RP pickle (each item's caption and 99
    mismatched ones drawn from the pool), its first 256 items, a PA pickle of
    4 phrases x 256 items on the first 1,024 images (hard links; each false
    caption swaps the positional words), and full-width ViT-B/32 weights from
    ``random_state_dict`` as ``.npz``."""
    from PIL import Image

    t0 = time.perf_counter()
    root = os.path.join(SCRATCH, "clip")
    images = os.path.join(root, "images")
    os.makedirs(images)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda i: Image.fromarray(clip_image(i)).save(os.path.join(images, f"{i}.png")), range(N_RP)))
    rng = np.random.RandomState(31)
    pick = lambda words: words[rng.randint(len(words))]  # noqa: E731
    captions = set()
    while len(captions) < N_POOL:
        captions.add(f"a {pick(_SIZES)} {pick(_COLOURS)} {pick(_NOUNS)} {pick(_VERBS)} {pick(_PREPS)} "
                     f"a {pick(_COLOURS)} {pick(_NOUNS)}")
    captions = sorted(captions)
    items = []
    for i in range(N_RP):
        gt = rng.randint(N_POOL)
        others = rng.randint(N_POOL - 1, size=99)
        others += others >= gt  # any caption but the item's own
        items.append({"caption_id": i, "caption": captions[gt], "mismatched_captions": [captions[j] for j in others]})
    pa_data = {}
    for p, (phrase, (pos, swapped)) in enumerate(PA_PHRASES.items()):
        os.makedirs(os.path.join(images, phrase))
        pa_data[phrase] = []
        for j in range(N_PA):
            os.link(os.path.join(images, f"{p * N_PA + j}.png"), os.path.join(images, phrase, f"{j}.png"))
            a, b = f"a {pick(_COLOURS)} {pick(_NOUNS)}", f"a {pick(_COLOURS)} {pick(_NOUNS)}"
            pa_data[phrase].append({"caption_id": j, "caption": f"{a} {pos} {b}", "false_caption": f"{a} {swapped} {b}"})
    words = sorted({w for text in captions + [c for v in pa_data.values() for it in v for c in it.values()
                                              if isinstance(c, str)] for w in text.split()})
    d = {"images": images, "bpe": write_merge_table(os.path.join(root, "bpe.txt"), words),
         "rp": os.path.join(root, "rp.pkl"), "rp_head": os.path.join(root, "rp_head.pkl"),
         "pa": os.path.join(root, "pa.pkl"), "weights": os.path.join(root, "clip.npz"), "items": items,
         "pa_data": pa_data, "captions": captions}
    result_io.save_pickle(d["rp"], items)
    result_io.save_pickle(d["rp_head"], items[:N_NO_DEDUP])
    result_io.save_pickle(d["pa"], pa_data)
    d["state_dict"] = clip_vit.random_state_dict(seed=0)
    # the released checkpoints' logit scale (training clamps it at 100) in place of the init's 1/0.07: a PA
    # decision needs a logit gap of log 1.5, which random towers reach at this scale for about a third of the items
    d["state_dict"]["logit_scale"] = np.asarray(np.log(100.0), np.float32)
    np.savez(d["weights"], **d["state_dict"])
    log(f"[clip data] {N_RP} PNGs (320x256 and 256x320), {N_POOL} captions over {len(words)} words, "
        f"{N_RP} RP items, {len(PA_PHRASES)} x {N_PA} PA items, ViT-B/32 weights in {time.perf_counter() - t0:.1f} s")
    return d


@contextlib.contextmanager
def recording(owner, name: str):
    """Wrap ``owner.<name>`` for the block; yields the list of what it returned."""
    fn, seen = getattr(owner, name), []

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        seen.append(out)
        return out

    setattr(owner, name, wrapper)
    try:
        yield seen
    finally:
        setattr(owner, name, fn)


def path_rp(c: dict) -> dict:
    """RP-COCO through ``rp_coco.main``: ``--precision highest`` on all items
    (the text bank), ``--no-dedup-text`` on the first 256 (whose success bits
    must equal the bank run's), ``--precision fast`` on all items.  K1 runs
    once per image batch in each; every mean is held to its success bits."""
    common = ["--image_dir", c["images"], "--weights", c["weights"], "--bpe_path", c["bpe"],
              "--batch_size", str(BATCH)]
    total, success = {}, {}
    for tag, pickle_path, n, extra in (("highest", c["rp"], N_RP, []),
                                       ("no-dedup", c["rp_head"], N_NO_DEDUP, ["--no-dedup-text"]),
                                       ("fast", c["rp"], N_RP, ["--precision", "fast"])):
        saved = os.path.join(SCRATCH, f"rp_{tag}.txt")
        reset_counters()
        with recording(rp_coco, "score_items") as got:
            t0 = time.perf_counter()
            rp_coco.main([*common, "--rp_input_file", pickle_path, "--saved_file_path", saved, *extra])
            torch.cuda.synchronize()
            t_cli = time.perf_counter() - t0
        launches = counts()
        with open(saved) as f:
            require(f.read().startswith("R-precision: "), "RP result file format")
        mean, std = result_io.read_rp_coco_result(saved)
        success[tag] = got[0]
        bins = [float(np.mean(success[tag][b])) for b in rp_coco.make_bins(n, NUM_SPLITS, 0)]
        log(f"[rp {tag}] CLI {t_cli:.2f} s ({n / t_cli:.1f} items/s = images/s end to end); R-precision {mean!r} +- "
            f"{std!r}; {int(success[tag].sum())} of {n} items succeed; launches {launches}")
        require(success[tag].shape == (n,) and np.isfinite(mean) and np.isfinite(std), f"RP {tag}: {mean}, {std}")
        require(mean == float(np.mean(bins)) and std == float(np.std(bins)), f"RP {tag}: result vs its success bits")
        require(launches["normalize"] == -(-n // BATCH), f"RP {tag}: K1 launched once per image batch")
        require(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
                f"RP {tag} left TF32 off")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
    require(np.array_equal(success["no-dedup"], success["highest"][:N_NO_DEDUP]),
            "RP --no-dedup-text success bits differ from the text bank's")
    agree = float(np.mean(success["fast"] == success["highest"]))
    log(f"[rp] --no-dedup-text success bits equal the bank run's on {N_NO_DEDUP} items; fast agrees with highest "
        f"on {agree:.2%} of {N_RP} items")
    return total


def path_pa(c: dict) -> dict:
    """PA through ``pa.main`` on 4 phrases x 256 items, held to the PA
    recomputed here in numpy (float64) from the logits the CLI's scorer
    returned."""
    saved = os.path.join(SCRATCH, "pa.txt")
    reset_counters()
    with recording(ClipPairScorer, "logits") as got:
        t0 = time.perf_counter()
        pa.main(["--image_dir", c["images"], "--weights", c["weights"], "--bpe_path", c["bpe"],
                 "--pa_input_file", c["pa"], "--batch_size", str(BATCH), "--saved_file_path", saved])
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t0
    launches = counts()
    n = len(PA_PHRASES) * N_PA
    per_phrase = -(-N_PA // BATCH)
    require(launches["normalize"] == len(PA_PHRASES) * per_phrase, "PA: K1 launched once per image batch")
    with open(saved) as f:
        require(f.read().startswith("PA = "), "PA result file format")
    value = result_io.read_pa_result(saved)
    scores = []
    for p in range(len(PA_PHRASES)):
        logits = np.concatenate(got[p * per_phrase:(p + 1) * per_phrase]).astype(np.float64)
        p_gt = 1.0 / (1.0 + np.exp(logits[:, 1] - logits[:, 0]))
        scores.append(float(np.sum(p_gt > PA_SUCCESS_THRESHOLD)) / N_PA)
    host = float(np.mean(scores))
    log(f"[pa] CLI {t_cli:.2f} s ({n / t_cli:.1f} items/s = images/s end to end); PA {value!r}, host numpy {host!r} "
        f"(per phrase {scores}); launches {launches}")
    require(value == host, f"PA {value} differs from the host's {host} on the same logits")
    return launches


def clip_checks(c: dict) -> dict:
    """The scorers themselves: the bf16 fast tower against highest on one
    batch (5e-2 of the logits' scale), the bank against the direct path (1e-4),
    the card's f32 logits against the port's CPU logits on 16 PA items (1e-3;
    the CPU path is the one the tests hold against the JAX package); then
    where the time goes: the CLI's start-up, one batch of the direct path,
    the host loader alone, each tower's time by events per batch of 64, and
    the text bank's captions/s.  Returns what clip_device_times needs."""
    items = c["items"][:BATCH]
    t0 = time.perf_counter()
    sd = clip_vit.load_params(c["weights"])
    t_load = time.perf_counter() - t0
    highest = ClipPairScorer(sd, "cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0 - t_load
    fast = ClipPairScorer(sd, "cuda", fast=True)
    tok = SimpleTokenizer(c["bpe"])
    imgs = np.stack([center_crop_resize(os.path.join(c["images"], f"{it['caption_id']}.png"), CLIP_SIZE)
                     for it in items])
    caps = sorted({t for it in items for t in [it["caption"], *it["mismatched_captions"]]})
    row = {t: i for i, t in enumerate(caps)}
    idx = np.asarray([[row[t] for t in [it["caption"], *it["mismatched_captions"]]] for it in items], np.int32)
    toks = tok.tokenize(caps)
    logits = {name: s.logits_from_bank(imgs, s.encode_text_bank(toks), idx) for name, s in
              (("highest", highest), ("fast", fast))}
    scale = float(np.abs(logits["highest"]).max())
    err = float(np.abs(logits["fast"] - logits["highest"]).max())
    direct = highest.logits(imgs[:16], toks[idx[:16]])
    direct_err = float(np.abs(direct - logits["highest"][:16]).max())
    log(f"[clip] one batch of {BATCH} items x 100 captions: fast logits vs highest max_abs_err {err:.3e} "
        f"({err / scale:.2e} of scale {scale:.3f}); direct vs bank path on 16 items {direct_err:.3e}")
    require(err <= 5e-2 * scale, f"fast logits differ from highest by {err} > 5e-2 x {scale}")
    require(direct_err <= 1e-4 * scale, f"direct logits differ from the bank path's by {direct_err}")
    # one batch of the --no-dedup-text path, part by part (host clock; logits() ends in a copy to the host)
    t0 = time.perf_counter()
    batch_toks = np.stack([tok.tokenize([it["caption"], *it["mismatched_captions"]]) for it in items])
    t_tok = time.perf_counter() - t0
    t0 = time.perf_counter()
    highest.logits(imgs, batch_toks)
    t_direct = time.perf_counter() - t0
    log(f"[time clip] start-up: load_params {t_load:.2f} s, ClipPairScorer on the card {t_build:.2f} s; one "
        f"--no-dedup-text batch of {BATCH} x 100 captions: tokenize {t_tok:.3f} s, logits {t_direct:.3f} s")
    pa_items = c["pa_data"]["left"][:16]
    pa_imgs = np.stack([center_crop_resize(os.path.join(c["images"], "left", f"{it['caption_id']}.png"), CLIP_SIZE)
                        for it in pa_items])
    pa_toks = np.stack([tok.tokenize([it["caption"], it["false_caption"]]) for it in pa_items])
    card = highest.logits(pa_imgs, pa_toks)
    t0 = time.perf_counter()
    cpu = ClipPairScorer(sd, "cpu").logits(pa_imgs, pa_toks)
    t_cpu = time.perf_counter() - t0
    cpu_scale, cpu_err = float(np.abs(cpu).max()), float(np.abs(card - cpu).max())
    log(f"[clip] card f32 logits (TF32 off) vs the port's CPU logits on 16 PA items: max_abs_err {cpu_err:.3e} "
        f"(scale {cpu_scale:.3f}; CPU run {t_cpu:.1f} s)")
    require(np.isfinite(card).all() and card.shape == (16, 2), "card logits")
    require(cpu_err <= 1e-3 * cpu_scale, f"card logits differ from CPU logits by {cpu_err} > 1e-3 x {cpu_scale}")

    files = [os.path.join(c["images"], f"{i}.png") for i in range(N_RP)]
    t0 = time.perf_counter()
    for batch in ImageFolderLoader(files, BATCH, CLIP_SIZE, resample=BICUBIC, center_crop=True):
        pass
    host_img_s = len(files) / (time.perf_counter() - t0)
    x = torch.from_numpy(batch.images).cuda()
    t64 = torch.from_numpy(toks[:BATCH].astype(np.int64)).cuda()
    times = {}
    with torch.inference_mode():
        for name, s in (("highest", highest), ("fast", fast)):
            times[f"image tower {name}"] = median_ms(lambda: s.encode_images(x), reps=5, inner=4, warmup=2)
            times[f"text tower {name}"] = median_ms(lambda: s.encode_text(t64), reps=5, inner=4, warmup=2)
    t0 = time.perf_counter()
    all_toks = SimpleTokenizer(c["bpe"]).tokenize(c["captions"])
    t_tok_all = time.perf_counter() - t0
    bank_rate = {}
    for name, s in (("highest", highest), ("fast", fast)):
        s.encode_text_bank(all_toks[:1024])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.encode_text_bank(all_toks)
        torch.cuda.synchronize()
        bank_rate[name] = len(all_toks) / (time.perf_counter() - t0)
    log(f"[time clip] host loader alone (PNG decode, bicubic resize, crop) {host_img_s:.1f} images/s; per batch of "
        f"{BATCH} on the device: " + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
        + " (image towers include K1); text bank " + ", ".join(f"{k} {v:.1f} captions/s" for k, v in bank_rate.items())
        + f"; tokenizing the {len(all_toks)} captions on the host {t_tok_all:.3f} s")
    require(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
            "the fast text tower left TF32 off")
    return {"images": x, "tokens": t64, "scorers": {"highest": highest, "fast": fast}, "events_ms": times}


def clip_device_times(t: dict) -> None:
    """Each tower's time on the device per batch of 64 (torch.profiler: the
    sum of its kernels) beside its time by events from clip_checks: where the
    two differ, the host's launches set the pace.  Run last, with
    probe_device_times."""
    with torch.inference_mode():
        for name, s in t["scorers"].items():
            for tower, fn in (("image tower", lambda: s.encode_images(t["images"])),
                              ("text tower", lambda: s.encode_text(t["tokens"]))):
                us = device_us(fn, calls=4)
                log(f"[time clip] {tower} {name} on the device (torch.profiler): "
                    f"{'not measured' if us is None else f'{us / 1e3:.3f} ms'} against "
                    f"{t['events_ms'][f'{tower} {name}']:.3f} ms by events")


# ---------------------------------------------------------------------------
# 6. the CUB track: the DAMSM encoders, RP-CUB and the track runner
# ---------------------------------------------------------------------------

N_CUB_RP = 2048      # RP-CUB items, one 256 x 256 PNG each: also the runner's image folder
N_CUB_REF = 2048     # PNGs of the folder whose statistics become bird_val.npz
CUB_NTOKEN = 5450    # the CUB vocabulary (tise_tpu/models/attngan_pp/trainer.py:45)
CUB_POOL = 4096      # captions the RP items draw from
CUB_FAIL_AT = 7      # the RP block at which the failing run raises
CUB_SNAPSHOT_EVERY = 128


def check_normalize_half(gen: torch.Generator) -> dict:
    """K1 under ``half`` at RP-CUB's [32, 256, 256, 3] (f32): bit for bit
    against its plain version, its time by events, the plain version's and
    ``torch.addcmul``'s, beside the bytes bound (its device time:
    cub_device_times)."""
    x = torch.randint(0, 256, (CUB_BATCH, 256, 256, 3), generator=gen, device="cuda", dtype=torch.uint8)
    got, ref = normalize_kernel(x, "half"), normalize_plain(x, "half")
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    require(torch.equal(got, ref), f"normalize half {list(x.shape)}: max_abs_err {err}")
    library = normalize_library_call("half")
    lib_err = float((library(x) - ref).abs().max())
    tol = torch.finfo(torch.float32).eps * (255 * RECIPES["half"][0][0] + float(ref.abs().max()))  # as in check_normalize
    require(lib_err <= tol, f"torch.addcmul differs from K1's plain version under half by {lib_err} > {tol}")
    ms, plain_ms = median_ms(lambda: normalize_kernel(x, "half")), median_ms(lambda: normalize_plain(x, "half"))
    library_ms = median_ms(lambda: library(x))
    enqueue, drained = host_us(lambda: normalize_kernel(x, "half"))
    least = bound(normalize_bytes(x, torch.float32))
    log(f"[K1 normalize] half float32 {list(x.shape)}: torch.equal to the plain version; events {ms:.4f} ms, host "
        f"{enqueue:.2f} us a call ({drained:.2f} us with the queue drained), plain {plain_ms:.4f} ms, torch.addcmul "
        f"{library_ms:.4f} ms (max_abs_err {lib_err:.3e} to plain); bound {least['bound_ms']:.5f} ms "
        f"({normalize_bytes(x, torch.float32) / 1e6:.2f} MB)")
    return {"x": x, "library": library, **least}


def cub_image(i: int) -> np.ndarray:
    """Seeded 256 x 256 image i: cells of 16 pixels with noise."""
    rng = np.random.RandomState(3000 + i)
    cells = np.kron(rng.randint(0, 224, (16, 16, 3)), np.ones((16, 16, 1)))
    return (cells + rng.randint(0, 32, (256, 256, 3))).astype(np.uint8)


def mean_pool3_norm(state, images: np.ndarray, recipe: str) -> float:
    """The mean norm of pool3 of a torchvision-layout trunk on ``images``
    (PIL-resized to 299, normalized under ``recipe``)."""
    from PIL import Image

    model = InceptionV3.from_state_dict(state, device="cuda")
    x = np.stack([np.asarray(Image.fromarray(im).resize((fid.IMAGE_SIZE,) * 2, Image.BILINEAR)) for im in images])
    with torch.no_grad():
        return float(model(normalize_kernel(torch.from_numpy(x).cuda(), recipe))["pool3"].norm(dim=1).mean())


def make_cub_data(d: dict) -> dict:
    """The standard layout of the CUB track under build/chip_smoke/cub/: 2,048
    seeded PNGs named ``<caption_id>.png`` (the images under test) and 2,048
    more whose statistics become ``bird_val.npz`` (written later, by the FID
    CLI); a vocabulary of 5,450 words in ``captions.pickle``; 2,048 RP items,
    each its caption and 99 mismatched ones drawn from a pool of 4,096
    synthetic captions of 1-25 words; the FID weights of the earlier paths
    (a hard link); the IS* CUB trunk of the earlier paths with its head
    scaled to logits of order 1 on these images (the earlier scale, set on
    64 x 64 noise, saturates the softmax here and IS* comes out NaN); the
    DAMSM encoders at full width as reference-layout ``.pth`` files: the
    text encoder from ``random_rnn_state_dict(5, 5450)``, the image encoder
    a trunk whose BatchNorm statistics are calibrated on 128 of the images
    under ``half`` and the heads of ``random_cnn_state_dict(6)``."""
    from PIL import Image

    t0 = time.perf_counter()
    root = os.path.join(SCRATCH, "cub")
    data, weights = os.path.join(root, "data"), os.path.join(root, "weights")
    images, reference = os.path.join(root, "images"), os.path.join(root, "reference")
    os.makedirs(images)
    os.makedirs(reference)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda i: Image.fromarray(cub_image(i)).save(os.path.join(images, f"{i}.png")), range(N_CUB_RP)))
        list(pool.map(lambda i: Image.fromarray(cub_image(N_CUB_RP + i)).save(os.path.join(reference, f"{i}.png")),
                      range(N_CUB_REF)))
    ixtoword = {0: "<end>", **{i: f"w{i}" for i in range(1, CUB_NTOKEN)}}
    rng = np.random.RandomState(41)
    captions = []
    for _ in range(CUB_POOL):
        words = [ixtoword[j] for j in rng.randint(1, CUB_NTOKEN, rng.randint(1, 26))]
        words[0] = words[0].capitalize()
        captions.append(" ".join(words[:-1] + [words[-1] + ","]) if len(words) > 3 else " ".join(words) + ".")
    items = []
    for i in range(N_CUB_RP):
        gt = rng.randint(CUB_POOL)
        others = rng.randint(CUB_POOL - 1, size=99)
        others += others >= gt
        items.append({"caption_id": i, "caption": captions[gt], "mismatched_captions": [captions[j] for j in others]})

    def place(base: str, rel: str) -> str:
        path = os.path.join(base, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path

    c = {"root": root, "images": images, "reference": reference, "data": data, "weights": weights,
         "items": items, "captions": captions, "wordtoix": {w: i for i, w in ixtoword.items()},
         "stats": place(data, benchmark.DATA["cub_fid_stats"]),
         "rp": place(data, benchmark.DATA["cub_rp_captions"]),
         "vocab": place(data, benchmark.DATA["cub_captions_pickle"]),
         "fid_weights": place(weights, benchmark.WEIGHTS["inception"]),
         "slim": place(weights, benchmark.WEIGHTS["inception_cub"]),
         "text": place(weights, benchmark.WEIGHTS["damsm_text"]),
         "image": place(weights, benchmark.WEIGHTS["damsm_image"])}
    result_io.save_pickle(c["rp"], items)
    result_io.save_pickle(c["vocab"], [[], [], ixtoword, c["wordtoix"]])
    os.link(d["weights"], c["fid_weights"])
    sample = np.stack([cub_image(i) for i in range(128)])
    norm = mean_pool3_norm(d["state_is"], sample, "is_star")
    np.savez(c["slim"], **tf_layout_vars(d["state_is"], "slim", seed=21, head_std=1.0 / norm))
    torch.save({k: torch.from_numpy(v) for k, v in damsm.random_rnn_state_dict(5, CUB_NTOKEN).items()}, c["text"])
    trunk, _ = calibrated_state(3, 1000, sample, "half")
    heads = {k: torch.from_numpy(v) for k, v in damsm.random_cnn_state_dict(6).items() if k.startswith("emb_")}
    torch.save({**{k: v for k, v in trunk.items() if not k.startswith("fc.")}, **heads}, c["image"])
    log(f"[cub data] {N_CUB_RP} + {N_CUB_REF} PNGs of 256x256, {N_CUB_RP} RP items over {CUB_POOL} captions and "
        f"{CUB_NTOKEN} words, DAMSM weights at full width in {time.perf_counter() - t0:.1f} s")
    return c


def cub_batch(c: dict):
    """The first block of RP items as the CLI feeds them: uint8 images and packed captions."""
    imgs = np.stack([load_image(os.path.join(c["images"], f"{i}.png"), (256, 256)) for i in range(CUB_BATCH)])
    sets = [[rp_cub.tokenize_caption(t, c["wordtoix"]) for t in [it["caption"], *it["mismatched_captions"]]]
            for it in c["items"][:CUB_BATCH]]
    return imgs, *rp_cub.pack_caption_sets(sets, rp_cub.MAX_LEN)


def check_damsm_encoders(c: dict) -> dict:
    """The DAMSM encoders at full width on one batch of 32 items (32 images,
    3,200 captions): the card's cnn_code and sent_emb, TF32 off, against the
    port on the CPU within 1e-4 of their scale (cuDNN's f32 convolutions and
    LSTM against the CPU's, sums in another order).  Returns the card's
    scorer and the batch on the card for cub_timings."""
    rnn_sd, cnn_sd = damsm.load_rnn_state_dict(c["text"]), damsm.load_cnn_state_dict(c["image"])
    imgs, caps, lens = cub_batch(c)
    out = {}
    for dev in ("cuda", "cpu"):
        scorer = rp_cub.DamsmScorer(rnn_sd, cnn_sd, dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            x, tokens = torch.from_numpy(imgs).to(dev), torch.from_numpy(caps.reshape(-1, caps.shape[-1])).to(dev)
            out[dev] = (scorer.image_codes(x).cpu(), scorer.sentence_codes(tokens, lens.reshape(-1)).cpu())
        out[f"{dev} s"] = time.perf_counter() - t0
        if dev == "cuda":
            card = {"scorer": scorer, "x": x, "tokens": tokens, "lens": lens.reshape(-1)}
    for i, name in enumerate(("cnn_code", "sent_emb")):
        got, ref = out["cuda"][i], out["cpu"][i]
        scale, err = float(ref.abs().max()), float((got - ref).abs().max())
        log(f"[damsm] {name} {list(got.shape)} card vs CPU: max_abs_err {err:.3e} (scale {scale:.3f}, "
            f"{err / scale:.2e} of it)")
        require(bool(torch.isfinite(got).all()) and err <= 1e-4 * scale, f"damsm {name} card vs CPU: {err} of {scale}")
    log(f"[damsm] one batch of {CUB_BATCH} images and {caps.shape[0] * caps.shape[1]} captions: card "
        f"{out['cuda s']:.2f} s (first call), CPU {out['cpu s']:.2f} s; captions of {int(lens.min())}-{int(lens.max())} "
        f"tokens")
    require(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32, "damsm: TF32 is off")
    return card


def host_bins_text(successes: np.ndarray, seed: int = 0) -> str:
    """RP-CUB's result file recomputed here from per-item successes: a seeded
    shuffle, ten equal bins, the mean and deviation of their means."""
    s = np.array(successes, dtype=np.float64)
    np.random.RandomState(seed).shuffle(s)
    bins = [float(np.mean(p)) for p in np.array_split(s, NUM_SPLITS)]
    return "R mean:{:.6f} std:{:.6f}".format(float(np.mean(bins)), float(np.std(bins)))


class FailingScorer:
    """An RP-CUB scorer that raises at its ``fail_at``-th block (also used by
    tests/test_torch_rp_cub.py)."""

    def __init__(self, inner, fail_at: int):
        self.inner, self.fail_at, self.blocks = inner, fail_at, 0

    def dispatch(self, *args):
        self.blocks += 1
        if self.blocks == self.fail_at:
            raise RuntimeError("injected failure")
        return self.inner.dispatch(*args)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def path_rp_cub(c: dict, card: dict) -> tuple:
    """RP-CUB through ``rp_cub.main`` on 2,048 items in ``highest`` and in
    ``fast``: each result file equal to the bins recomputed here from the
    per-item successes that its ``compute_rp_cub`` returned, fast agreeing
    with highest on at least 99% of items; then a run that fails at its
    seventh block (after a snapshot at 160 items) and the same command
    resuming it to the highest run's bytes.  K1 once and K2 nine times a
    block of 32.  Returns each run's launches and the highest run's result
    file."""
    common = ["--image_dir", c["images"], "--rp_input_file", c["rp"], "--captions_pickle", c["vocab"],
              "--text_encoder", c["text"], "--image_encoder", c["image"]]
    blocks = -(-N_CUB_RP // CUB_BATCH)
    per_path, text, success = [], {}, {}
    for tag, extra in (("highest", []), ("fast", ["--precision", "fast"])):
        saved = os.path.join(c["root"], f"rp_cub_{tag}.txt")
        reset_counters()
        with recording(rp_cub, "compute_rp_cub") as got:
            t0 = time.perf_counter()
            rp_cub.main([*common, "--saved_file_path", saved, *extra])
            torch.cuda.synchronize()
            t_cli = time.perf_counter() - t0
        per_path.append(counts())
        with open(saved) as f:
            text[tag] = f.read()
        success[tag] = got[0][2]
        log(f"[rp-cub {tag}] CLI {t_cli:.2f} s ({N_CUB_RP / t_cli:.1f} items/s = images/s end to end); {text[tag]}; "
            f"{int(success[tag].sum())} of {N_CUB_RP} items succeed; launches {per_path[-1]}")
        require(success[tag].shape == (N_CUB_RP,), f"RP-CUB {tag}: {success[tag].shape} successes")
        require(text[tag] == host_bins_text(success[tag]), f"RP-CUB {tag}: {text[tag]!r} vs its successes' bins "
                                                           f"{host_bins_text(success[tag])!r}")
        require(per_path[-1]["normalize"] == blocks and per_path[-1]["avg_pool_3x3_s1_p1"] == 9 * blocks,
                f"RP-CUB {tag}: K1 once and K2 9x per block ({blocks} blocks)")
        require(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
                f"RP-CUB {tag} left TF32 off")
    agree = float(np.mean(success["fast"] == success["highest"]))
    log(f"[rp-cub] fast agrees with highest on {agree:.2%} of {N_CUB_RP} items")
    require(agree >= 0.99, f"RP-CUB fast agrees with highest on {agree:.2%} < 99% of items")

    snap = os.path.join(c["root"], "rp_cub.snapshot.npz")
    try:
        rp_cub.score_items(c["items"], c["images"], FailingScorer(card["scorer"], CUB_FAIL_AT), c["wordtoix"],
                           snapshot_path=snap, snapshot_every=CUB_SNAPSHOT_EVERY)
        raise AssertionError("the failing RP-CUB run did not fail")
    except RuntimeError as e:
        require(str(e) == "injected failure", f"RP-CUB failing run: {e}")
    with np.load(snap) as z:
        cursor = int(z["cursor"])
    saved = os.path.join(c["root"], "rp_cub_resumed.txt")
    reset_counters()
    t0 = time.perf_counter()
    rp_cub.main([*common, "--saved_file_path", saved, "--snapshot_file", snap])
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t0
    per_path.append(counts())
    with open(saved) as f:
        resumed = f.read()
    rest = -(-(N_CUB_RP - cursor) // CUB_BATCH)
    log(f"[rp-cub resume] failed at block {CUB_FAIL_AT} with a snapshot at {cursor} items; the same command resumed "
        f"in {t_cli:.2f} s: {resumed} (straight run: {text['highest']}); launches {per_path[-1]}")
    require(resumed == text["highest"], "RP-CUB resumed run differs from the straight run")
    require(not os.path.exists(snap), "RP-CUB: a finished run deletes its snapshot")
    require(per_path[-1]["normalize"] == rest, f"RP-CUB resume: K1 launched for the {rest} blocks left")
    return per_path, text["highest"]


def cub_timings(c: dict, card: dict) -> dict:
    """Where an RP-CUB run's time goes: host decode of the 2,048 PNGs (8
    threads), tokenizing the pool's 4,096 unique captions once each (as
    ``score_items``'s cache does), looking up and packing one block's 3,200,
    and the image encoder (K1, the upsample, the f32 trunk, the head) and the
    text encoder (embedding and the packed LSTM over 3,200 captions) a block
    of 32 on the device by events.  Returns what cub_device_times needs."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda i: load_image(os.path.join(c["images"], f"{i}.png"), (256, 256)), range(N_CUB_RP)))
    decode = N_CUB_RP / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    token_ids = {t: rp_cub.tokenize_caption(t, c["wordtoix"]) for t in c["captions"]}
    t_pool = time.perf_counter() - t0
    t0 = time.perf_counter()
    rp_cub.pack_caption_sets([[token_ids[t] for t in [it["caption"], *it["mismatched_captions"]]]
                              for it in c["items"][:CUB_BATCH]], rp_cub.MAX_LEN)
    t_pack = time.perf_counter() - t0
    s = card["scorer"]
    with torch.inference_mode():
        ms = {"image encoder": median_ms(lambda: s.image_codes(card["x"]), reps=5, inner=4, warmup=2),
              "text encoder": median_ms(lambda: s.sentence_codes(card["tokens"], card["lens"]), reps=5, inner=4,
                                        warmup=2)}
    log(f"[time rp-cub] host decode {decode:.1f} images/s; tokenizing the {CUB_POOL} unique captions {t_pool:.3f} s; "
        f"looking up and packing a block's 3,200 {t_pack * 1e3:.1f} ms; per block of "
        f"{CUB_BATCH} on the device (events): " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()))
    return {**card, "events_ms": ms}


def read_value(path: str, reader) -> float:
    value = reader(path)
    value = value[0] if isinstance(value, tuple) else value
    require(np.isfinite(value), f"{path}: {value}")
    return value


class _Tee:
    """stdout that is also kept in a buffer."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def run_runner(tag: str, argv: list) -> tuple:
    """One ``benchmark.main`` run from 0 counts: (values, its stdout, launches, seconds)."""
    reset_counters()
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        values = benchmark.main(argv)
    torch.cuda.synchronize()
    out = (values, tee.buf.getvalue(), counts(), time.perf_counter() - t0)
    log(f"[{tag}] {out[3]:.2f} s; launches {out[2]}")
    return out


def path_cub_runner(c: dict, rp_text: str) -> list:
    """``bird_val.npz`` from the reference folder through the FID CLI's
    ``--save_stats``; FID and IS* CUB through their CLIs on the images; then
    ``benchmark.main(["--track", "cub", ...])`` over the layout: FID, IS*
    and RP all present, no ``FAIL``, each within 1e-6 relative of its CLI run
    on the same inputs (RP: the highest run of path_rp_cub); then a
    ``--resume`` rerun that parses all three stages and launches nothing.
    Returns each run's launches."""
    per_path, direct = [], {}
    runs = (
        ("stats", lambda: fid.main(["--path1", c["reference"], "--save_stats", c["stats"],
                                    "--weights", c["fid_weights"]])),
        ("FID", lambda: fid.main(["--path1", c["stats"], "--path2", c["images"], "--weights", c["fid_weights"],
                                  "--saved_file", os.path.join(c["root"], "fid.txt")])),
        ("IS*", lambda: is_star.main(["--image_folder", c["images"], "--flavor", "cub", "--weights", c["slim"],
                                      "--saved_file", os.path.join(c["root"], "is_star.txt")])),
    )
    for name, run in runs:
        reset_counters()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        per_path.append(counts())
        log(f"[cub {name}] CLI {time.perf_counter() - t0:.2f} s; launches {per_path[-1]}")
    direct["FID"] = read_value(os.path.join(c["root"], "fid.txt"), result_io.read_fid_result)
    direct["IS*"] = read_value(os.path.join(c["root"], "is_star.txt"), result_io.read_is_result)
    direct["RP"] = float(rp_text[len("R mean:"):].split()[0]) * 100
    argv = ["--track", "cub", "--method_name", "smoke", "--images", c["images"], "--data_root", c["data"],
            "--weights_root", c["weights"], "--output_root", os.path.join(c["root"], "results")]
    out = {tag: run_runner(f"cub runner {tag}", argv + extra) for tag, extra in (("run", []), ("resume", ["--resume"]))}
    values, text, launches, t_run = out["run"]
    per_path.append(launches)
    log(f"[cub runner] {t_run:.2f} s; values {values} against the CLIs' {direct}; launches {launches}")
    require("FAIL" not in text and "SKIP" not in text, "the CUB runner reported a FAIL or a SKIP")
    require(set(values) == {"FID", "IS*", "RP"}, f"the CUB runner's values {values}")
    for key, ref in direct.items():
        require(abs(values[key] - ref) <= 1e-6 * abs(ref), f"runner {key} {values[key]} vs its CLI's {ref}")
    b64, b32 = N_CUB_RP // BATCH, -(-N_CUB_RP // CUB_BATCH)
    require(launches["normalize"] == 2 * b64 + b32 and launches["avg_pool_3x3_s1_p1"] == 9 * (2 * b64 + b32),
            "the CUB runner: K1 once and K2 9x per batch of its three stages")
    values, text, launches, t_run = out["resume"]
    log(f"[cub runner --resume] {t_run:.2f} s; values {values}")
    require(text.count("[benchmark] RESUME") == 3 and "[benchmark] RUN" not in text, "--resume ran a stage again")
    require(values == out["run"][0] and not any(launches.values()), "--resume changed a value or launched a kernel")
    return per_path


# ---------------------------------------------------------------------------
# 7. the detection stack: Faster R-CNN R50-FPN at 800 px, SOA, and the
#    detector's crops through O-IS and O-FID
# ---------------------------------------------------------------------------

DET_SIDE = 256            # the phase's PNGs; the detector resizes them to 800
DET_PER_LABEL = 4         # SOA: 80 label folders of 4 images, one batch each in highest
N_DET_CROP = 256          # crop_objects' source folder
DET_FAIL_AFTER = 10       # the SOA run that fails does so after this many labels
DET_SLAB = 64             # the slab of the crop run that is killed after its first
DET_PER_IMAGE = 6.0       # detections an image the classifier is calibrated to: 1,536 crops from 256 images
DET_CALIBRATION = 16      # crop sources the classifier is calibrated on


def det_image(seed: int) -> np.ndarray:
    """A seeded 256 x 256 RGB image of 3-7 smooth coloured blobs on noise."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:DET_SIDE, 0:DET_SIDE].astype(np.float32)
    img = rng.uniform(0, 48, (DET_SIDE, DET_SIDE, 3)).astype(np.float32)
    for _ in range(rng.randint(3, 8)):
        cy, cx = rng.uniform(0, DET_SIDE, 2)
        s = rng.uniform(DET_SIDE / 24, DET_SIDE / 5)
        img += np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * s * s))[..., None] * rng.uniform(60, 200, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


FAST_PRESET = {"dtype": torch.bfloat16, "roi_sampling": 1, "proposals": 256}


def fc2_features(det, images_bgr: np.ndarray) -> tuple:
    """(proposals, valid, the box head's fc2 output after its relu in f64)
    of ``det`` on ``images_bgr``, a batch at a time."""
    m, parts = det.model, []
    with torch.inference_mode():
        for i in range(0, len(images_bgr), det.batch_size):
            x = det._upload(images_bgr[i: i + det.batch_size])
            feats = m.features(x)
            props, valid = m.proposals(feats, tuple(x.shape[-2:]))
            roi = m.box_features(feats, props).flatten(-3)
            parts.append((props, valid, m.box_head.fc2(torch.relu(m.box_head.fc1(roi))).relu().double()))
    return tuple(torch.cat(t) for t in zip(*parts))


def calibrated_detector_weights(sd: dict, images_bgr: np.ndarray, per_image: float = DET_PER_IMAGE,
                                spread: float = 4.0, seed: int = 0) -> dict:
    """``sd`` (detectron2 layout) with its classifier rebuilt from the
    card's forward on ``images_bgr`` at 800 px (a data-dependent init).

    The raw random box head maps every proposal to nearly the same fc2
    vector, so one class wins everywhere and, as the classifier's gain
    grows, the count of detections jumps from none to the cap of 100 an
    image.  Here the 80 class rows are seeded random directions applied to
    the fc2 output less its mean over the images' valid proposals, scaled to
    a spread of ``spread`` logits, and the background logit is a constant
    set by bisection so that the images give ``per_image`` detections on
    average in the exact preset: scores spread over (0.5, 1), many classes.
    The fast preset's ROIAlign at one sample a bin moves the mean fc2
    vector; the class directions are made orthogonal to that move, so that
    both presets see the same margin to the background.  The box deltas
    stay zero."""
    sd = dict(sd)
    state = det_weights.state_dict_from_detectron2(sd)
    props, valid, h = fc2_features(predictor.Detector(state), images_bgr)
    fast = fc2_features(predictor.Detector(state, **FAST_PRESET), images_bgr)
    mu = h[valid].mean(0)
    shift = fast[2][fast[1]].mean(0) - mu
    shift /= shift.norm()
    w = torch.from_numpy(np.random.RandomState(seed).randn(80, h.shape[-1])).to(h)
    w -= (w @ shift)[:, None] * shift
    w *= spread / float(((h[valid] - mu) @ w.T).std())

    def count(beta: float, props, valid, h) -> float:
        fg = h @ w.T - w @ mu
        logits = torch.cat([fg, torch.full_like(fg[..., :1], beta)], -1).float()
        deltas = torch.zeros(*logits.shape[:-1], 320, device=logits.device)
        return float(rcnn.postprocess_detections(props, valid, logits, deltas, *images_bgr.shape[1:3]).valid.sum(1)
                     .float().mean())

    lo, hi = -20.0, 60.0
    for _ in range(30):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if count(mid, props, valid, h) > per_image else (lo, mid)
    weight = torch.zeros(81, h.shape[-1], dtype=torch.float64, device=h.device)
    weight[:80] = w
    bias = torch.cat([-(w @ mu), torch.tensor([hi], dtype=torch.float64, device=h.device)])
    sd["roi_heads.box_predictor.cls_score.weight"] = weight.float().cpu().numpy()
    sd["roi_heads.box_predictor.cls_score.bias"] = bias.float().cpu().numpy()
    log(f"[det data] classifier calibrated on {len(images_bgr)} images: background logit {hi:.3f}, "
        f"{count(hi, props, valid, h):.2f} detections an image (the fast preset {count(hi, *fast):.2f})")
    return sd


def make_det_data() -> dict:
    """SOA's layout (80 folders ``label_NN_<name>/`` of 4 PNGs), crop's
    source folder of 256 PNGs, and seeded weights (``rpn_gain`` 5, the
    classifier calibrated on the first 16 crop sources) as a detectron2
    ``.pkl``, under build/chip_smoke/det/."""
    from PIL import Image

    t0 = time.perf_counter()
    root = os.path.join(SCRATCH, "det")
    jobs = []
    for label, name in enumerate(COCO_CLASSES):
        folder = os.path.join(root, "soa", f"label_{label:02d}_{name.replace(' ', '_')}")
        os.makedirs(folder)
        jobs += [(os.path.join(folder, f"{j}.png"), 1000 + DET_PER_LABEL * label + j) for j in range(DET_PER_LABEL)]
    os.makedirs(os.path.join(root, "src"))
    jobs += [(os.path.join(root, "src", f"{i:03d}.png"), 5000 + i) for i in range(N_DET_CROP)]
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job: Image.fromarray(det_image(job[1])).save(job[0]), jobs))
    calibration = [predictor.load_bgr_image(os.path.join(root, "src", f"{i:03d}.png"))[0]
                   for i in range(DET_CALIBRATION)]
    sd = calibrated_detector_weights(det_weights.random_detectron2_state_dict(0, rpn_gain=5.0), np.stack(calibration))
    pkl = os.path.join(root, "model_final.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"model": sd}, f)
    log(f"[det data] {len(jobs)} PNGs of {DET_SIDE} x {DET_SIDE} and the seeded detectron2 weights in "
        f"{time.perf_counter() - t0:.1f} s")
    return {"root": root, "soa": os.path.join(root, "soa"), "src": os.path.join(root, "src"), "pkl": pkl}


def host_iou(a: np.ndarray, b: np.ndarray) -> float:
    lt, rb = np.maximum(a[:2], b[:2]), np.minimum(a[2:], b[2:])
    inter = float(np.prod(np.clip(rb - lt, 0, None)))
    union = float(np.prod(a[2:] - a[:2]) + np.prod(b[2:] - b[:2])) - inter
    return inter / max(union, 1e-9)


def det_matched(a: list, b: list, score_tol: float = 0.05, iou_min: float = 0.85) -> float:
    """The share of detections (class, box, score) in ``a`` with a partner
    in ``b``: the same class, scores within ``score_tol``, IoU above
    ``iou_min`` (tests/test_detection.py's rule)."""
    hits = sum(any(ca == cb and abs(sa - sb) <= score_tol and host_iou(ba, bb) > iou_min for cb, bb, sb in b)
               for ca, ba, sa in a)
    return hits / max(len(a), 1)


def det_rows(det: tuple, i: int) -> list:
    """Image ``i``'s valid detections as ((i, class), box, score): pooled
    over images, a detection matches only within its own image."""
    boxes, scores, classes, valid = det
    return [((i, int(classes[i, j])), boxes[i, j], float(scores[i, j])) for j in range(len(valid[i])) if valid[i, j]]


def check_detector_against_cpu(c: dict) -> None:
    """(a) The detector on the card (f32, TF32 off) against the same
    detector on the CPU on 4 images at 800 px: P2..P6 within 1e-3 of each
    map's scale, the 4 images' detections matched >= 0.9 both ways."""
    files = sorted(list_images(c["src"]))[:4]
    u8 = np.stack([predictor.load_bgr_image(f)[0] for f in files])
    card, cpu = predictor.Detector(c["pkl"]), predictor.Detector(c["pkl"], device="cpu")
    t0 = time.perf_counter()
    with torch.inference_mode():
        maps = [(g.float().cpu(), h) for g, h in zip(card.model.features(card._upload(u8)),
                                                      cpu.model.features(cpu._upload(u8)))]
        got, want = card.detect_batch(u8), cpu.detect_batch(u8)
    t_cpu = time.perf_counter() - t0
    errs = [float((g - h).abs().max()) / max(float(h.abs().max()), 1e-12) for g, h in maps]
    card_rows = [r for i in range(len(files)) for r in det_rows(got, i)]
    cpu_rows = [r for i in range(len(files)) for r in det_rows(want, i)]
    shares = det_matched(card_rows, cpu_rows), det_matched(cpu_rows, card_rows)
    log(f"[det card vs cpu] P2..P6 max_abs_err / scale {', '.join(f'{e:.2e}' for e in errs)}; detections a "
        f"image {[int(v.sum()) for v in got[3]]} (card) {[int(v.sum()) for v in want[3]]} (CPU), matched "
        f"{shares[0]:.4f} and {shares[1]:.4f} of them both ways; the CPU forward and both runs {t_cpu:.1f} s")
    require(all(e <= 1e-3 for e in errs), f"FPN maps card vs CPU: {errs}")
    require(len(cpu_rows) > 0, "the CPU detector found nothing")
    require(min(shares) >= 0.9, f"detections card vs CPU matched {shares}")


def soa_from_pickles(det_dir: str) -> str:
    """SOA's result file recomputed here from the per-label pickles.  The
    labels split into top and bottom 40 by image count; where counts tie
    (here every label has 4 images) the reference keeps the order in which
    ``os.listdir`` gives the pickles, and so does this."""
    acc, total = {}, {}
    for name in os.listdir(det_dir):
        if name.startswith("detected_label_"):
            label = int(name[len("detected_label_"):][:2])
            dets = result_io.load_pickle(os.path.join(det_dir, name))
            total[label] = len(dets)
            acc[label] = sum(label in ids for _, ids, _ in dets.values()) / max(len(dets), 1)
    labels = sorted(acc, key=lambda l: total[l])
    n = len(labels)
    soa_c = sum(acc[l] for l in acc) / n
    soa_i = sum(total[l] * acc[l] for l in acc) / max(sum(total.values()), 1)
    top, bot = sum(acc[l] for l in labels[40:]) / (0.5 * n), sum(acc[l] for l in labels[:40]) / (0.5 * n)
    return ("Class average accuracy for all classes (SOA-C) is: {:6.4f} \n".format(soa_c)
            + "Image weighted average accuracy (SOA-I) is: {:6.4f} \n".format(soa_i)
            + "Top (SOA-C-Top40) and Bottom (SOA-C-Bot40) 40 class average accuracy is: "
            "{:6.4f} and {:6.4f}".format(top, bot))


class FailingDetector:
    """A detector that raises on its ``fail_on``-th call."""

    def __init__(self, inner, fail_on: int):
        self.inner, self.fail_on, self.calls = inner, fail_on, 0

    def __call__(self, files):
        self.calls += 1
        if self.calls == self.fail_on:
            raise RuntimeError("injected failure")
        return self.inner(files)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def run_cli(tag: str, main, argv: list, images: int) -> dict:
    """One CLI run from 0 counts: its launches, seconds, images/s, the
    detectors it built and the labels or slabs they were called on."""
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    with recording(predictor, "make_folder_detector") as built, recording(predictor.Detector, "__call__") as calls:
        t0 = time.perf_counter()
        main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    rounds = [r for det in built for r in det.nms_rounds]
    out = {"launches": counts(), "seconds": seconds, "calls": calls, "built": built}
    nms = f"NMS rounds max {max(rounds)} mean {np.mean(rounds):.2f} over {len(rounds)} calls; " if rounds else ""
    log(f"[{tag}] CLI {seconds:.2f} s ({images / seconds:.1f} images/s end to end); {nms}peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches {out['launches']}")
    return out


def path_soa(c: dict) -> list:
    """(b) SOA through ``soa.main`` on the 80 x 4 layout: the result file
    equal to SOA recomputed here from its pickles; a run that fails after 10
    labels, resumed by the same command from the per-label pickles to the
    same bytes with only the 70 missing labels detected; then the same
    layout under ``--precision fast --roi-sampling 1 --proposals 256``, its
    detections matched against the exact run's for the record."""
    n = len(COCO_CLASSES) * DET_PER_LABEL
    runs, texts = [], {}
    for tag, extra in (("exact", []), ("fast", ["--precision", "fast", "--roi-sampling", "1", "--proposals", "256"])):
        det_dir, saved = os.path.join(c["root"], f"soa_{tag}"), os.path.join(c["root"], f"soa_{tag}.txt")
        runs.append(run_cli(f"soa {tag}", soa.main, ["--images", c["soa"], "--detected_results", det_dir,
                                                     "--saved_file", saved, "--weights", c["pkl"], *extra], n))
        with open(saved) as f:
            texts[tag] = f.read()
        log(f"[soa {tag}] {texts[tag]!r}")
        require(texts[tag] == soa_from_pickles(det_dir), f"SOA {tag}: the result file differs from the pickles' SOA")
        require(len(runs[-1]["calls"]) == len(COCO_CLASSES), f"SOA {tag}: one detector call a label")
    exact, fast = os.path.join(c["root"], "soa_exact"), os.path.join(c["root"], "soa_fast")
    pairs = [(result_io.load_pickle(os.path.join(exact, f)), result_io.load_pickle(os.path.join(fast, f)))
             for f in sorted(os.listdir(exact)) if f.startswith("detected_")]
    hits = tot = 0
    for a, b in pairs:
        for name in set(a) | set(b):
            ra = [(i, np.asarray(x), 1.0) for i, x in zip(*a.get(name, [[], [], []])[1:])]
            rb = [(i, np.asarray(x), 1.0) for i, x in zip(*b.get(name, [[], [], []])[1:])]
            hits += det_matched(ra, rb) * len(ra)
            tot += len(ra)
    log(f"[soa fast] {hits / max(tot, 1):.4f} of the exact run's {tot} detections have a partner in the fast run "
        f"(class equal, IoU > 0.85); no bound applies (the fast preset is another result class)")

    det_dir, saved = os.path.join(c["root"], "soa_resumed"), os.path.join(c["root"], "soa_resumed.txt")
    argv = ["--images", c["soa"], "--detected_results", det_dir, "--saved_file", saved, "--weights", c["pkl"]]
    build = predictor.make_folder_detector
    predictor.make_folder_detector = lambda *a, **k: FailingDetector(build(*a, **k), DET_FAIL_AFTER + 1)
    try:
        soa.main(argv)
        raise AssertionError("the failing SOA run did not fail")
    except RuntimeError as e:
        require("injected failure" in str(e), f"the failing SOA run failed otherwise: {e}")
    finally:
        predictor.make_folder_detector = build
    done = len([f for f in os.listdir(det_dir) if f.startswith("detected_")])
    resumed = run_cli("soa resumed", soa.main, argv, n - DET_FAIL_AFTER * DET_PER_LABEL)
    with open(saved) as f:
        text = f.read()
    require(done == DET_FAIL_AFTER and len(resumed["calls"]) == len(COCO_CLASSES) - DET_FAIL_AFTER,
            f"the resumed SOA run detected {len(resumed['calls'])} labels after {done} were saved")
    require(text == texts["exact"], "the resumed SOA run's result file differs from the straight run's")
    return [r["launches"] for r in runs] + [resumed["launches"]]


def crop_count(calls: list) -> int:
    """Valid boxes of at least a pixel each way, over the detector's calls."""
    return sum(1 for preds in calls for _, _, boxes in preds.values() for b in boxes
               if b[2] - b[0] >= 1.0 and b[3] - b[1] >= 1.0)


def path_crops(c: dict, d: dict) -> list:
    """(c) ``crop_objects.main`` on 256 images: 512-4,096 crops, one for
    each valid box of at least a pixel each way; a run killed after its
    first slab of 64 resumed to the same files; then the crops through
    ``o_is.main`` (K1 once and K2 nine times a batch of 32; the value equal
    to the same logits scored on the host) and ``o_fid.main`` against
    crops_b with ``--sqrtm eigh`` (K1 and K2 on both sides), with an 80-class
    trunk calibrated on the first 256 crops (the O-IS trunk of the earlier
    path, calibrated on noise, saturates its softmax on these crops)."""
    dest = os.path.join(c["root"], "crops")
    crop = run_cli("crop", crop_objects.main, ["--source_image_dir", c["src"], "--saved_cropped_object_dir", dest,
                                               "--weights", c["pkl"]], N_DET_CROP)
    files = sorted(os.listdir(dest))
    n = len(files)
    log(f"[crop] {n} crops of {N_DET_CROP} images")
    require(n == crop_count(crop["calls"]), f"{n} crops against {crop_count(crop['calls'])} valid boxes")
    require(512 <= n <= 4096, f"{n} crops: the calibration must give 512-4,096")
    resumed = os.path.join(c["root"], "crops_resumed")
    detector = crop["built"][0]
    try:
        crop_objects.crop_folder(FailingDetector(detector, 2), c["src"], resumed, slab=DET_SLAB)
        raise AssertionError("the killed crop run did not fail")
    except RuntimeError as e:
        require("injected failure" in str(e), f"the killed crop run failed otherwise: {e}")
    first = len(os.listdir(resumed)) - 1  # less the sentinel
    with recording(predictor.Detector, "__call__") as slabs:
        crop_objects.crop_folder(detector, c["src"], resumed, slab=DET_SLAB)
    require(sorted(os.listdir(resumed)) == files and len(slabs) == N_DET_CROP // DET_SLAB - 1,
            f"the resumed crop run ({len(slabs)} slabs after {first} crops) wrote other files")
    log(f"[crop] killed after its first slab of {DET_SLAB} images ({first} crops), resumed to the same {n} files")

    from PIL import Image

    sample = []
    for name in files[:256]:
        with Image.open(os.path.join(dest, name)) as im:
            sample.append(np.asarray(im.convert("RGB")))
    state, _ = calibrated_state(3, 80, sample, "half")  # the head scaled on crops: noise's scale saturates it here
    weights = os.path.join(c["root"], "inception80_crops.pth")
    torch.save(state, weights)
    saved = os.path.join(c["root"], "o_is.txt")
    o_is_run = run_cli("o-is crops", o_is.main, ["--image_dir", dest, "--weights", weights, "--saved_file", saved], n)
    batches = -(-n // 32)
    require(o_is_run["launches"]["normalize"] == batches and o_is_run["launches"]["avg_pool_3x3_s1_p1"] == 9 * batches,
            f"O-IS on the crops: K1 once and K2 9x per batch of 32 ({batches} batches)")
    extractor = o_is.make_logits_extractor(fid.load_weights(weights, "weights"), "cuda")
    logits = extractor.run(ImageFolderLoader.from_dir(dest, 32, fid.IMAGE_SIZE), keys=("logits",))["logits"]
    require(logits.shape == (n, 80), f"O-IS logits {logits.shape}")
    check_score("o-is crops", result_io.read_o_is_result(saved), logits, O_IS_TEMPERATURE)

    saved = os.path.join(c["root"], "o_fid.txt")
    o_fid_run = run_cli("o-fid crops", o_fid.main, ["--path1", dest, "--path2", d["crops_b"], "--weights",
                                                     weights, "--sqrtm", "eigh", "--saved_file", saved],
                        n + N_CROPS)
    with open(saved) as f:
        text = f.read()
    batches = -(-n // BATCH) + -(-N_CROPS // BATCH)
    log(f"[o-fid crops] {text} ({n} crops against {N_CROPS} images)")
    require(text.startswith("O-FID: ") and np.isfinite(result_io.read_fid_result(saved)), "O-FID on the crops")
    require(o_fid_run["launches"]["normalize"] == batches and o_fid_run["launches"]["avg_pool_3x3_s1_p1"] == 9 * batches,
            f"O-FID on the crops: K1 once and K2 9x per batch of {BATCH} ({batches} batches)")
    return [crop["launches"], o_is_run["launches"], o_fid_run["launches"]]


def forward_flops(model: torch.nn.Module, fn) -> dict:
    """The multiply-add operations (2 a MAC) of the convolutions and dense
    layers one call of ``fn`` runs, by top-level part of ``model``."""
    parts = {}

    def hook(name, mod, inputs, out):
        per_out = (mod.in_channels // mod.groups) * mod.kernel_size[0] * mod.kernel_size[1] \
            if isinstance(mod, torch.nn.Conv2d) else mod.in_features
        parts[name] = parts.get(name, 0) + 2 * out.numel() * per_out

    hooks = [mod.register_forward_hook(functools.partial(hook, name.split(".")[0]))
             for name, mod in model.named_modules() if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return parts


DET_STAGES = ("trunk+FPN", "RPN with top-k and NMS", "ROIAlign", "box head and postprocess")


def det_stage_ms(det, u8: np.ndarray, reps: int = 5) -> dict:
    """Each stage of one batch's forward by CUDA events, the median of
    ``reps`` after a warm-up; the NMS loops' waits for the host count in."""
    m, times = det.model, []
    with torch.inference_mode():
        x = det._upload(u8)
        hw = tuple(x.shape[-2:])
        for rep in range(reps + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            feats = m.features(x)
            ev[1].record()
            props, valid = m.proposals(feats, hw)
            ev[2].record()
            roi = m.box_features(feats, props)
            ev[3].record()
            m.detect(roi, props, valid, hw)
            ev[4].record()
            torch.cuda.synchronize()
            if rep:
                times.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
    return {name: statistics.median(t[i] for t in times) for i, name in enumerate(DET_STAGES)}


def det_timings(c: dict) -> None:
    """Where a detection run's time goes: host decode (open, resize to 800,
    BGR) of the 256 crop sources on 8 threads; per batch on the device by
    events, the four stages of the exact preset (f32, batch 4) and of the
    fast one (bf16, batch 32, ROIAlign sampling 1, 256 proposals), beside
    their convolutions' and dense layers' operations over the peak of their
    type (f32 67, bf16 989 TFLOP/s); trunk+FPN in NCHW beside channels
    last (``predictor.MEMORY_FORMAT`` picks the faster by dtype)."""
    files = list_images(c["src"])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        u8 = np.stack([im for im, _ in pool.map(predictor.load_bgr_image, files)])
    log(f"[time det] host decode (open, resize to 800, BGR) {len(files) / (time.perf_counter() - t0):.1f} images/s "
        f"on 8 threads")
    state = det_weights.load_weights(c["pkl"])
    for tag, preset, batch, peak in (("exact", {}, 4, PEAK_F32), ("fast", FAST_PRESET, 32, PEAK_BF16)):
        det = predictor.Detector(state, batch_size=batch, **preset)
        with torch.inference_mode():
            flops = forward_flops(det.model, lambda: det.model(det._upload(u8[:1])))
        ms = det_stage_ms(det, u8[:batch])
        total = sum(ms.values())
        least = sum(flops.values()) * batch / peak * 1e3
        log(f"[time det {tag}] per batch of {batch} on the device (events): " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in ms.items()) + f"; {total:.2f} ms, {batch * 1e3 / total:.1f} images/s; "
            f"{sum(flops.values()) / 1e9:.1f} GFLOP an image (" + ", ".join(
                f"{k} {v / 1e9:.1f}" for k, v in flops.items()) + f"), bound {least:.2f} ms ({least / total:.1%})")
        layouts = {}
        with torch.inference_mode():
            x = det._upload(u8[:batch])
            for name, fmt in (("NCHW", torch.contiguous_format), ("channels last", torch.channels_last)):
                det.model.to(memory_format=fmt)
                xf = x.contiguous(memory_format=fmt)
                layouts[name] = median_ms(lambda: det.model.features(xf), reps=5, inner=2, warmup=1)
        log(f"[time det {tag}] trunk+FPN a batch of {batch}: " + ", ".join(f"{k} {v:.2f} ms" for k, v in layouts.items())
            + f"; the detector runs {'channels last' if det.memory_format == torch.channels_last else 'NCHW'}")
        del det
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 8. the counter and CA: FC-ResNet50 PRM at 448 px
# ---------------------------------------------------------------------------

N_CA = 1024               # CA items, one 256 x 256 PNG each
CA_BATCH = 32             # the CA CLI's default batch
CA_CALIBRATION = 32       # images the counter's classifier is calibrated on
CA_FAIL_ON = 11           # the killed CA run fails on this batch, after its first snapshot (at item 288)
CA_COUNT_SPREAD = 0.5     # the std over images of a class's density mean, in counts


def ca_image(i: int) -> np.ndarray:
    """Seeded CA image i: det_image's blobs on noise, 256 x 256."""
    return det_image(20000 + i)


def counter_input(u8: np.ndarray) -> torch.Tensor:
    """uint8 [B, 448, 448, 3] -> the counter's normalized NCHW input on the card (K1), as CountingEngine makes it."""
    return normalize_kernel(torch.from_numpy(u8).cuda(), "imagenet").permute(0, 3, 1, 2).contiguous()


def calibrated_counter_weights(sd: dict, u8: np.ndarray, seed: int = 0) -> dict:
    """``sd`` (CountSeg layout) with its classifier rebuilt from the card's
    ``res5`` features of ``u8`` (a data-dependent init, as
    calibrated_detector_weights does for the detector).

    The raw random classifier gives each class nearly the same maps on every
    image: counts vary from class to class but hardly from image to image,
    and a CA of such counts says little about the trunk.  Here each class's
    class-response and density maps are seeded random combinations of the 8
    principal directions of the images' spatially averaged ``res5`` (the
    directions in which the images differ most, so that TF32's rounding
    moves them least), the density's spatial mean spread over the images
    with a standard deviation of CA_COUNT_SPREAD counts around an offset
    drawn from [1, 4], and the class-response bias set so that the gate
    opens on 60% of the images (peak stimulation's confidence moves one for
    one with a constant added to the map).  The third block of 80 maps,
    which CA does not read, keeps its random weights."""
    sd = dict(sd)
    model = counter.FCResNet50PRM.from_state_dict(counter.state_dict_from_countseg(sd), "cuda")
    with torch.inference_mode():
        f = torch.cat([model.backbone(counter_input(u8[i:i + CA_BATCH]))["res5"].double()
                       for i in range(0, len(u8), CA_BATCH)])
    g = f.mean(dim=(2, 3))
    gbar = g.mean(0)
    basis = torch.linalg.svd(g - gbar, full_matrices=False).Vh[:8]
    rng = np.random.RandomState(seed)
    v = torch.from_numpy(rng.randn(counter.NUM_CLASSES, len(basis))).to(g) @ basis
    v *= CA_COUNT_SPREAD / ((g - gbar) @ v.T).std(0)[:, None]
    den_bias = torch.from_numpy(rng.uniform(1.0, 4.0, counter.NUM_CLASSES)).to(g) - v @ gbar
    w = torch.from_numpy(rng.randn(counter.NUM_CLASSES, len(basis))).to(g) @ basis
    w /= torch.einsum("ck,nkhw->nchw", w, f).std(dim=(0, 2, 3))[:, None]
    conf0, _ = counter.peak_stimulation(torch.einsum("ck,nkhw->nchw", w, f).float())
    crm_bias = -torch.quantile(conf0.double(), 0.4, dim=0)
    weight, bias = sd["classifier.weight"].copy(), sd["classifier.bias"].copy()
    n = counter.NUM_CLASSES
    weight[:n, :, 0, 0], bias[:n] = w.float().cpu().numpy(), crm_bias.float().cpu().numpy()
    weight[n:2 * n, :, 0, 0], bias[n:2 * n] = v.float().cpu().numpy(), den_bias.float().cpu().numpy()
    sd["classifier.weight"], sd["classifier.bias"] = weight, bias
    model = counter.FCResNet50PRM.from_state_dict(counter.state_dict_from_countseg(sd), "cuda")
    with torch.inference_mode():
        conf, density = model(counter_input(u8[:CA_BATCH]))
    counts = counter.predict_counts(conf.cpu().numpy(), density.cpu().numpy())
    log(f"[ca data] classifier calibrated on {len(u8)} images: counts on them {np.unique(counts).tolist()}, "
        f"gate open {float((conf > 0).float().mean()):.3f}, mean count {counts.mean():.3f}")
    return sd


def make_ca_data() -> dict:
    """N_CA seeded 256 x 256 PNGs named ``<caption_id>.png``, CA items of
    1-3 classes with counts 1-5, and seeded CountSeg-layout weights whose
    classifier is calibrated on the first 32 images, saved with torch.save
    as ``coco14.pt``, under build/chip_smoke/ca/."""
    from PIL import Image

    t0 = time.perf_counter()
    root = os.path.join(SCRATCH, "ca")
    images = os.path.join(root, "images")
    os.makedirs(images)
    ids = [f"{500000 + 3 * i}" for i in range(N_CA)]
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda i: Image.fromarray(ca_image(i)).save(os.path.join(images, f"{ids[i]}.png")), range(N_CA)))
    rng = np.random.RandomState(61)
    items = [{"caption_id": cid, "counting_info": {COCO_CLASSES[k]: int(rng.randint(1, 6)) for k in
                                                   rng.choice(len(COCO_CLASSES), rng.randint(1, 4), replace=False)}}
             for cid in ids]
    calibration = np.stack([load_image(os.path.join(images, f"{ids[i]}.png"), (ca.IMAGE_SIZE,) * 2)
                            for i in range(CA_CALIBRATION)])
    sd = calibrated_counter_weights(counter.random_countseg_state_dict(0), calibration)
    c = {"root": root, "images": images, "items": items, "pkl": os.path.join(root, "ca_input.pkl"),
         "weights": os.path.join(root, "coco14.pt")}
    result_io.save_pickle(c["pkl"], items)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, c["weights"])
    log(f"[ca data] {N_CA} PNGs of 256 x 256, {N_CA} items and the seeded CountSeg weights in "
        f"{time.perf_counter() - t0:.1f} s")
    return c


def check_counter_against_cpu(c: dict) -> None:
    """(a) The CA CLI's engine on the card (K1, f32, TF32 off) against the
    same engine on the CPU on 4 images at 448: confidence and density within 1e-4 of
    each one's scale, and the counts equal wherever the gate and the
    rounding are 1e-3 clear of their boundaries on the CPU."""
    state = counter.load_counter_weights(c["weights"])
    u8 = np.stack([load_image(os.path.join(c["images"], f"{it['caption_id']}.png"), (ca.IMAGE_SIZE,) * 2)
                   for it in c["items"][:4]])
    t0 = time.perf_counter()
    card = [t.cpu() for t in ca.CountingEngine(state, "cuda").dispatch(u8)]
    cpu = ca.CountingEngine(state, "cpu").dispatch(u8)
    errs = [float((g - h).abs().max()) / max(float(h.abs().max()), 1e-12) for g, h in zip(card, cpu)]
    conf, density = (t.numpy() for t in cpu)
    means = density.mean(axis=(2, 3))
    clear = (np.abs(conf) > 1e-3) & (np.abs(means - np.floor(means) - 0.5) > 1e-3)
    got, want = (counter.predict_counts(a.numpy(), b.numpy()) for a, b in (card, cpu))
    log(f"[ca card vs cpu] confidence and density max_abs_err / scale {errs[0]:.2e}, {errs[1]:.2e}; counts equal on "
        f"{int((got == want)[clear].sum())} of the {int(clear.sum())} entries clear of a boundary "
        f"({int((got == want).sum())} of {got.size} in all); the CPU forward and both runs "
        f"{time.perf_counter() - t0:.1f} s")
    require(all(e <= 1e-4 for e in errs), f"the counter card vs CPU: {errs}")
    require(bool((got == want)[clear].all()), "counts card vs CPU where clear of a boundary")


def ca_from_counts(items: list, counts: np.ndarray) -> str:
    """The CA result file recomputed here from per-item counts."""
    preds = [{COCO_CLASSES[k]: float(v) for k, v in enumerate(row) if v} for row in counts]
    return f"CA = {float(np.mean([ca.rmse_for_item(p, it['counting_info']) for p, it in zip(preds, items)]))}"


def path_ca(c: dict) -> list:
    """(b) CA through ``ca.main`` on the N_CA items: ``--precision highest``,
    its result file equal to CA recomputed here from the counts it made
    (which must take at least 3 values where the gate is open, with the gate
    both open and shut), K1 once a batch; ``--precision fast`` (TF32 inside
    the forward), whose counts on the items' classes must equal highest's
    on at least 99% of the items; then a run that fails on its 11th batch,
    after its first snapshot, resumed by the same command to the same bytes
    from the snapshot's cursor."""
    argv = ["--image_dir", c["images"], "--ct_input_file", c["pkl"], "--weights", c["weights"]]
    batches = -(-N_CA // CA_BATCH)
    texts, seen = {}, {}
    runs = []
    for tag, extra in (("highest", []), ("fast", ["--precision", "fast"])):
        saved = os.path.join(c["root"], f"ca_{tag}.txt")
        with recording(counter, "peak_stimulation") as peaks, recording(counter, "predict_counts") as counted:
            runs.append(run_cli(f"ca {tag}", ca.main, argv + ["--result_file", saved, *extra], N_CA))
        with open(saved) as f:
            texts[tag] = f.read()
        seen[tag] = (torch.cat([conf for conf, _ in peaks]).cpu().numpy(), np.concatenate(counted))
        log(f"[ca {tag}] {texts[tag]!r}")
        require(runs[-1]["launches"]["normalize"] == batches, f"CA {tag}: K1 once a batch of {CA_BATCH}")
        require(texts[tag] == ca_from_counts(c["items"], seen[tag][1]), f"CA {tag}: the result differs from its counts'")
    conf, counts = seen["highest"]
    open_counts = np.unique(counts[conf > 0])
    log(f"[ca highest] counts where the gate is open {open_counts.tolist()}; gate open on {float((conf > 0).mean()):.3f} "
        f"of the entries; mean count {counts.mean():.3f}")
    require(len(open_counts) >= 3 and (conf > 0).any() and (conf <= 0).any(),
            "the counts must take at least 3 values with the gate open, and the gate must be shut somewhere")
    classes = [[COCO_CLASSES.index(name) for name in it["counting_info"]] for it in c["items"]]
    fast_conf, fast = seen["fast"]
    share = float(np.mean([np.array_equal(counts[i, k], fast[i, k]) for i, k in enumerate(classes)]))
    log(f"[ca fast] counts on the items' classes equal to highest's on {share:.4f} of the items; "
        f"{float((counts == fast).mean()):.5f} of all {counts.size} entries equal, the gate on "
        f"{float(((conf > 0) == (fast_conf > 0)).mean()):.5f}")
    require(share >= 0.99, f"CA fast agrees with highest on {share} of the items")

    snap = os.path.join(c["root"], "ca.snapshot.npz")
    saved = os.path.join(c["root"], "ca_resumed.txt")
    dispatch, calls = ca.CountingEngine.dispatch, []

    def failing(self, images_u8):
        calls.append(len(images_u8))
        if len(calls) == CA_FAIL_ON:
            raise RuntimeError("injected failure")
        return dispatch(self, images_u8)

    ca.CountingEngine.dispatch = failing
    try:
        ca.main(argv + ["--result_file", saved, "--snapshot_file", snap])
        raise AssertionError("the failing CA run did not fail")
    except RuntimeError as e:
        require("injected failure" in str(e), f"the failing CA run failed otherwise: {e}")
    finally:
        ca.CountingEngine.dispatch = dispatch
    with np.load(snap) as z:
        cursor = int(z["cursor"])
    resumed = run_cli("ca resumed", ca.main, argv + ["--result_file", saved, "--snapshot_file", snap], N_CA - cursor)
    with open(saved) as f:
        text = f.read()
    log(f"[ca resumed] failed on batch {CA_FAIL_ON} after a snapshot at item {cursor}; resumed: {text!r}")
    require(cursor == 288 and not os.path.exists(snap), f"the CA snapshot's cursor {cursor}")
    require(resumed["launches"]["normalize"] == -(-(N_CA - cursor) // CA_BATCH), "the resumed CA run counted again")
    require(text == texts["highest"], "the resumed CA run's result differs from the straight run's")
    return [r["launches"] for r in runs] + [resumed["launches"]]


def ca_timings(c: dict) -> dict:
    """Where a CA run's time goes: host decode (open, PIL resize 256 -> 448)
    of 256 PNGs on 8 threads; per batch of 32 on the device by events, the
    counter's forward in f32 (NCHW and channels last) and under TF32, peak
    stimulation alone on [32, 80, 14, 14], K1 under ``imagenet``; beside the
    convolutions' operations over the f32 peak.  Returns what the device
    times need."""
    files = [os.path.join(c["images"], f"{it['caption_id']}.png") for it in c["items"][:256]]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        u8 = np.stack(list(pool.map(lambda f: load_image(f, (ca.IMAGE_SIZE,) * 2), files)))
    decode = len(files) / (time.perf_counter() - t0)
    model = counter.FCResNet50PRM.from_state_dict(counter.load_counter_weights(c["weights"]), "cuda")
    with torch.inference_mode():
        x = counter_input(u8[:CA_BATCH])
        flops = sum(forward_flops(model, lambda: model(x[:1])).values())
        ms = {}
        for name, fmt in (("f32 NCHW", torch.contiguous_format), ("f32 channels last", torch.channels_last)):
            model.to(memory_format=fmt)
            xf = x.contiguous(memory_format=fmt)
            ms[name] = median_ms(lambda: model(xf), reps=5, inner=2, warmup=1)
        model.to(memory_format=torch.contiguous_format)
        with tf32_forward(True):
            ms["TF32 NCHW"] = median_ms(lambda: model(x), reps=5, inner=2, warmup=1)
        crm = model.classifier(model.backbone(x)["res5"])[:, :counter.NUM_CLASSES].contiguous()
        ms["peak stimulation"] = median_ms(lambda: counter.peak_stimulation(crm), reps=5, inner=10)
        u8_dev = torch.from_numpy(u8[:CA_BATCH]).cuda()
        ms["K1 imagenet"] = median_ms(lambda: normalize_kernel(u8_dev, "imagenet"))
    least = flops * CA_BATCH / PEAK_F32 * 1e3
    log(f"[time ca] host decode (open, resize 256 -> 448) {decode:.1f} images/s on 8 threads; per batch of {CA_BATCH} "
        f"on the device (events): " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
        + f"; {flops / 1e9:.2f} GFLOP an image, f32 bound {least:.2f} ms ({least / ms['f32 NCHW']:.1%} of NCHW)")
    return {"model": model, "x": x, "crm": crm, "events_ms": ms, "flops": flops}


# ---------------------------------------------------------------------------
# 9. the COCO track runner: nine stages, the methods JSON and the RS table
# ---------------------------------------------------------------------------

N_COCO_RUN = 256          # the runner's images: the first CA items'
#: BASELINE.md's 11 published methods (the reference's COCO table), ranked beside the smoke's
PUBLISHED = {"GAN-CLS": (8.10, 192.09, 10.00, 5.31, 5.71, 2.46, 51.13, 2.51, 32.79),
             "StackGAN": (15.50, 53.44, 9.10, 9.24, 9.90, 3.36, 29.09, 2.41, 34.33),
             "AttnGAN": (33.79, 36.90, 50.56, 47.13, 49.78, 5.04, 20.92, 1.82, 40.08),
             "DM-GAN": (45.63, 28.96, 66.98, 55.77, 58.11, 5.22, 17.48, 1.71, 42.83),
             "CPGAN": (59.64, 50.68, 69.08, 81.86, 83.83, 6.38, 20.07, 2.07, 43.28),
             "DF-GAN": (30.45, 21.05, 42.44, 37.85, 40.19, 5.12, 14.39, 1.96, 40.39),
             "AttnGAN + CL": (36.85, 26.93, 57.52, 47.45, 49.33, 4.92, 19.92, 1.72, 43.92),
             "DM-GAN + CL": (46.61, 22.60, 70.36, 58.68, 61.05, 5.09, 15.50, 1.66, 49.06),
             "DALLE-Mini": (19.82, 62.90, 48.72, 26.64, 27.90, 4.10, 23.83, 2.31, 47.39),
             "AttnGAN++": (54.63, 26.58, 72.48, 67.83, 69.97, 6.01, 15.43, 1.57, 47.75),
             "Real-Images": (51.25, 2.62, 83.54, 90.02, 91.19, 8.63, 0.00, 1.05, 100.0)}


def make_coco_layout(d: dict, clip: dict, det: dict, cad: dict) -> dict:
    """The reference's COCO layout under build/chip_smoke/coco/, from the
    earlier phases' data and weights (hard links): the first 256 CA images
    and their CA items; RP items for them over the CLIP phase's captions; the
    PA phase's pickle and phrase folders; the first image of each of SOA's
    80 label folders; as ``coco_val.npz`` the statistics of path_fid_f32's
    20,480 images of side a (with 256 images a side both covariances are
    singular and ``scipy``'s square root of their product comes out complex:
    the FID CLI refuses it, in the JAX package too) and
    ``cropped_object_coco.npz`` from crops_b through the O-FID CLI; the FID,
    crop-calibrated 80-class, CLIP (as the ``.npz`` sibling), merge table
    (gzipped), detector and counter weights; the IS* COCO trunk of the
    earlier paths with its head scaled to logits of order 1 on these images
    (the scale set on 64 x 64 noise saturates the softmax here and IS* comes
    out NaN); and a methods dir of the 11 published methods."""
    import gzip

    t0 = time.perf_counter()
    root = os.path.join(SCRATCH, "coco")
    data, weights = os.path.join(root, "data"), os.path.join(root, "weights")
    images, soa_root = os.path.join(root, "images"), os.path.join(root, "soa")
    os.makedirs(images)

    def place(base: str, rel: str) -> str:
        path = os.path.join(base, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path

    items = cad["items"][:N_COCO_RUN]
    for it in items:
        name = f"{it['caption_id']}.png"
        os.link(os.path.join(cad["images"], name), os.path.join(images, name))
    for folder in sorted(os.listdir(det["soa"])):
        os.makedirs(os.path.join(soa_root, folder))
        os.link(os.path.join(det["soa"], folder, "0.png"), os.path.join(soa_root, folder, "0.png"))
    rng, caps = np.random.RandomState(51), clip["captions"]
    rp_items = []
    for it in items:
        gt = rng.randint(len(caps))
        others = rng.randint(len(caps) - 1, size=99)
        others += others >= gt
        rp_items.append({"caption_id": it["caption_id"], "caption": caps[gt],
                         "mismatched_captions": [caps[j] for j in others]})
    result_io.save_pickle(place(data, benchmark.DATA["coco_rp_captions"]), rp_items)
    result_io.save_pickle(place(data, benchmark.DATA["ca_captions"]), items)
    os.link(clip["pa"], place(data, benchmark.DATA["pa_captions"]))
    w80 = os.path.join(det["root"], "inception80_crops.pth")  # path_crops' crop-calibrated 80-class trunk
    os.link(os.path.join(SCRATCH, "a.npz"), place(data, benchmark.DATA["coco_fid_stats"]))
    o_fid.main(["--path1", d["crops_b"], "--save_stats", place(data, benchmark.DATA["o_fid_stats"]), "--weights", w80])
    for key, src in (("inception", d["weights"]), ("inception_80", w80), ("detector_soa", det["pkl"]),
                     ("detector_crop", det["pkl"]), ("counter", cad["weights"])):
        os.link(src, place(weights, benchmark.WEIGHTS[key]))
    norm = mean_pool3_norm(d["state_is"], np.stack([ca_image(i) for i in range(128)]), "is_star_2015")
    np.savez(place(weights, benchmark.WEIGHTS["inception_2015"]),
             **tf_layout_vars(d["state_is"], "2015", seed=22, head_std=1.0 / norm))
    os.link(clip["weights"], place(weights, os.path.splitext(benchmark.WEIGHTS["clip"])[0] + ".npz"))
    with open(clip["bpe"], "rb") as f, gzip.open(place(weights, benchmark.WEIGHTS["clip_bpe"]), "wb") as g:
        g.write(f.read())
    methods = os.path.join(root, "methods")
    os.makedirs(methods)
    for name, vals in PUBLISHED.items():
        with open(os.path.join(methods, f"{name}.json"), "w") as f:
            json.dump(dict(zip(ranking_score.METRICS, vals)), f)
    log(f"[coco layout] {N_COCO_RUN} images and items, {len(os.listdir(soa_root))} SOA folders, both statistics and "
        f"the weights in {time.perf_counter() - t0:.1f} s")
    return {"root": root, "images": images, "soa": soa_root, "pa": clip["images"], "data": data, "weights": weights,
            "methods": methods, "results": os.path.join(root, "results")}


def path_coco_runner(lay: dict) -> list:
    """``benchmark.main(["--track", "coco", ...])`` over the layout: all nine
    stages run (no FAIL, no SKIP), every value finite, the methods JSON their
    2-decimal rounding, the RS table the port's ranking of the methods dir
    with the run among the 11 published methods; then a ``--resume`` that
    parses all nine and launches nothing; then ``crop.done`` deleted and a
    ``--resume`` in which crop runs again and so do O-IS and O-FID, to the
    same values.  Returns the launches of the two runs that ran stages."""
    argv = ["--track", "coco", "--method_name", "smoke", "--images", lay["images"], "--soa_images", lay["soa"],
            "--pa_images", lay["pa"], "--data_root", lay["data"], "--weights_root", lay["weights"],
            "--output_root", lay["results"], "--methods_dir", lay["methods"]]
    values, text, launches, _ = run_runner("coco runner run", argv)
    out = os.path.join(lay["results"], "smoke")
    with open(os.path.join(out, "timings.json")) as f:
        log(f"[coco runner] values {values}; stage wall-clock (s) {json.load(f)}")
    require("FAIL" not in text and "SKIP" not in text, "the COCO runner reported a FAIL or a SKIP")
    require(set(values) == set(ranking_score.METRICS) and all(np.isfinite(v) for v in values.values()),
            f"the COCO runner's values {values}")
    with open(os.path.join(lay["methods"], "smoke.json")) as f:
        require(json.load(f) == {m: round(values[m], 2) for m in ranking_score.METRICS}, "the methods JSON")
    with open(os.path.join(lay["results"], "benchmark_results.txt")) as f:
        table = f.read()
    log("[coco runner] RS table:\n" + table)
    require(table == ranking_score.render_table(ranking_score.load_method_scores(lay["methods"]))
            and "| smoke " in table and len(table.splitlines()) == len(PUBLISHED) + 5, "the RS table")
    require(launches["normalize"] > 0 and launches["avg_pool_3x3_s1_p1"] > 0, "the COCO runner launched K1 and K2")
    again, text, quiet, _ = run_runner("coco runner --resume", argv + ["--resume"])
    require(text.count("[benchmark] RESUME") == 9 and "[benchmark] RUN" not in text, "--resume ran a stage again")
    require(again == values and not any(quiet.values()), "--resume changed a value or launched a kernel")
    os.remove(os.path.join(out, "crop.done"))
    again, text, rerun, _ = run_runner("coco runner --resume without crop.done", argv + ["--resume"])
    ran = [line.split()[2] for line in text.splitlines() if line.startswith("[benchmark] RUN ")]
    require(ran == ["crop", "o_is", "o_fid"] and "RESUME o_is skipped (upstream re-ran: crop)" in text,
            f"without crop.done the resumed runner ran {ran}")
    require(all(again[m] == values[m] for m in values if m not in ("O-IS", "O-FID"))
            and all(abs(again[m] - values[m]) <= 1e-6 * abs(values[m]) for m in ("O-IS", "O-FID")),
            f"the rerun of crop, O-IS and O-FID changed a value: {again} against {values}")
    require(rerun["normalize"] > 0 and rerun["avg_pool_3x3_s1_p1"] > 0, "O-IS and O-FID ran again on the card")
    return [launches, rerun]


L2_BYTES = 50 * 2 ** 20  # the L2 cache of one H100 SXM (NVIDIA's data sheet)


def cold_device_us(fn, empty, calls: int = 20):
    """Device time of one call of ``fn`` with ``empty()`` (an L2 flush) run
    before it: the sum of the kernels that torch.profiler records, less the
    kernels that ``empty`` launches on its own; or None where it records
    none."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(body) -> dict:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                body()
            torch.cuda.synchronize()
        return {e.key: getattr(e, "device_time_total", 0) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}

    fn()
    empty()
    torch.cuda.synchronize()
    flush_kernels = set(kernels(empty))
    require(bool(flush_kernels), "torch.profiler recorded no kernel of the L2 flush")
    for _ in range(PROFILE_TRIES):
        total = sum(t for k, t in kernels(lambda: (empty(), fn())).items() if k not in flush_kernels)
        if total > 0:
            return total / calls
    return None


def cub_device_times(gen: torch.Generator, half: dict, floor_us: float, t: dict) -> None:
    """K1 under ``half`` on the device (required), beside its bound, in launch
    floors and beside ``torch.addcmul``: as every kernel is read here, with
    the same buffers call after call, and with the L2 cache emptied before
    each call by a read of 256 MB; the K1 cases of NORMALIZE_TIMED under
    ``clip`` cold as well.  Their bytes fit in L2, where the repeated calls
    find them.  Then the DAMSM image and text encoders a block of 32 on the
    device beside their time by events.  Run last, with
    probe_device_times."""
    flush = torch.zeros(64 * 2 ** 20, device="cuda")  # 256 MB of f32
    empty = lambda: flush.sum()  # noqa: E731
    require(cold_device_us(lambda: None, empty) is None, "the L2 flush is counted as the call")
    cases = [(f"half float32 {list(half['x'].shape)}", half["x"], "half", torch.float32, half["library"])]
    xs = normalize_inputs(gen)
    cases += [(f"{recipe} {str(dtype)[6:]} {list(xs[label].shape)}", xs[label], recipe, dtype,
               normalize_library_call(recipe, dtype)) for label, recipe, dtype in NORMALIZE_TIMED if recipe == "clip"]
    for label, x, recipe, dtype, library in cases:
        require(normalize_bytes(x, dtype) <= L2_BYTES, f"K1 {label} does not fit in L2")
        least = bound(normalize_bytes(x, dtype))["bound_ms"]
        if recipe == "half":
            warm, lib_warm = device_us(lambda: normalize_kernel(x, recipe, dtype)), device_us(lambda: library(x))
            require(warm is not None, f"torch.profiler recorded no K1 kernel at {label} in {PROFILE_TRIES} runs")
            log(f"[K1 normalize] {label} on the device (torch.profiler), the same buffers call after call: "
                f"{against(warm, least)}, {warm / floor_us:.2f} launch floors; torch.addcmul "
                f"{'not measured' if lib_warm is None else f'{lib_warm / 1e3:.5f} ms'}")
        cold = cold_device_us(lambda: normalize_kernel(x, recipe, dtype), empty)
        require(cold is not None, f"torch.profiler recorded no K1 kernel at {label} in {PROFILE_TRIES} runs")
        lib_cold = cold_device_us(lambda: library(x), empty)
        log(f"[K1 normalize] {label} on the device (torch.profiler), L2 emptied by a 256 MB read before each "
            f"call: {against(cold, least)}, {cold / floor_us:.2f} launch floors; torch.addcmul "
            f"{'not measured' if lib_cold is None else f'{lib_cold / 1e3:.5f} ms'}")
    del flush
    s = t["scorer"]
    with torch.inference_mode():
        for name, fn in (("image encoder", lambda: s.image_codes(t["x"])),
                         ("text encoder", lambda: s.sentence_codes(t["tokens"], t["lens"]))):
            us = device_us(fn, calls=4)
            log(f"[time rp-cub] {name} on the device (torch.profiler): "
                f"{'not measured' if us is None else f'{us / 1e3:.3f} ms'} against {t['events_ms'][name]:.3f} ms "
                f"by events")


def ca_device_times(gen: torch.Generator, floor_us: float, t: dict) -> None:
    """K1 under ``imagenet`` at CA's f32 [32, 448, 448, 3] on the device
    (required), read cold: its 96.3 MB do not fit in L2, which is emptied by
    a 256 MB read before each call as well; beside torch.addcmul's time, its
    bytes bound and in launch floors.  Then the counter's forward and peak
    stimulation a batch of 32 on the device, beside their times by events.
    Run last, with probe_device_times."""
    x = torch.randint(0, 256, (CA_BATCH, ca.IMAGE_SIZE, ca.IMAGE_SIZE, 3), generator=gen, device="cuda",
                      dtype=torch.uint8)
    require(normalize_bytes(x, torch.float32) > L2_BYTES, "K1 at CA's shape fits in L2")
    flush = torch.zeros(64 * 2 ** 20, device="cuda")  # 256 MB of f32
    empty = lambda: flush.sum()  # noqa: E731
    library = normalize_library_call("imagenet")
    least = bound(normalize_bytes(x, torch.float32))["bound_ms"]
    cold = cold_device_us(lambda: normalize_kernel(x, "imagenet"), empty)
    require(cold is not None, f"torch.profiler recorded no K1 kernel at CA's shape in {PROFILE_TRIES} runs")
    lib_cold = cold_device_us(lambda: library(x), empty)
    log(f"[K1 normalize] imagenet float32 {list(x.shape)} on the device (torch.profiler), cold (L2 emptied before "
        f"each call): {against(cold, least)}, {cold / floor_us:.2f} launch floors; torch.addcmul "
        f"{'not measured' if lib_cold is None else f'{lib_cold / 1e3:.5f} ms'}")
    del flush
    with torch.inference_mode():
        for name, key, fn in (("counter forward", "f32 NCHW", lambda: t["model"](t["x"])),
                              ("peak stimulation", "peak stimulation", lambda: counter.peak_stimulation(t["crm"]))):
            us = device_us(fn, calls=4)
            log(f"[time ca] {name} a batch of {CA_BATCH} on the device (torch.profiler): "
                f"{'not measured' if us is None else f'{us / 1e3:.3f} ms'} against {t['events_ms'][key]:.3f} ms "
                f"by events")


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
    c = make_clip_data()
    per_path += [path_rp(c), path_pa(c)]
    towers = clip_checks(c)
    t_cub = time.perf_counter()
    half = check_normalize_half(gen)
    cub = make_cub_data(d)
    card = check_damsm_encoders(cub)
    rp_paths, rp_text = path_rp_cub(cub, card)
    per_path += rp_paths
    encoders = cub_timings(cub, card)
    per_path += path_cub_runner(cub, rp_text)
    log(f"[cub] the CUB track's phases took {time.perf_counter() - t_cub:.1f} s")
    t_det = time.perf_counter()
    det = make_det_data()
    check_detector_against_cpu(det)
    per_path += path_soa(det)
    crops = path_crops(det, d)
    per_path += crops
    det_timings(det)
    log(f"[det] K1 and K2 launched on the detector's crops: " + ", ".join(
        f"{tag} {p['normalize']} and {p['avg_pool_3x3_s1_p1']}" for tag, p in zip(("O-IS", "O-FID"), crops[1:])))
    log(f"[det] the detection phase took {time.perf_counter() - t_det:.1f} s")
    t_ca = time.perf_counter()
    cad = make_ca_data()
    check_counter_against_cpu(cad)
    per_path += path_ca(cad)
    counter_t = ca_timings(cad)
    log(f"[ca] the CA phase took {time.perf_counter() - t_ca:.1f} s")
    t_coco = time.perf_counter()
    per_path += path_coco_runner(make_coco_layout(d, c, det, cad))
    log(f"[coco] the COCO runner phase took {time.perf_counter() - t_coco:.1f} s")
    shutil.rmtree(SCRATCH)
    pool_device_times(gen)
    epilogue_device_times(gen)
    floor_us = launch_floor()
    normalize_device_times(gen, floor_us)
    probe_device_times(floor_us)
    clip_device_times(towers)
    cub_device_times(gen, half, floor_us, encoders)
    ca_device_times(gen, floor_us, counter_t)
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
