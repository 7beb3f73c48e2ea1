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

  * FID (``metrics.fid.main``) on two seeded folders of 8,192 PNGs: each
    folder's statistics with ``--save_stats``, the distance from them with
    ``--sqrtm ns-pallas`` and again with ``--sqrtm scipy``, and a short
    O-FID pass through the same engine;
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
    first 64 with ``--no-dedup-text`` (the same success bits); PA on 4
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
    weights (128 images; FID and O-FID by ``--sqrtm eigh``): all nine
    stages, the methods JSON and the RS table
    with the 11 published methods; a ``--resume`` that parses every stage;
    and a ``--resume`` without ``crop.done``, in which crop, O-IS and O-FID
    run again;
  * the image-generation path with seeded weights whose BatchNorm moments
    come from one train-mode batch, a synthesised vocabulary of the COCO
    size (27,297 words) and the seeded DAMSM text encoder: AttnGAN++ and
    CounterModel at the COCO eval width (gf 64, R_NUM 3, 256 px) on the card
    against the CPU on 4 captions, every scale; ``models.generate.main`` in
    flat mode on 1,024 captions (gf 64) under two seeds, timed end to end
    and split into the text encoder, G and PNG writing; its soa and pa
    layouts and ``models.gen_example.main``, file for file; the flat
    folders through the f32 FID (against each other) and IS* COCO CLIs,
    with K1 and K2 counted; gen_bench's chain at batch 64 by events and on
    the device beside its operations; and one ``calibration.cli`` run on
    seeded logits with a planted temperature;
  * AttnGAN++ training: K2's backward against autograd of its plain version
    at the DAMSM trunk's six pool shapes at batch 64 (f32 and bf16, both
    count modes); the DAMSM image encoder's input gradient through K2 and
    its backward against the same with the plain pools on the card; one
    train step at gf 16, batch 4 on the card against the CPU, refereed by a
    float64 CPU step; ``models.main`` at the published COCO width (gf 64,
    df 32, R_NUM 3, 256 px, batch 64) over a layout of 256 seeded JPEGs with
    captions of the COCO-size vocabulary and the seeded DAMSM encoders as
    ``.pth`` files: 2 epochs with a snapshot each and a resume for a third,
    then the generate CLI on the EMA ``.npz``, in f32 and under
    ``--encoder_precision fast``; the step's time by events and on the
    device, its operations, peak memory and the host's wait for data;
  * DAMSM pretraining and CounterModel training over a CUB-style layout
    (256 + 64 seeded JPEGs cropped to their boxes, 10 captions each of a
    5,450-word vocabulary): one pretraining step (full width, batch 4) and
    one counter step (gf 16, batch 4) on the card against the CPU, refereed
    by float64; ``models.damsm_pretrain.main`` at full width and batch 64
    from seeded encoders (2 epochs with validation and a resume), then
    ``models.main --model counter_model`` at the JAX CLI's defaults (gf 128,
    df 64, R_NUM 2, batch 64, lambda 5) from the pretrained best encoders
    (2 epochs and a resume), the generate CLI on its EMA snapshot; each
    step's time by events and on the device, its operations and peak
    memory;
  * two ranks on the one card, fresh processes of this script
    (``--rank R --world 2 --port P``) joined by ``torch.distributed``: the
    f32 FID CLI on 2 x 1,024 of the FID images and RP-COCO on 512 CLIP
    items with ``--coordinator``, each rank's result file byte-equal to a
    one-process run; the sharded AttnGAN++ step
    (``trainer.make_sharded_train_step``) at the published COCO width and a
    global batch of 64, 32 a rank, 2 steps over gloo (the ranks share the
    card), held to the one-process step with the same step without cuDNN as
    the referee of f32 rounding, both ranks ending with the same state; one
    step through a one-rank NCCL group held the same way; the backends,
    each rank's seconds by stage, the step's time by events and peak
    memory.

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
beside their library calls) come after every other timing of this process, so
that a reader can tell the host's share from the device's; only the
two-rank phase follows them, whose ranks are fresh processes.

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
from tise_tpu_torch.backbones import clip_vit, counter, damsm, inception_slim, inception_v3
from tise_tpu_torch.backbones.clip_tokenizer import SimpleTokenizer
from tise_tpu_torch.backbones.detection import predictor, rcnn
from tise_tpu_torch.backbones.detection import weights as det_weights
from tise_tpu_torch.backbones.detection.coco_classes import COCO_CLASSES
from tise_tpu_torch.backbones.inception_v3 import BasicConv2d, InceptionV3, random_state_dict
from tise_tpu_torch.calibration import cli as calib_cli
from tise_tpu_torch.core import io as result_io
from tise_tpu_torch.core.config import (IS_STAR_TEMPERATURE_COCO, IS_STAR_TEMPERATURE_CUB, NUM_SPLITS,
                                        O_IS_TEMPERATURE, PA_SUCCESS_THRESHOLD, configure_precision,
                                        tf32_forward)
from tise_tpu_torch.core.data import BICUBIC, ImageFolderLoader, center_crop_resize, list_images, load_image
from tise_tpu_torch.metrics import ca, crop_objects, fid, is_star, o_fid, o_is, pa, rp_coco, rp_cub, soa
from tise_tpu_torch.metrics.clip_scorer import ClipPairScorer
from tise_tpu_torch.models import damsm_pretrain, gen_bench, gen_example, generate
from tise_tpu_torch.models import main as train_main
from tise_tpu_torch.models import weights as g_weights
from tise_tpu_torch.models.attngan_pp import trainer
from tise_tpu_torch.models.attngan_pp.generator import GanConfig
from tise_tpu_torch.models.counter_model import trainer as counter_trainer
from tise_tpu_torch.ops import fast_pool, native, sqrtm, stats
from tise_tpu_torch.ranking import ranking_score
from tise_tpu_torch.ops.fast_pool import (avg_pool_backward_kernel, avg_pool_backward_plain, avg_pool_kernel,
                                          avg_pool_plain)
from tise_tpu_torch.ops.pallas_kernels import (KERNEL_INSTANCES, epilogue_matmul_instance, epilogue_matmul_kernel,
                                               epilogue_matmul_plain, newton_schulz_sqrtm_pallas)
from tise_tpu_torch.ops.preprocess import RECIPES, normalize_kernel, normalize_plain, resize_and_normalize
from tise_tpu_torch.tools import mosaic_probe, stem_mm_probe
from tise_tpu_torch.tools.kernel_compare import (POOL_SHAPES, PROFILE_TRIES, STEM_NSTEPS, THIN_POOL_SHAPES, device_us,
                                                 host_us, whole)


ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(ROOT, "build", "chip_smoke")
# per side: four times the 2048 features, so each sample covariance keeps
# its smallest eigenvalues within about a quarter of the population's
# (Marchenko–Pastur: (1 - 4^-1/2)^2) and f32 Newton–Schulz converges on it
N_IMAGES = 8192
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
    # K2's backward (its adjoint mode where the padding is not counted); the Pallas pool has none
    "avg_pool_3x3_s1_p1_backward": (avg_pool_backward_kernel, "cuda", "tise_tpu_torch/csrc/avg_pool3x3.cu",
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


def required_us(fn, what: str, calls: int = 20) -> tuple:
    """(µs of one call, where it was read) for a reading the run requires:
    from torch.profiler (``device_us``), or, where the profiler records no
    kernel in PROFILE_TRIES runs, from CUDA events (``median_ms``, launch
    gaps included), which the line then names."""
    us = device_us(fn, calls=calls)
    if us is not None:
        return us, "torch.profiler"
    log(f"[profiler] recorded no kernel of {what} in {PROFILE_TRIES} profiled runs: timed by CUDA events instead")
    return median_ms(fn) * 1e3, "CUDA events: torch.profiler recorded none"


def warm_profiler() -> None:
    """torch.profiler, late in this process, has come back without device
    rows (PERF.md §6): empty PyTorch's cache of
    device memory (the training phases leave most of the card reserved),
    then profile one small kernel, one session at a time, until three
    sessions in a row record it (at most 20); say how many came back empty
    and what was free on the card."""
    from torch.profiler import ProfilerActivity, profile

    free0, reserved0 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    free1 = torch.cuda.mem_get_info()[0]
    x = torch.randn(1024, 1024, device="cuda")
    sessions = empty = streak = 0
    while streak < 3 and sessions < 20:
        sessions += 1
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            x.mul(2.0)
            torch.cuda.synchronize()
        seen = any(getattr(e, "device_time_total", 0) > 0 for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        streak, empty = (streak + 1, empty) if seen else (0, empty + 1)
    log(f"[profiler] warm-up: {empty} of {sessions} sessions came back without device rows; the card had "
        f"{free0 / 2 ** 30:.2f} GiB free with {reserved0 / 2 ** 30:.2f} GiB in PyTorch's cache, {free1 / 2 ** 30:.2f} "
        f"GiB free after emptying it")


def pool_device_times(gen: torch.Generator) -> None:
    """K2's duration on the device from torch.profiler: each trunk and thin
    shape, the nine pools of a batch and the nine thin pools, against their
    bytes bounds.  Run with probe_device_times."""
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
    beside ``torch.addmm``'s, against its operations bound (required: CUDA
    events stand in where the profiler records none).  Run with
    probe_device_times."""
    n = 2048
    a, b = (torch.randn(n, n, generator=gen, device="cuda") for _ in range(2))
    eye = 1.5 * torch.eye(n, device="cuda")
    us, src = required_us(lambda: epilogue_matmul_kernel(a, b, 1.5, -0.5), "K3", calls=5)
    lib_us = device_us(lambda: torch.addmm(eye, a, b, beta=1.0, alpha=-0.5), calls=5)
    log(f"[K3 epilogue_matmul] n=2048 on the device ({src}): "
        f"{against(us, bound(3 * n * n * 4, 2 * n ** 3, PEAK_F32)['bound_ms'])}; torch.addmm "
        f"{'not measured' if lib_us is None else f'{lib_us / 1e3:.5f} ms'}")


def normalize_device_times(gen: torch.Generator, floor_us: float) -> None:
    """K1's duration on the device from torch.profiler in each case of
    NORMALIZE_TIMED, against its bytes bound and in launch floors, beside its
    library call's.  K1's readings are required: where the profiler records
    none, CUDA events stand in (``required_us``).  Run with
    probe_device_times."""
    xs = normalize_inputs(gen)
    for label, recipe, dtype in NORMALIZE_TIMED:
        x, library = xs[label], normalize_library_call(recipe, dtype)
        us, src = required_us(lambda: normalize_kernel(x, recipe, dtype), f"K1 at {label}")
        lib_us = device_us(lambda: library(x))
        log(f"[K1 normalize] {recipe} {str(dtype)[6:]} {list(x.shape)} on the device ({src}): "
            f"{against(us, bound(normalize_bytes(x, dtype))['bound_ms'])}, {us / floor_us:.2f} launch floors; "
            f"torch.addcmul {'not measured' if lib_us is None else f'{lib_us / 1e3:.5f} ms'}")


def launch_floor() -> float:
    """The device time of the smallest launch the port can make: P3's kernel
    on an f32 [1, 2] input, one block and one element (torch.profiler;
    required, so CUDA events stand in where it records none)."""
    x = torch.randn(1, 2, device="cuda")
    got = mosaic_probe.strided_slice_kernel(x)
    require(torch.equal(got, mosaic_probe.strided_slice_plain(x)), "P3 on [1, 2] disagrees with its plain version")
    us, src = required_us(lambda: mosaic_probe.strided_slice_kernel(x), "the launch floor")
    log(f"[launch floor] P3 strided_slice on f32 [1, 2] (one block, one element) on the device ({src}): "
        f"{us:.3f} us")
    return us


def probe_device_times(floor_us: float) -> None:
    """The duration on the device of each probe kernel and of its library
    call, from torch.profiler, and the kernel's in launch floors.  Run after
    the paths' timings: of this process's times by events or by the host's
    clock, only phase (10)'s come after the profiler has been on."""
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
    """FID in f32 with host resize through the CLI, stage by stage: each
    folder's statistics (``--save_stats``: extraction and ``np.cov``), then
    the distance from them with the K3 square root, again with ``scipy``,
    and with ``ns`` and ``eigh`` from the same statistics; a short O-FID
    pass."""
    reset_counters()
    stage, npz = {}, {}
    for side in ("a", "b"):
        npz[side] = os.path.join(SCRATCH, f"{side}.npz")
        t0 = time.perf_counter()
        fid.main(["--path1", d[side], "--save_stats", npz[side], "--weights", d["weights"],
                  "--batch-size", str(BATCH)])
        torch.cuda.synchronize()
        stage[f"extract_{side}"] = time.perf_counter() - t0
    saved = os.path.join(SCRATCH, "fid_ns_pallas.txt")
    t0 = time.perf_counter()
    fid.main(["--path1", npz["a"], "--path2", npz["b"], "--sqrtm", "ns-pallas", "--saved_file", saved])
    torch.cuda.synchronize()
    stage["frechet_ns_pallas_cli"] = time.perf_counter() - t0
    t_cli = sum(stage.values())
    launches = counts()
    rate = 2 * N_IMAGES / t_cli
    log(f"[fid ns-pallas] CLI {t_cli:.2f} s ({rate:.1f} images/s end to end: each folder's statistics, then the "
        f"distance from them); launches {launches}")
    batches = 2 * -(-N_IMAGES // BATCH)
    require(launches["normalize"] == batches, f"K1 launched once per batch ({batches})")
    require(launches["avg_pool_3x3_s1_p1"] == 9 * batches, f"K2 launched 9x per batch ({9 * batches})")
    require(launches["epilogue_matmul"] == 30, "K3 launched once per Newton–Schulz step (30)")
    fid_ns_pallas = read_fid(saved)
    (m1, s1), (m2, s2) = (result_io.load_stats_npz(npz[side]) for side in ("a", "b"))
    require(all(np.isfinite(x).all() for x in (m1, s1, m2, s2)), "the statistics are finite")
    saved = os.path.join(SCRATCH, "fid_scipy.txt")
    t0 = time.perf_counter()
    fid.main(["--path1", npz["a"], "--path2", npz["b"], "--sqrtm", "scipy", "--saved_file", saved])
    stage["frechet_scipy_cli"] = time.perf_counter() - t0
    fid_scipy = result_io.read_fid_result(saved)
    values = {}
    for method in ("ns-pallas", "ns", "eigh"):
        t0 = time.perf_counter()
        values[method] = sqrtm.frechet_distance(m1, s1, m2, s2, method=method, device="cuda")
        torch.cuda.synchronize()
        stage[f"frechet_{method}"] = time.perf_counter() - t0
    extractor = fid.make_pool3_extractor(state_dict, "cuda")
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
N_NO_DEDUP = 64      # the first RP items, again with --no-dedup-text (one text pass an item: 0.13 s an item)
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
    two differ, the host's launches set the pace.  Run with
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


def pool3_norms(state, images: np.ndarray, recipe: str, batch: int = 0) -> torch.Tensor:
    """The norm of pool3 of a torchvision-layout trunk on each of ``images``
    (PIL-resized to 299, normalized under ``recipe``), ``batch`` images a
    forward (all at once where 0)."""
    from PIL import Image

    model = InceptionV3.from_state_dict(state, device="cuda")
    x = np.stack([np.asarray(Image.fromarray(im).resize((fid.IMAGE_SIZE,) * 2, Image.BILINEAR)) for im in images])
    step = batch or len(x)
    with torch.no_grad():
        return torch.cat([model(normalize_kernel(torch.from_numpy(x[i:i + step]).cuda(), recipe))["pool3"].norm(dim=1)
                          for i in range(0, len(x), step)])


def mean_pool3_norm(state, images: np.ndarray, recipe: str) -> float:
    """The mean of ``pool3_norms`` over ``images``."""
    return float(pool3_norms(state, images, recipe).mean())


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
    ``benchmark.main(["--track", "cub", ...])`` over the layout (FID by
    ``--sqrtm eigh`` in both: phase (1) holds ``scipy``'s root, which takes
    some 20 s on the host each time, against K3's and ``eigh``'s): FID, IS*
    and RP all present, no ``FAIL``, each within 1e-6 relative of its CLI run
    on the same inputs (RP: the highest run of path_rp_cub); then a
    ``--resume`` rerun that parses all three stages and launches nothing.
    Returns each run's launches."""
    per_path, direct = [], {}
    runs = (
        ("stats", lambda: fid.main(["--path1", c["reference"], "--save_stats", c["stats"],
                                    "--weights", c["fid_weights"]])),
        ("FID", lambda: fid.main(["--path1", c["stats"], "--path2", c["images"], "--weights", c["fid_weights"],
                                  "--sqrtm", "eigh", "--saved_file", os.path.join(c["root"], "fid.txt")])),
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
            "--weights_root", c["weights"], "--output_root", os.path.join(c["root"], "results"), "--sqrtm", "eigh"]
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

N_COCO_RUN = 128          # the runner's images: the first CA items'
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
    earlier phases' data and weights (hard links): the first 128 CA images
    and their CA items; RP items for them over the CLIP phase's captions; the
    PA phase's pickle and phrase folders; the first image of each of SOA's
    80 label folders; as ``coco_val.npz`` the statistics of path_fid_f32's
    N_IMAGES images of side a (with 128 images a side both covariances are
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
    """``benchmark.main(["--track", "coco", ...])`` over the layout, FID and
    O-FID by ``--sqrtm eigh`` (see path_cub_runner): all nine
    stages run (no FAIL, no SKIP), every value finite, the methods JSON their
    2-decimal rounding, the RS table the port's ranking of the methods dir
    with the run among the 11 published methods; then a ``--resume`` that
    parses all nine and launches nothing; then ``crop.done`` deleted and a
    ``--resume`` in which crop runs again and so do O-IS and O-FID, to the
    same values.  Returns the launches of the two runs that ran stages."""
    argv = ["--track", "coco", "--method_name", "smoke", "--images", lay["images"], "--soa_images", lay["soa"],
            "--pa_images", lay["pa"], "--data_root", lay["data"], "--weights_root", lay["weights"],
            "--output_root", lay["results"], "--methods_dir", lay["methods"], "--sqrtm", "eigh"]
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


# ---------------------------------------------------------------------------
# 10. the image-generation path: AttnGAN++ and CounterModel at the COCO eval
#     width, the generate and gen_example CLIs, the images through FID and IS*
# ---------------------------------------------------------------------------

N_GEN = 1024              # captions of the flat run (and of the second folder, FID's other side)
GEN_HEAD_SCALE = 4.0      # the IS* head's logit std on the generated image of the largest pool3
GEN_BATCH = 32            # the generate CLI's default batch
GEN_CHECK = 4             # captions of the card-against-CPU check
GEN_BENCH_BATCH = 64      # gen_bench's batch
SOA_GROUPS = {"label_00_00": 8, "label_17_17": 8, "label_56_56": 5}   # soa mode: items a label folder
PA_GROUPS = {"left": 8, "right": 6}                                    # pa mode: items a positional word
EXAMPLE_FILES = {"birds": 3, "nested/streets": 2}                      # gen_example: captions a file
#: the generate CLI's width: --gf_dim 64 and the other flags' defaults (R_NUM 2, 18 words)
CLI_GAN = GanConfig(gf_dim=64)


def gen_vocab() -> tuple:
    """A synthesised vocabulary of the COCO size (27,297 entries, index 0 the
    padding token)."""
    words = ["<end>"] + [f"w{i:05d}" for i in range(1, gen_bench.COCO_NTOKEN)]
    return dict(enumerate(words)), {w: i for i, w in enumerate(words)}


def gen_captions(rng: np.random.RandomState, n: int, first_id: int) -> list:
    """n caption items of 5-20 words of the vocabulary, ids from first_id."""
    return [{"caption_id": first_id + i, "caption": " ".join(
        f"w{k:05d}" for k in rng.randint(1, gen_bench.COCO_NTOKEN, rng.randint(5, 21)))} for i in range(n)]


def calibrated_generator_state(cfg: GanConfig, model: str, text_encoder, seed: int) -> dict:
    """``random_g_state_dict(seed)`` with every BatchNorm's running moments
    set from one train-mode batch of 32 seeded captions on the card (momentum
    1 for that batch), so that the eval-mode images are not saturated at
    0 and 255; numpy leaves."""
    net = g_weights.load_generator(g_weights.random_g_state_dict(seed, cfg, model), cfg, model, "cuda")
    rng = np.random.RandomState(seed + 90)
    caps, lens = generate._tokenize_items(gen_captions(rng, GEN_BATCH, 0), gen_vocab()[1], cfg.words_num)
    bns = [m for m in net.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    for m in bns:
        m.momentum = 1.0
    with torch.no_grad():
        caps_t = torch.from_numpy(caps.astype(np.int64)).cuda()
        words, sent = text_encoder(caps_t, lens)
        z, eps = generate.draw_noise(seed, 0, GEN_BATCH, cfg.z_dim, cfg.condition_dim, "cuda")
        net.train()(z, sent, words, caps_t == 0, eps)
    for m in bns:
        m.momentum = 0.1
    return {k: v.cpu().numpy() for k, v in net.eval().state_dict().items()}


def make_gen_data() -> dict:
    """Under build/chip_smoke/gen/: the vocabulary as a captions.pickle, the
    seeded DAMSM text encoder of that vocabulary (.pth), the CLI's generator
    (gf 64, R_NUM 2) with calibrated BatchNorm in the JAX package's .npz
    layout, the calibrated eval-width generators of the card-against-CPU
    check (gf 64, R_NUM 3; AttnGAN++ and CounterModel), and the caption
    files of the flat, soa, pa and gen_example runs."""
    t0 = time.perf_counter()
    root = os.path.join(SCRATCH, "gen")
    os.makedirs(root)
    ixtoword, wordtoix = gen_vocab()
    g = {"root": root, "vocab": os.path.join(root, "captions.pickle"), "text": os.path.join(root, "text_encoder.pth"),
         "ckpt": os.path.join(root, "g_attngan_pp.npz"), "ixtoword": ixtoword}
    result_io.save_pickle(g["vocab"], [[], [], ixtoword, wordtoix])
    text_state = damsm.random_rnn_state_dict(0, gen_bench.COCO_NTOKEN, nhidden=CLI_GAN.embedding_dim // 2)
    torch.save({k: torch.from_numpy(v) for k, v in text_state.items()}, g["text"])
    g["text_encoder"] = damsm.RNNEncoder.from_state_dict(text_state, device="cuda")
    g_weights.save_generator_npz(g["ckpt"], calibrated_generator_state(CLI_GAN, "attngan_pp", g["text_encoder"], 1))
    g["eval_states"] = {m: calibrated_generator_state(gen_bench.EVAL_GAN, m, g["text_encoder"], 2)
                        for m in g_weights.GENERATORS}
    rng = np.random.RandomState(70)
    g["flat"] = gen_captions(rng, N_GEN, 600000)
    g["soa"] = {k: gen_captions(rng, n, 700000 + 1000 * j) for j, (k, n) in enumerate(SOA_GROUPS.items())}
    g["pa"] = {k: gen_captions(rng, n, 800000 + 1000 * j) for j, (k, n) in enumerate(PA_GROUPS.items())}
    for mode in ("flat", "soa", "pa"):
        result_io.save_pickle(os.path.join(root, f"{mode}.pkl"), g[mode])
    g["examples"] = os.path.join(root, "examples")
    os.makedirs(os.path.join(g["examples"], "nested"))
    with open(os.path.join(g["examples"], "example_filenames.txt"), "w") as f:
        f.write("\n".join(EXAMPLE_FILES) + "\n")
    for name, n in EXAMPLE_FILES.items():
        with open(os.path.join(g["examples"], f"{name}.txt"), "w") as f:
            f.write("\n".join(item["caption"] for item in gen_captions(rng, n, 0)) + "\n")
    log(f"[gen data] a vocabulary of {gen_bench.COCO_NTOKEN} words, the seeded text encoder and three calibrated "
        f"generators in {time.perf_counter() - t0:.1f} s")
    return g


def check_generators_against_cpu(g: dict) -> None:
    """(a) GNet and CounterGNet at the COCO eval width (gf 64, R_NUM 3,
    embedding 256, 20 words) on the card (f32, TF32 off) against the CPU,
    the same calibrated weights, words, z and eps, on 4 captions: every
    image scale and both attention maps within 1e-3."""
    cfg = gen_bench.EVAL_GAN
    rng = np.random.RandomState(71)
    caps, lens = generate._tokenize_items(gen_captions(rng, GEN_CHECK, 0), gen_vocab()[1], cfg.words_num)
    caps_t = torch.from_numpy(caps.astype(np.int64))
    text_cpu = damsm.RNNEncoder.from_state_dict(torch.load(g["text"]), device="cpu")
    with torch.no_grad():
        words, sent = text_cpu(caps_t, lens)
    z, eps = generate.draw_noise(3, 0, GEN_CHECK, cfg.z_dim, cfg.condition_dim, "cpu")
    for model, state in g["eval_states"].items():
        t0 = time.perf_counter()
        outs = {}
        for dev in ("cuda", "cpu"):
            net = g_weights.load_generator(state, cfg, model, dev)
            with torch.no_grad():
                imgs, attn, mu, _ = net(*(t.to(dev) for t in (z, sent, words, caps_t == 0, eps)))
            outs[dev] = [t.cpu() for t in imgs + attn]
        errs = [float((a - b).abs().max()) for a, b in zip(outs["cuda"], outs["cpu"])]
        spread = [float(t.std()) for t in outs["cpu"][:len(outs["cpu"]) - 2]]
        sat = float((outs["cpu"][len(outs["cpu"]) - 3].abs() > 0.999).float().mean())
        log(f"[gen card vs cpu] {model}: max_abs_err by scale {', '.join(f'{e:.2e}' for e in errs[:-2])}, attention "
            f"maps {errs[-2]:.2e}, {errs[-1]:.2e}; image std by scale {', '.join(f'{s:.3f}' for s in spread)}; "
            f"{sat:.2%} of the finest values saturated; the CPU forward and both runs {time.perf_counter() - t0:.1f} s")
        require(all(np.isfinite(e) and e <= 1e-3 for e in errs), f"{model} card vs CPU: {errs}")
        require(min(spread) > 0.05 and sat < 0.5, f"{model}: flat or saturated images {spread}, {sat}")


def gen_argv(g: dict, out: str, mode: str = "flat", seed: int = 100) -> list:
    return ["--caption_file", os.path.join(g["root"], f"{mode}.pkl"), "--output_dir", out, "--mode", mode,
            "--checkpoint", g["ckpt"], "--text_encoder", g["text"], "--captions_pickle", g["vocab"],
            "--gf_dim", str(CLI_GAN.gf_dim), "--seed", str(seed)]


def read_pngs(folder: str) -> dict:
    from PIL import Image

    out = {}
    for dirpath, dirnames, names in os.walk(folder):
        dirnames.sort()  # in name order: the order of a directory's listing differs from one file system to another
        for name in sorted(names):
            with Image.open(os.path.join(dirpath, name)) as im:
                out[os.path.relpath(os.path.join(dirpath, name), folder)] = np.asarray(im)
    return out


def path_generate(g: dict) -> dict:
    """(b) ``generate.main`` in flat mode on 1,024 captions (the CLI's gf 64,
    R_NUM 2, batch 32): 1,024 PNGs named ``<caption_id>.png``, 256 x 256 RGB,
    not flat; a second folder under another --seed (FID's other side), whose
    images differ.  Then where the time goes: the text encoder and the G
    forward a batch of 32 by events, PNG writing on the CLI's 8 threads."""
    from PIL import Image

    g["gen_a"], g["gen_b"] = os.path.join(g["root"], "flat_a"), os.path.join(g["root"], "flat_b")
    run = run_cli("generate flat", generate.main, gen_argv(g, g["gen_a"]), N_GEN)
    run_cli("generate flat --seed 101", generate.main, gen_argv(g, g["gen_b"], seed=101), N_GEN)
    names = sorted(os.listdir(g["gen_a"]))
    require(names == sorted(f"{it['caption_id']}.png" for it in g["flat"]) == sorted(os.listdir(g["gen_b"])),
            "the flat run's file names")
    sample = read_pngs(g["gen_a"])
    other = read_pngs(g["gen_b"])
    require(all(a.shape == (256, 256, 3) and a.dtype == np.uint8 for a in sample.values()), "the flat images' shape")
    stds = np.array([a.std() for a in sample.values()])
    require(stds.min() > 5.0, f"a flat image is flat (pixel std {stds.min():.2f})")
    require(sum(np.array_equal(sample[k], other[k]) for k in sample) == 0, "--seed 101 gave an equal image")
    # the split: one batch of the CLI's work, timed on its own
    ixtoword, wordtoix = gen_vocab()
    g_state, text_state = generate.load_generator_from_checkpoint(g["ckpt"], g["text"], CLI_GAN, len(ixtoword),
                                                                  "attngan_pp")
    gen = generate.CaptionGenerator(g_state, text_state, gan=CLI_GAN, device="cuda")
    caps, lens = generate._tokenize_items(g["flat"][:GEN_BATCH], wordtoix, CLI_GAN.words_num)
    caps_t = torch.from_numpy(caps.astype(np.int64)).cuda()
    with torch.no_grad():
        words, sent = gen.text_encoder(caps_t, lens)
        z, eps = generate.draw_noise(100, 0, GEN_BATCH, CLI_GAN.z_dim, CLI_GAN.condition_dim, "cuda")
        text_ms = median_ms(lambda: gen.text_encoder(caps_t, lens), reps=5, inner=5)
        g_ms = median_ms(lambda: gen.gnet(z, sent, words, caps_t == 0, eps), reps=5, inner=2, warmup=1)
        uint8_ms = median_ms(lambda: generate.to_uint8(gen.gnet(z, sent, words, caps_t == 0, eps)[0][-1]).cpu(),
                             reps=3, inner=2, warmup=1) - g_ms
    arrays = list(sample.values())[:256]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(generate.PNG_WORKERS) as pool:
        list(pool.map(lambda ia: Image.fromarray(ia[1]).save(os.path.join(SCRATCH, f"png_{ia[0]}.png")),
                      enumerate(arrays)))
    png_s = (time.perf_counter() - t0) / len(arrays) * N_GEN
    for i in range(len(arrays)):
        os.remove(os.path.join(SCRATCH, f"png_{i}.png"))
    batches = N_GEN // GEN_BATCH
    device_s = batches * (text_ms + g_ms) / 1e3
    log(f"[time generate] a batch of {GEN_BATCH} by events: text encoder {text_ms:.3f} ms, G forward {g_ms:.3f} ms, "
        f"uint8 and copy {uint8_ms:.3f} ms; so {device_s:.2f} s of text and G for {N_GEN} captions "
        f"({N_GEN / device_s:.1f} images/s) against {run['seconds']:.2f} s end to end (the host's share "
        f"{1 - device_s / run['seconds']:.1%}); PNG writing alone {png_s:.2f} s for {N_GEN} on "
        f"{generate.PNG_WORKERS} threads")
    return run


def path_generate_grouped(g: dict) -> None:
    """(c) The soa mode (``<label>/<caption_id>_<k>.png``, k < 3) and the pa
    mode (``<word>/<caption_id>.png``) on a few groups: the layouts of
    generate.py:1-13, file for file."""
    out = os.path.join(g["root"], "soa")
    run_cli("generate soa", generate.main, gen_argv(g, out, "soa") + ["--images_per_caption", "3"],
            3 * sum(SOA_GROUPS.values()))
    want = {os.path.join(k, f"{it['caption_id']}_{j}.png") for k, items in g["soa"].items() for it in items
            for j in range(3)}
    require(set(read_pngs(out)) == want, "the soa layout")
    out = os.path.join(g["root"], "pa")
    run_cli("generate pa", generate.main, gen_argv(g, out, "pa"), sum(PA_GROUPS.values()))
    want = {os.path.join(k, f"{it['caption_id']}.png") for k, items in g["pa"].items() for it in items}
    require(set(read_pngs(out)) == want, "the pa layout")


def path_gen_example(g: dict) -> None:
    """(d) ``gen_example.main`` on two caption files (one in a subfolder):
    per caption the three scales (64, 128, 256 px) and the attention
    super-image."""
    out = os.path.join(g["root"], "examples_out")
    run_cli("gen_example", gen_example.main,
            ["--data_dir", g["examples"], "--output_dir", out, "--checkpoint", g["ckpt"], "--text_encoder",
             g["text"], "--captions_pickle", g["vocab"], "--gf_dim", str(CLI_GAN.gf_dim)],
            3 * sum(EXAMPLE_FILES.values()))
    got = read_pngs(out)
    want = {f"{name.split('/')[-1]}/0_s_{i}_{s}.png" for name, n in EXAMPLE_FILES.items() for i in range(n)
            for s in ("g0", "g1", "g2", "attn")}
    require(set(got) == want, f"the gen_example layout: {sorted(got)}")
    require(all(got[k].shape[:2] == (s, s) for k in got for tag, s in (("g0", 64), ("g1", 128), ("g2", 256))
                if k.endswith(f"_{tag}.png")), "the gen_example scales")
    grids = [a for k, a in got.items() if k.endswith("_attn.png")]
    require(all(a.shape[1] == 9 * 256 and a.shape[0] == 256 + 14 for a in grids), "the attention grids' size")


def path_gen_metrics(g: dict, d: dict) -> list:
    """(e) The flat folder through the f32 FID CLI against the --seed 101
    folder (``--sqrtm eigh``: 1,024 images a side leave both covariances
    singular) and through the IS* COCO CLI, its 2015-layout trunk calibrated
    on the first 128 of the generated images by name (a head scaled on the
    noise images saturates the softmax on these): K1 once a batch of 64, K2
    nine times a batch (FID) and eight (IS* COCO's tf2015 pools), finite
    values.

    The head is scaled by the largest pool3 norm over the 1,024 images that
    IS* scores, not by the mean: the calibrated trunk gives a few of them a
    pool3 about ten times the median, and a head of logits of order 1 on the
    mean can stretch their logits over 100 T, where an f32 softmax
    underflows to an exact 0 and the split KL (0 log 0, as in the reference)
    turns IS* into NaN."""
    batches = N_GEN // BATCH
    images = np.stack(list(read_pngs(g["gen_a"]).values()))
    state_is, _ = calibrated_state(3, 1000, images[:128], "is_star")
    norms = pool3_norms(state_is, images, "is_star_2015", batch=BATCH)
    g2015 = os.path.join(g["root"], "g2015.npz")
    np.savez(g2015, **tf_layout_vars(state_is, "2015", seed=23, head_std=GEN_HEAD_SCALE / float(norms.max())))
    log(f"[gen metrics] pool3 norm of the IS* trunk on the generated images: median {float(norms.median()):.2f}, "
        f"largest {float(norms.max()):.2f}")
    saved = os.path.join(g["root"], "fid.txt")
    fid_run = run_cli("gen FID", fid.main, ["--path1", g["gen_a"], "--path2", g["gen_b"], "--weights", d["weights"],
                                           "--saved_file", saved, "--sqrtm", "eigh"], 2 * N_GEN)
    value = read_fid(saved)
    saved = os.path.join(g["root"], "is_star.txt")
    is_run = run_cli("gen IS* coco", is_star.main, ["--image_folder", g["gen_a"], "--flavor", "coco", "--weights",
                                                   g2015, "--batch_size", str(BATCH), "--saved_file", saved],
                     N_GEN)
    is_mean, is_std = result_io.read_is_coco_result(saved)
    log(f"[gen metrics] FID {value!r} between the two generated folders; IS* COCO {is_mean!r} +- {is_std!r}")
    require(np.isfinite(is_mean) and is_mean >= 1.0, f"IS* on the generated images {is_mean}")
    require(fid_run["launches"]["normalize"] == 2 * batches and fid_run["launches"]["avg_pool_3x3_s1_p1"] == 18 * batches,
            f"the generated images' FID launches {fid_run['launches']}")
    require(is_run["launches"]["normalize"] == batches and is_run["launches"]["avg_pool_3x3_s1_p1"] == 8 * batches,
            f"the generated images' IS* launches {is_run['launches']}")
    return [fid_run["launches"], is_run["launches"]]


def gen_bench_timings() -> None:
    """(f) gen_bench's chain at the COCO eval width (gf 64, R_NUM 3, 256 px,
    batch 64, f32, TF32 off): a step (text encoder, noise, G) by events and
    on the device (torch.profiler), its convolutions' and dense layers'
    operations an image, and their share of the f32 peak."""
    bench = gen_bench.build("cuda", batch=GEN_BENCH_BATCH, chain=2)
    with torch.no_grad():
        require(bool(torch.isfinite(bench.chain_fn(0))), "gen_bench's chain is finite")
        flops = sum(forward_flops(bench.gnet, lambda: bench.step_fn(0)).values()) / GEN_BENCH_BATCH
        torch.cuda.reset_peak_memory_stats()
        ms = median_ms(lambda: bench.step_fn(1), reps=5, inner=2, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        us = device_us(lambda: bench.step_fn(1), calls=2)
    least = flops * GEN_BENCH_BATCH / PEAK_F32 * 1e3
    dev = "not measured" if us is None else f"{us / 1e3:.3f} ms ({least / (us / 1e3):.1%} of the f32 bound)"
    log(f"[time gen_bench] a batch of {GEN_BENCH_BATCH} at gf 64, R_NUM 3, 256 px: {ms:.3f} ms by events "
        f"({GEN_BENCH_BATCH / ms * 1e3:.1f} images/s), on the device {dev}; {flops / 1e9:.2f} GFLOP an image "
        f"(convolutions and dense layers), f32 bound {least:.2f} ms ({least / ms:.1%} of the events' time); "
        f"peak memory {peak:.2f} GiB")


def path_calibration(g: dict) -> None:
    """(g) ``calibration.cli.main`` on the card on 10,000 seeded logits of
    1,000 classes with a planted temperature: the fitted T within 2% of it."""
    rng = np.random.RandomState(72)
    base = rng.standard_normal((10000, 1000)).astype(np.float32) * 3.0
    p = np.exp(base - base.max(1, keepdims=True))
    labels = (p.cumsum(1) / p.sum(1, keepdims=True) > rng.rand(10000, 1)).argmax(1)  # drawn from softmax(base)
    path = os.path.join(g["root"], "validation.npz")
    np.savez(path, logits=base * 0.8, labels=labels)  # logits / 0.8 are the softmax the labels came from
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        calib_cli.main(["--validation_npz", path])
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    t = float(lines[1].split(": ")[1])
    log(f"[calibration] CLI {seconds:.2f} s on 10,000 x 1,000 logits: {lines[0]!r}, T {t!r} (planted 0.8), "
        f"{lines[2]!r}")
    require(abs(t - 0.8) < 0.016 and len(lines) == 3 + 2 * 18, f"the fitted temperature {t}")


# ---------------------------------------------------------------------------
# 11. training
# ---------------------------------------------------------------------------

N_TRAIN = 256             # images of the training layout, 280-330 px JPEGs
TRAIN_CAPS = 5            # captions an image (--caps_per_img)
TRAIN_BATCH = 64
N_TRAIN_GEN = 64          # captions the generate CLI draws from each run's EMA snapshot
#: the published COCO model's width (tools/train_bench.py:5-8,54-55): gf 64, df 32, R_NUM 3, embedding 256,
#: 20 words, three branches (64/128/256 px), batch 64
TRAIN_GAN = GanConfig(gf_dim=64, df_dim=32, r_num=3, embedding_dim=256, words_num=20)
TRAIN_ARGV = ["--gf_dim", "64", "--df_dim", "32", "--num_residual", "3", "--text_emb_dim", "256", "--words_num", "20",
              "--batch_size", str(TRAIN_BATCH), "--caps_per_img", str(TRAIN_CAPS), "--snapshot_interval", "1",
              "--num_workers", "8", "--device", "cuda"]
#: the card-against-CPU step's width (the encoders keep their full width)
CHECK_GAN = GanConfig(gf_dim=16, df_dim=16, r_num=3, embedding_dim=256, words_num=20)
CHECK_BATCH = 4
ENCODER_CHECK_BATCH = 8


def pool2d_backward(grad: torch.Tensor):
    """-> a call of F.avg_pool2d's autograd backward (3x3, stride 1, pad 1,
    padding counted) on NCHW ``grad``, through a graph built once in
    ``grad``'s memory format: the library's backward of the pool."""
    x = torch.zeros_like(grad, requires_grad=True)
    y = torch.nn.functional.avg_pool2d(x, 3, 1, 1)
    return lambda: torch.autograd.grad(y, x, grad, retain_graph=True)[0]


def check_pool_backward(gen: torch.Generator) -> dict:
    """(a) K2's backward against its plain version (autograd through
    avg_pool_plain) at the DAMSM trunk's six pool shapes at batch 64, f32
    and bf16, both count modes: within 1e-6 of the gradient's largest
    magnitude in f32 (sums in another order) and one bf16 rounding of it
    (2^-7) in bf16; a gradient that arrives as a channels_last NCHW view is
    taken as is.  Then the nine pools' backward of one trunk batch by
    events against their bytes bound (one read of the gradient, one write),
    the plain version and F.avg_pool2d's autograd backward on a contiguous
    NCHW copy of the gradient (the same function to f32 rounding; on the
    channels_last gradient itself its error is printed)."""
    max_err, ms, plain_ms, library_ms, nbytes = 0.0, 0.0, 0.0, 0.0, 0
    for shape, per_batch in POOL_SHAPES:
        g = torch.randn(shape, generator=gen, device="cuda")
        scale = float(g.abs().max())
        for include_pad in (True, False):
            for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2.0 ** -7)):
                gi = g.to(dtype)
                got, ref = avg_pool_backward_kernel(gi, include_pad), avg_pool_backward_plain(gi, include_pad)
                torch.cuda.synchronize()
                err = float((got.float() - ref.float()).abs().max())
                log(f"[K2 backward] {str(shape):22s} include_pad={include_pad!s:5s} {str(dtype):15s} "
                    f"max_abs_err {err:.3e} (tolerance {tol * scale:.3e})")
                require(got.dtype == dtype and err <= tol * scale, f"K2 backward {shape} {include_pad} {dtype}: {err}")
                if dtype == torch.float32:
                    max_err = max(max_err, err)
        copies = avg_pool_backward_kernel.copies
        nchw = g.permute(0, 3, 1, 2)  # a channels_last NCHW view: its NHWC permute is contiguous
        require(torch.equal(avg_pool_backward_kernel(nchw.permute(0, 2, 3, 1), True), avg_pool_backward_kernel(g, True))
                and avg_pool_backward_kernel.copies == copies, "K2 backward copied a contiguous NHWC view")
        k = median_ms(lambda: avg_pool_backward_kernel(g, True))
        p = median_ms(lambda: avg_pool_backward_plain(g, True))
        # F.avg_pool2d's backward on this channels_last gradient disagrees with the adjoint (logged, not
        # required); on a contiguous NCHW copy (made outside the timing) it agrees, and that call is timed
        lib_err_cl = float((pool2d_backward(nchw)().permute(0, 2, 3, 1) - avg_pool_backward_kernel(g, True)).abs().max())
        lib_call = pool2d_backward(nchw.contiguous())
        lib_err = float((lib_call().permute(0, 2, 3, 1) - avg_pool_backward_kernel(g, True)).abs().max())
        require(lib_err <= 1e-6 * scale, f"K2 backward {shape} vs F.avg_pool2d's backward on NCHW: {lib_err}")
        lib = median_ms(lib_call)
        least = bound(2 * g.numel() * 4)["bound_ms"]
        log(f"[K2 backward] {str(shape):22s} f32: kernel {k:.4f} ms, bound {least:.4f} ms ({least / k:.1%} of it), "
            f"plain {p:.4f} ms, F.avg_pool2d's backward on contiguous NCHW {lib:.4f} ms (max_abs_err {lib_err:.2e}; "
            f"on the channels_last gradient {lib_err_cl:.2e}) (x{per_batch} per batch)")
        ms += per_batch * k
        plain_ms += per_batch * p
        library_ms += per_batch * lib
        nbytes += per_batch * 2 * g.numel() * 4
    least = bound(nbytes)["bound_ms"]
    log(f"[K2 backward] the nine pools' backward of one trunk batch of {BATCH}: kernel {ms:.4f} ms against a bound of "
        f"{least:.4f} ms ({least / ms:.1%} of it), plain {plain_ms:.4f} ms, F.avg_pool2d's backward {library_ms:.4f} ms")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bound(nbytes)}


def encoder_input_grad(encoder, x: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    xt = x.clone().requires_grad_()
    region, code = encoder.encode(xt)
    ((region.float() * r1).sum() + (code.float() * r2).sum()).backward()
    return xt.grad.double()


def check_encoder_gradient(t: dict) -> None:
    """(b) The DAMSM image encoder's gradient with respect to its input (a
    weighted sum of the region features and the code, 8 seeded 256 px
    images, TF32 off) on the card through K2 and its backward, against the
    same computation with the pools' plain version on the card, for the f32
    encoder and its bf16 copy (``--encoder_precision fast``).  K2's forward
    is bit-equal to the plain version, so only the backward's rounding
    separates them: within 1e-3 in L2 norm in f32 and 1e-1 in bf16 (a bf16
    rounding that flips moves the rest of a random-weight trunk's bf16
    backward: 1.8% measured).  A K2 outside autograd drops the pool
    branches' share of the gradient, 44% of it (on the CPU).  The bf16 gradient's cosine with the f32 one is
    printed: a random-weight trunk's max pools and ReLUs switch under bf16
    rounding."""
    enc = damsm.CNNEncoder.from_state_dict(t["image_state"], device="cuda").requires_grad_(False)
    rng = np.random.RandomState(80)
    x = torch.from_numpy(rng.uniform(-1, 1, (ENCODER_CHECK_BATCH, 256, 256, 3)).astype(np.float32)).cuda()
    r1 = torch.from_numpy(rng.standard_normal((ENCODER_CHECK_BATCH, 17, 17, 256)).astype(np.float32)).cuda()
    r2 = torch.from_numpy(rng.standard_normal((ENCODER_CHECK_BATCH, 256)).astype(np.float32)).cuda()
    grads = {}
    for precision, model, tol in (("f32", enc, 1e-3), ("bf16", enc.bf16_copy(), 1e-1)):
        reset_counters()
        avg_pool_backward_kernel.copies = 0
        card = encoder_input_grad(model, x, r1, r2)
        launches, copies = counts(), avg_pool_backward_kernel.copies
        kernel_route = inception_v3.avg_pool_3x3_s1_p1
        inception_v3.avg_pool_3x3_s1_p1 = avg_pool_plain
        try:
            plain = encoder_input_grad(model, x, r1, r2)
        finally:
            inception_v3.avg_pool_3x3_s1_p1 = kernel_route
        require(counts()["avg_pool_3x3_s1_p1"] == launches["avg_pool_3x3_s1_p1"], "the plain route launched K2")
        rel = float((card - plain).norm() / plain.norm())
        log(f"[train encoder gradient] {precision}: card through K2 vs the plain pools on the card: L2 {rel:.3e} "
            f"(tolerance {tol}); K2 launches {launches['avg_pool_3x3_s1_p1']}, its backward "
            f"{launches['avg_pool_3x3_s1_p1_backward']}, gradient copies {copies}")
        require(launches["avg_pool_3x3_s1_p1"] == 9 and launches["avg_pool_3x3_s1_p1_backward"] == 9,
                f"the encoder's pools and their backward ran K2 once each: {launches}")
        require(np.isfinite(rel) and rel <= tol, f"the {precision} encoder's input gradient through K2: L2 {rel}")
        grads[precision] = card
    cos = float((grads["bf16"] * grads["f32"]).sum() / (grads["bf16"].norm() * grads["f32"].norm()))
    log(f"[train encoder gradient] the bf16 copy's input gradient against the f32 one: cosine {cos:.4f}")


def within_rounding(got, ref, ref64, floor: float = 0.0) -> float:
    """(distance of ``got`` to the float64 ``ref64``) / (3 x the f32 ``ref``'s
    distance to it + the larger of 1e-5 and 3 ``floor`` of its norm), L2: at
    most 1 when ``got`` is as close to float64 as f32 rounding puts ``ref``;
    0 where ``got`` is ``ref64``."""
    got, ref, ref64 = (torch.as_tensor(a).double().cpu() for a in (got, ref, ref64))
    distance = float((got - ref64).norm())
    if distance == 0.0:
        return 0.0  # a gradient no loss reaches is 0 everywhere
    return distance / max(float(3 * (ref - ref64).norm() + max(1e-5, 3 * floor) * ref64.norm()), 1e-300)


def check_train_step_against_cpu(t: dict) -> None:
    """(c) One train step at gf 16, df 16, R_NUM 3, batch 4 (the encoders at
    full width) from the same seeded state, batch and noise: the card (K1,
    K2 and its backward, cuDNN, TF32 off) against the CPU in f32, each
    refereed by the CPU in float64.  Every metric within 1e-3 relative of
    the float64 step; every G and D gradient as close to float64 as 3x the
    CPU's f32 rounding (L2, ``within_rounding``), which random-weight D256
    and InceptionV3 make 0.4-1.3% of a tensor.  The EMA's change over the
    step (0.001 x Adam's first step, about 2e-7) within 2% plus two f32
    spacings of the CPU's on at least 90% of G's parameters: a first Adam
    step is lr x sign(g), which a gradient near 0 may flip."""
    cfg = trainer.TrainConfig(gan=CHECK_GAN, batch_size=CHECK_BATCH, ntoken=gen_bench.COCO_NTOKEN)
    dicts = g_weights.TrainStateDicts(0, g_weights.random_g_state_dict(5, CHECK_GAN), {}, {
        s: g_weights.random_d_state_dict(5 + s, CHECK_GAN.df_dim, CHECK_GAN.embedding_dim, s) for s in (64, 128, 256)})
    batch = trainer.synthetic_batch(cfg, np.random.RandomState(81), CHECK_BATCH)
    z, eps = generate.draw_noise(6, 0, CHECK_BATCH, CHECK_GAN.z_dim, CHECK_GAN.condition_dim, "cpu")
    out = {}
    reset_counters()
    for name, device, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                                ("cpu64", "cpu", torch.float64)):
        t0 = time.perf_counter()
        models = trainer.build_models(cfg, t["text_state"], t["image_state"], device)
        if dtype == torch.float64:
            models = trainer.Models(models.gnet.double(), {s: d.double() for s, d in models.dnets.items()},
                                    models.text_encoder.double(), models.image_encoder.double())
        state = trainer.init_state(cfg, models, dicts=dicts)
        metrics = trainer.make_train_step(cfg, models)(state, batch, z.to(device, dtype), eps.to(device, dtype))
        grads = {f"g.{k}": p.grad for k, p in state.gnet.named_parameters()}
        grads.update({f"d{s}.{k}": p.grad for s, d in state.dnets.items() for k, p in d.named_parameters()})
        ema = {k: v.cpu().double() - torch.from_numpy(dicts.g[k]).double() for k, v in state.g_ema.items()}
        out[name] = ({k: float(v) for k, v in metrics.items()}, {k: v.cpu() for k, v in grads.items()}, ema)
        if name == "card":
            launches = counts()
        log(f"[train card vs cpu] the {name} step in {time.perf_counter() - t0:.1f} s (with its models)")
    require(launches["normalize"] == 3 and launches["avg_pool_3x3_s1_p1"] == 9
            and launches["avg_pool_3x3_s1_p1_backward"] == 9, f"the card's step launched {launches}")
    m_err = max(abs(out["card"][0][k] - v) / max(abs(v), 1.0) for k, v in out["cpu64"][0].items())
    ratios = {k: within_rounding(out["card"][1][k], out["cpu"][1][k], v) for k, v in out["cpu64"][1].items()}
    worst = max(ratios, key=ratios.get)
    log(f"[train card vs cpu] metrics card {out['card'][0]}; largest relative difference from float64 {m_err:.2e}; "
        f"gradients: the largest card distance to float64 over 3x the CPU f32's, {worst} {ratios[worst]:.3f}")
    require(m_err <= 1e-3, f"the card's step metrics differ from float64 by {m_err}")
    require(ratios[worst] <= 1.0, f"the card's gradient of {worst} is {ratios[worst]:.3f} x the f32 rounding away")
    agree = moved = total = 0
    for k, want in out["cpu"][2].items():
        got = out["card"][2][k]
        spacing = torch.from_numpy(np.spacing(np.abs(dicts.g[k]))).double()
        agree += int(((got - want).abs() <= 0.02 * want.abs() + 2 * spacing).sum())
        moved, total = moved + int(torch.count_nonzero(got)), total + want.numel()
    log(f"[train card vs cpu] the EMA's change agrees with the CPU's on {agree / total:.4%} of G's {total} "
        f"parameters; it moved {moved / total:.4%} of them")
    require(agree >= 0.9 * total and moved >= 0.9 * total, "the card's EMA did not follow the CPU's")


def train_image(rng: np.random.RandomState) -> np.ndarray:
    """A 280-330 px image of colour blocks, bilinearly enlarged."""
    from PIL import Image

    w, h = rng.randint(280, 331, 2)
    cells = rng.randint(0, 256, (h // 20 + 1, w // 20 + 1, 3)).astype(np.uint8)
    return np.asarray(Image.fromarray(cells).resize((w, h), Image.BILINEAR))


def make_train_data() -> dict:
    """Under build/chip_smoke/train/: the reference's layout of 256 JPEGs
    with 5 captions each (4-25 words of the COCO-size vocabulary of 27,297
    words, so some are cut to 20) in captions.pickle, train/filenames.pickle
    and train/class_info.pickle (50 classes); the seeded DAMSM encoders at
    full width written as the reference's .pth files; 64 captions for the
    generate CLI."""
    from PIL import Image

    t0 = time.perf_counter()
    root = os.path.join(SCRATCH, "train")
    data = os.path.join(root, "data")
    os.makedirs(os.path.join(data, "train"))
    rng = np.random.RandomState(82)
    keys = [f"img{i:04d}" for i in range(N_TRAIN)]
    for key in keys:
        Image.fromarray(train_image(rng)).save(os.path.join(data, f"{key}.jpg"), quality=90)
    ixtoword, wordtoix = gen_vocab()
    caps = [list(rng.randint(1, gen_bench.COCO_NTOKEN, rng.randint(4, 26))) for _ in range(N_TRAIN * TRAIN_CAPS)]
    result_io.save_pickle(os.path.join(data, "captions.pickle"), [caps, [], ixtoword, wordtoix])
    result_io.save_pickle(os.path.join(data, "train", "filenames.pickle"), keys)
    result_io.save_pickle(os.path.join(data, "train", "class_info.pickle"), [int(c) for c in rng.randint(0, 50, N_TRAIN)])
    t = {"root": root, "data": data, "vocab": os.path.join(data, "captions.pickle"),
         "text": os.path.join(root, "text_encoder.pth"), "image": os.path.join(root, "image_encoder.pth"),
         "text_state": damsm.random_rnn_state_dict(0, gen_bench.COCO_NTOKEN, nhidden=TRAIN_GAN.embedding_dim // 2),
         "image_state": damsm.random_cnn_state_dict(0, nef=TRAIN_GAN.embedding_dim)}
    for key in ("text", "image"):
        torch.save({k: torch.from_numpy(v) for k, v in t[f"{key}_state"].items()}, t[key])
    t["captions"] = os.path.join(root, "captions_gen.pkl")
    result_io.save_pickle(t["captions"], gen_captions(rng, N_TRAIN_GEN, 900000))
    log(f"[train data] {N_TRAIN} JPEGs, {len(caps)} captions and the full-width DAMSM encoders in "
        f"{time.perf_counter() - t0:.1f} s")
    return t


def path_train(t: dict) -> list:
    """(d) ``models.main`` at the published COCO width (gf 64, df 32,
    R_NUM 3, 256 px, batch 64: 4 steps an epoch) over the layout: 2 epochs
    with a snapshot each, then a resume for a third; then the generate CLI
    on the third snapshot's EMA .npz for 64 captions (R_NUM read from it); all
    of it in f32 (``highest``) and again under ``--encoder_precision
    fast``.  Each training run launches K1 3 times a step (the real images'
    three scales) and K2 and its backward 9 times a step (the DAMSM
    encoder on the 256 px fakes); each keeps only its newest snapshot; the
    losses are finite and the images not flat."""
    paths = []
    for precision in ("highest", "fast"):
        out = os.path.join(t["root"], precision)
        argv = ["--data_dir", t["data"], "--output_dir", out, "--net_e", t["text"], "--image_encoder", t["image"],
                "--encoder_precision", precision, *TRAIN_ARGV]
        records = []
        for max_epoch in (2, 3):
            reset_counters()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                run = train_main.main(argv + ["--max_epoch", str(max_epoch)])
            seconds = time.perf_counter() - t0
            launches = counts()
            steps = sum(r["steps"] for r in run)
            log(f"[train {precision}] models.main --max_epoch {max_epoch}: {seconds:.2f} s for {len(run)} epochs of "
                f"{[r['steps'] for r in run]} steps ({steps * TRAIN_BATCH / seconds:.1f} images/s end to end), peak "
                f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; by epoch: " + "; ".join(
                    f"{r['seconds']:.2f} s, {r['data_wait_s']:.3f} s waiting for data, g_loss "
                    f"{r['metrics']['g_loss']:.4f}, d_loss {r['metrics']['d_loss']:.4f}" for r in run)
                + f"; launches {launches}")
            require(steps == len(run) * N_TRAIN // TRAIN_BATCH and len(run) == (2 if max_epoch == 2 else 1),
                    f"the run trained {[r['steps'] for r in run]} steps (a resume trains epoch 3 alone)")
            require(all(np.isfinite(v) for r in run for v in r["metrics"].values()), f"a loss is not finite: {run}")
            require(launches["normalize"] == 3 * steps and launches["avg_pool_3x3_s1_p1"] == 9 * steps
                    and launches["avg_pool_3x3_s1_p1_backward"] == 9 * steps, f"the training run launched {launches}")
            require(sorted(os.listdir(os.path.join(out, "checkpoints"))) == [f"epoch_{max_epoch}.npz",
                                                                             f"epoch_{max_epoch}.pt"],
                    "only the newest snapshot is kept")
            records += run
            paths.append(launches)
        gen_dir = os.path.join(out, "generated")
        run_cli(f"generate from the {precision} EMA snapshot", generate.main, [
            "--caption_file", t["captions"], "--output_dir", gen_dir, "--checkpoint",
            os.path.join(out, "checkpoints", "epoch_3.npz"), "--text_encoder", t["text"], "--captions_pickle",
            t["vocab"], "--gf_dim", "64", "--words_num", "20"], N_TRAIN_GEN)
        images = read_pngs(gen_dir)
        stds = np.array([a.std() for a in images.values()])
        require(len(images) == N_TRAIN_GEN and all(a.shape == (256, 256, 3) for a in images.values()),
                "the generated images")
        log(f"[train {precision}] {len(images)} images from the EMA snapshot, pixel std {stds.min():.2f}-{stds.max():.2f}")
        require(stds.min() > 1.0, f"a generated image is flat (pixel std {stds.min():.2f})")
        t[precision] = records
    return paths


def train_timings(t: dict) -> dict:
    """(e) One train step at the published width on a batch of the layout,
    f32, TF32 off: its time by events (the median of 3 after a warm-up),
    its operations (torch's FLOP counter over one step: convolutions and
    matrix products, forward and backward) and their share of the f32 peak,
    peak memory and images/s; the host's wait for data a step from the
    main runs' records.  Its device time comes last
    (``train_device_times``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from tise_tpu_torch.models import datasets

    cfg = trainer.TrainConfig(gan=TRAIN_GAN, batch_size=TRAIN_BATCH, ntoken=gen_bench.COCO_NTOKEN)
    models = trainer.build_models(cfg, t["text_state"], t["image_state"], "cuda")
    state = trainer.init_state(cfg, models, seed=0)
    step = trainer.make_train_step(cfg, models)
    ds = datasets.TextImageDataset(t["data"], "train", words_num=20, captions_per_image=TRAIN_CAPS, seed=1)
    batch = next(iter(ds.batches(TRAIN_BATCH)))
    z, eps = generate.draw_noise(1, 0, TRAIN_BATCH, TRAIN_GAN.z_dim, TRAIN_GAN.condition_dim, "cuda")
    step(state, batch, z, eps)
    torch.cuda.synchronize()
    with FlopCounterMode(display=False) as fc:
        step(state, batch, z, eps)
    flops = fc.get_total_flops()
    torch.cuda.reset_peak_memory_stats()
    times = step_events_ms(lambda: step(state, batch, z, eps))
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    least = flops / PEAK_F32 * 1e3
    waits = {p: sum(r["data_wait_s"] for r in t[p]) / sum(r["steps"] for r in t[p]) for p in ("highest", "fast")}
    steps_s = {p: sum(r["seconds"] for r in t[p]) / sum(r["steps"] for r in t[p]) for p in ("highest", "fast")}
    log(f"[time train] a step at gf 64, df 32, R_NUM 3, 256 px, batch {TRAIN_BATCH}: {ms:.1f} ms by events "
        f"({[round(x, 1) for x in times]}; {TRAIN_BATCH / ms * 1e3:.1f} images/s), {flops / 1e12:.3f} TFLOP "
        f"(f32 bound {least:.1f} ms, {least / ms:.1%} of the events' time), peak memory {peak:.2f} GiB; in models.main "
        f"a step took {steps_s['highest'] * 1e3:.1f} ms (fast {steps_s['fast'] * 1e3:.1f} ms) with the epochs' first "
        f"steps, and the host waited {waits['highest'] * 1e3:.1f} ms a step for data (fast {waits['fast'] * 1e3:.1f})")
    return {"step": lambda: step(state, batch, z, eps), "events_ms": ms, "flops": flops}


def train_device_times(gen: torch.Generator, floor_us: float, t: dict) -> None:
    """K2's backward at each DAMSM pool shape and the nine of a batch, K1
    under ``half`` at the three training scales (read cold, the L2 emptied
    before each call, and warm), and the whole train step on
    the device (torch.profiler): each beside its bound (and K1 beside
    torch.addcmul), the step beside its time by events and its device idle
    share.  Run with the other device times."""
    xs = []
    for shape, per_batch in POOL_SHAPES:
        g = torch.randn(shape, generator=gen, device="cuda")
        b = bound(2 * g.numel() * 4)["bound_ms"]
        log(f"[K2 backward] {str(shape):22s} on the device (torch.profiler) "
            f"{against(device_us(lambda: avg_pool_backward_kernel(g, True), calls=5), b)}; adjoint (padding not "
            f"counted) {against(device_us(lambda: avg_pool_backward_kernel(g, False), calls=5), b)}")
        xs += [g] * per_batch
    least = bound(sum(2 * g.numel() * 4 for g in xs))["bound_ms"]
    calls = [pool2d_backward(g.permute(0, 3, 1, 2).contiguous()) for g in xs]
    lib = device_us(lambda: [call() for call in calls], calls=5)
    log(f"[K2 backward] the nine pools' backward of one trunk batch on the device (torch.profiler): "
        f"{against(device_us(lambda: [avg_pool_backward_kernel(g, True) for g in xs], calls=5), least)}; "
        f"F.avg_pool2d's backward on contiguous NCHW {'not measured' if lib is None else f'{lib / 1e3:.5f} ms'}")
    library = normalize_library_call("half")
    flush = torch.zeros(64 * 2 ** 20, device="cuda")  # 256 MB of f32
    empty = lambda: flush.sum()  # noqa: E731
    for side in (64, 128, 256):
        x = torch.randint(0, 256, (TRAIN_BATCH, side, side, 3), generator=gen, device="cuda", dtype=torch.uint8)
        b = bound(normalize_bytes(x, torch.float32))["bound_ms"]
        k, lib = median_ms(lambda: normalize_kernel(x, "half")), median_ms(lambda: library(x))
        (cold, src), lib_cold = required_cold_us(lambda: normalize_kernel(x, "half"), empty, f"K1 at {list(x.shape)}"), \
            cold_device_us(lambda: library(x), empty)
        warm, lib_warm = device_us(lambda: normalize_kernel(x, "half")), device_us(lambda: library(x))
        log(f"[K1 normalize] half float32 {list(x.shape)} (training) on the device ({src}), L2 emptied by "
            f"a 256 MB read before each call: {against(cold, b)}, {cold / floor_us:.2f} launch floors; "
            f"torch.addcmul {'not measured' if lib_cold is None else f'{lib_cold / 1e3:.5f} ms'}; the same buffers "
            f"call after call {against(warm, b)}, torch.addcmul "
            f"{'not measured' if lib_warm is None else f'{lib_warm / 1e3:.5f} ms'}; events {k:.5f} ms, "
            f"torch.addcmul {lib:.5f} ms")
    del flush
    step_device_time("time train", t["step"], t["events_ms"], t["flops"])


def step_device_time(tag: str, step, events_ms: float, flops: float) -> None:
    """A whole train step on the device (torch.profiler over two steps after
    a warm-up): its kernels' time beside the f32 bound of its ``flops`` and
    its time by events, the device's idle share of the profiled wall time,
    and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                step()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 2
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(getattr(e, "device_time_total", 0) for e in events) / 2 / 1e3
        if busy > 0:
            top = sorted(events, key=lambda e: -getattr(e, "device_time_total", 0))[:6]
            least = flops / PEAK_F32 * 1e3
            log(f"[{tag}] a step on the device (torch.profiler): {busy:.1f} ms of kernels ({least / busy:.1%} of "
                f"the f32 bound) in {wall_ms:.1f} ms of profiled wall time (idle share {1 - busy / wall_ms:.1%}); "
                f"{events_ms:.1f} ms by events; the largest kernels: " + "; ".join(
                    f"{e.key[:60]} {getattr(e, 'device_time_total', 0) / 2 / 1e3:.1f} ms" for e in top))
            return
    log(f"[{tag}] a step on the device: not measured (torch.profiler recorded no device time)")


# ---------------------------------------------------------------------------
# 12. DAMSM pretraining and CounterModel training
# ---------------------------------------------------------------------------

N_CUB_TRAIN = 256         # training images of the CUB-style layout, 280-330 px JPEGs: 4 steps an epoch
N_CUB_TEST = 64           # its test split: one validation batch an epoch
CUB_CAPS = 10             # captions an image (--caps_per_img's default, CUB's count)
CUB_TRAIN_BATCH = 64      # pretraining's batch (TRAIN.BATCH_SIZE)
COUNTER_BATCH = 64        # the CounterModel's batch (TRAIN.BATCH_SIZE)
N_COUNTER_GEN = 64        # captions the generate CLI draws from the counter's EMA snapshot
#: the JAX CLI's defaults, the reference's miscc/config.py (tise_tpu/models/main.py:34-52): gf 128, df 64, z 100,
#: condition 100, embedding 256, R_NUM 2, 18 words; the CounterModel's seven scales reach 256 px
COUNTER_GAN = GanConfig()
#: the card-against-CPU counter step's width (the encoders keep their full width)
COUNTER_CHECK_GAN = GanConfig(gf_dim=16, df_dim=16)
#: f32 rounding of a sum of 2^18 terms in another order, relative to their scale: sqrt(2^18) x 2^-24
F32_SUM_ROUNDING = 2.0 ** 9 * 2.0 ** -24


def cub_train_vocab() -> tuple:
    """A synthesised vocabulary of the CUB size (5,450 entries, index 0 the
    padding token)."""
    words = ["<end>"] + [f"w{i:04d}" for i in range(1, CUB_NTOKEN)]
    return dict(enumerate(words)), {w: i for i, w in enumerate(words)}


def make_cub_train_data() -> dict:
    """Under build/chip_smoke/birds/ ("birds" in the path, so the dataset
    crops each image around its box, as on CUB): the reference's CUB layout
    of 256 training and 64 test JPEGs of 280-330 px under
    CUB_200_2011/images with images.txt and bounding_boxes.txt, 10
    captions an image of 4-25 words of the CUB-size vocabulary (5,450
    entries; some cut to 18) in captions.pickle, and filenames and class
    info a split (50 classes); 64 captions for the generate CLI."""
    from PIL import Image

    t0 = time.perf_counter()
    root = os.path.join(SCRATCH, "birds")
    data = os.path.join(root, "data")
    image_dir = os.path.join(data, "CUB_200_2011", "images")
    os.makedirs(image_dir)
    rng = np.random.RandomState(91)
    caps, rows = {}, []
    for split, n in (("train", N_CUB_TRAIN), ("test", N_CUB_TEST)):
        keys = [f"{split}{i:04d}" for i in range(n)]
        os.makedirs(os.path.join(data, split))
        for key in keys:
            im = train_image(rng)
            Image.fromarray(im).save(os.path.join(image_dir, f"{key}.jpg"), quality=90)
            h, w = im.shape[:2]
            rows.append((f"{key}.jpg", rng.randint(0, w // 4), rng.randint(0, h // 4), rng.randint(w // 3, w // 2),
                         rng.randint(h // 3, h // 2)))
        caps[split] = [list(rng.randint(1, CUB_NTOKEN, rng.randint(4, 26))) for _ in range(n * CUB_CAPS)]
        result_io.save_pickle(os.path.join(data, split, "filenames.pickle"), keys)
        result_io.save_pickle(os.path.join(data, split, "class_info.pickle"), [int(c) for c in rng.randint(1, 51, n)])
    with open(os.path.join(data, "CUB_200_2011", "images.txt"), "w") as f:
        f.write("".join(f"{i + 1} {r[0]}\n" for i, r in enumerate(rows)))
    with open(os.path.join(data, "CUB_200_2011", "bounding_boxes.txt"), "w") as f:
        f.write("".join(f"{i + 1} {r[1]}.0 {r[2]}.0 {r[3]}.0 {r[4]}.0\n" for i, r in enumerate(rows)))
    ixtoword, wordtoix = cub_train_vocab()
    b = {"root": root, "data": data, "vocab": os.path.join(data, "captions.pickle"),
         "captions": os.path.join(root, "captions_gen.pkl")}
    result_io.save_pickle(b["vocab"], [caps["train"], caps["test"], ixtoword, wordtoix])
    result_io.save_pickle(b["captions"], [{"caption_id": 950000 + i, "caption": " ".join(
        f"w{k:04d}" for k in rng.randint(1, CUB_NTOKEN, rng.randint(5, 19)))} for i in range(N_COUNTER_GEN)])
    log(f"[cub train data] {N_CUB_TRAIN} + {N_CUB_TEST} JPEGs with CUB boxes and "
        f"{len(caps['train']) + len(caps['test'])} captions of a {CUB_NTOKEN}-word vocabulary in "
        f"{time.perf_counter() - t0:.1f} s")
    return b


def grad_or_zero(p: torch.nn.Parameter) -> torch.Tensor:
    """A parameter's gradient on the CPU, zeros where no loss reached it (the
    CounterModel's 4 px image head: its D reads 8 .. 256 px)."""
    return torch.zeros(p.shape) if p.grad is None else p.grad.detach().cpu()


def module_rounding(got: dict, ref64: dict) -> float:
    """The f32 rounding of a module's gradient as a whole: the L2 distance of
    all its f32 gradients to the float64 ones over their norm."""
    diff = sum(float((got[k].double() - ref64[k].double()).norm() ** 2) for k in ref64)
    return (diff / sum(float(v.double().norm() ** 2) for v in ref64.values())) ** 0.5


def check_pretrain_step_against_cpu() -> None:
    """(a) One pretraining step at full width (the CUB vocabulary of 5,450
    words, embedding 256, InceptionV3 at 299) on 4 seeded 256 px images from
    the same seeded encoders: the card (K1, K2, cuDNN's LSTM in train mode,
    TF32 off) against the CPU in f32, each refereed by the CPU in float64.
    The metrics within 1e-4 relative of float64; the text encoder's (after
    the clip) and the heads' gradients as close to float64 as 3x the CPU's
    f32 rounding (``within_rounding``); the card's step launches K1 once, K2
    9 times and K2's backward never (the trunk runs under no_grad)."""
    cfg = damsm_pretrain.DamsmPretrainConfig(ntoken=CUB_NTOKEN)
    text, image = damsm.random_rnn_state_dict(3, CUB_NTOKEN), damsm.random_cnn_state_dict(3)
    rng = np.random.RandomState(92)
    images = rng.randint(0, 256, (CHECK_BATCH, 256, 256, 3)).astype(np.uint8)
    lens = rng.randint(4, 19, CHECK_BATCH).astype(np.int32)
    caps = np.where(np.arange(18)[None, :] < lens[:, None], rng.randint(1, CUB_NTOKEN, (CHECK_BATCH, 18)), 0)
    cls = np.array([4, 9, 4, 17], np.int32)
    out, launches = {}, {}
    for name, device, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                                ("cpu64", "cpu", torch.float64)):
        t0 = time.perf_counter()
        state = damsm_pretrain.init_state(cfg, text, image, device)
        state.text_encoder.to(dtype)
        state.image_encoder.to(dtype)
        reset_counters()
        metrics = damsm_pretrain.make_train_step(cfg)(state, images, caps.astype(np.int32), lens, cls)
        if name == "card":
            launches = counts()
        grads = {f"text.{k}": p.grad.cpu() for k, p in state.text_encoder.named_parameters()}
        grads.update({k: p.grad.cpu() for k, p in state.image_encoder.named_parameters() if k.startswith("emb_")})
        out[name] = ({k: float(v) for k, v in metrics.items()}, grads)
        log(f"[pretrain card vs cpu] the {name} step in {time.perf_counter() - t0:.1f} s (with its encoders)")
    require(launches["normalize"] == 1 and launches["avg_pool_3x3_s1_p1"] == 9
            and launches["avg_pool_3x3_s1_p1_backward"] == 0, f"the card's pretraining step launched {launches}")
    m_err = max(abs(out["card"][0][k] - v) / max(abs(v), 1.0) for k, v in out["cpu64"][0].items())
    ratios = {k: within_rounding(out["card"][1][k], out["cpu"][1][k], v) for k, v in out["cpu64"][1].items()}
    worst = max(ratios, key=ratios.get)
    log(f"[pretrain card vs cpu] metrics card {out['card'][0]}; largest relative difference from float64 "
        f"{m_err:.2e}; gradients: the largest card distance to float64 over 3x the CPU f32's, {worst} "
        f"{ratios[worst]:.3f}")
    require(m_err <= 1e-4, f"the card's pretraining metrics differ from float64 by {m_err}")
    require(ratios[worst] <= 1.0, f"the card's pretraining gradient of {worst} is {ratios[worst]:.3f} x the f32 "
                                  f"rounding away")


def check_counter_step_against_cpu() -> None:
    """(a) One CounterModel step at gf 16, df 16, batch 4 (lambda 5, the
    encoders at full width) from the same seeded state, batch and noise, on
    the card twice (K1, K2 and its backward, TF32 off; with cuDNN, as
    training runs, and without it, torch's own convolutions) against the
    CPU in f32, each refereed by the CPU in float64.  Each card step: K1
    once, K2 and its backward 9 times; every metric within 1e-3 relative of
    float64; the EMA's change within 2% plus two f32 spacings of the CPU's
    on at least 90% of G's parameters; G's and D's gradient as a whole as
    close to float64 as 3x the CPU's f32 rounding (``within_rounding``).
    Without cuDNN every G and D tensor too, its floor ``F32_SUM_ROUNDING``
    (a bias's gradient summed over 2^18 terms in another order than the
    CPU) and, for a tensor of fewer than 16 elements, the CPU's rounding of
    its module as a whole: f32 switches a few ReLUs and max-pool winners of
    the random InceptionV3 against float64, which moves G's gradient by
    0.4-2% (L2) in any f32 run, and one or a few elements say little of how
    far.  cuDNN's algorithms round the MSG D's input gradient more than the
    CPU's direct sums: the image heads that only the adversarial loss
    reaches sat 2.6e-4 to 7.4e-4 from float64 with cuDNN against 1e-6 to
    1.2e-4 on the CPU (up to 6.2x the tensor bound), and within it without."""
    cfg = trainer.TrainConfig(gan=COUNTER_CHECK_GAN, batch_size=CHECK_BATCH, ntoken=CUB_NTOKEN,
                              damsm=counter_trainer.default_config().damsm)
    gan = COUNTER_CHECK_GAN
    dicts = g_weights.TrainStateDicts(0, g_weights.random_g_state_dict(7, gan, "counter_model"), {},
                                      g_weights.random_msg_d_state_dict(8, gan.df_dim, gan.embedding_dim))
    text, image = damsm.random_rnn_state_dict(3, CUB_NTOKEN), damsm.random_cnn_state_dict(3)
    batch = trainer.synthetic_batch(cfg, np.random.RandomState(93), CHECK_BATCH)
    z, eps = generate.draw_noise(7, 0, CHECK_BATCH, gan.z_dim, gan.condition_dim, "cpu")
    out, launches = {}, {}
    for name, device, dtype in (("card", "cuda", torch.float32), ("card without cuDNN", "cuda", torch.float32),
                                ("cpu", "cpu", torch.float32), ("cpu64", "cpu", torch.float64)):
        t0 = time.perf_counter()
        torch.backends.cudnn.enabled = name != "card without cuDNN"
        try:
            models = counter_trainer.build_models(cfg, text, image, device)
            models = counter_trainer.CounterModels(*(m.to(dtype) for m in models))
            state = counter_trainer.init_state(cfg, models, dicts=dicts)
            reset_counters()
            metrics = counter_trainer.make_train_step(cfg, models)(state, batch, z.to(device, dtype),
                                                                   eps.to(device, dtype))
            launches[name] = counts()
        finally:
            torch.backends.cudnn.enabled = True
        grads = {"g": {k: grad_or_zero(p) for k, p in state.gnet.named_parameters()},
                 "d": {k: grad_or_zero(p) for k, p in state.dnet.named_parameters()}}
        ema = {k: v.cpu().double() - torch.from_numpy(dicts.g[k]).double() for k, v in state.g_ema.items()}
        out[name] = ({k: float(v) for k, v in metrics.items()}, grads, ema)
        log(f"[counter card vs cpu] the {name} step in {time.perf_counter() - t0:.1f} s (with its models)")
    for card_name in ("card", "card without cuDNN"):
        tag = f"[counter {card_name} vs cpu]"
        got = launches[card_name]
        require(got["normalize"] == 1 and got["avg_pool_3x3_s1_p1"] == 9 and got["avg_pool_3x3_s1_p1_backward"] == 9,
                f"the {card_name} counter step launched {got}")
        m_err = max(abs(out[card_name][0][k] - v) / max(abs(v), 1.0) for k, v in out["cpu64"][0].items())
        log(f"{tag} metrics {out[card_name][0]}; largest relative difference from float64 {m_err:.2e}")
        require(m_err <= 1e-3, f"the {card_name} counter step's metrics differ from float64 by {m_err}")
        for part in ("g", "d"):
            card, cpu, cpu64 = (out[n][1][part] for n in (card_name, "cpu", "cpu64"))
            rounding = module_rounding(cpu, cpu64)
            ratios = {part: within_rounding(*(torch.cat([d[k].double().flatten() for k in cpu64])
                                              for d in (card, cpu, cpu64)), F32_SUM_ROUNDING)}
            if card_name == "card without cuDNN":
                ratios.update({k: within_rounding(card[k], cpu[k], v, max(rounding if v.numel() < 16 else 0.0,
                                                                           F32_SUM_ROUNDING))
                               for k, v in cpu64.items()})
            worst = max(ratios, key=ratios.get)
            log(f"{tag} {part.upper()} gradients: the CPU's f32 {rounding:.2e} (L2) from float64, the card's "
                f"{module_rounding(card, cpu64):.2e} ({ratios[part]:.3f} of 3x the CPU's); the largest card distance "
                f"over 3x the CPU f32's, {worst} {ratios[worst]:.3f}")
            require(ratios[worst] <= 1.0, f"the {card_name} {part.upper()} gradient of {worst} is "
                                          f"{ratios[worst]:.3f} x the f32 rounding away")
        agree = moved = total = 0
        for k, want in out["cpu"][2].items():
            got_ema = out[card_name][2][k]
            spacing = torch.from_numpy(np.spacing(np.abs(dicts.g[k]))).double()
            agree += int(((got_ema - want).abs() <= 0.02 * want.abs() + 2 * spacing).sum())
            moved, total = moved + int(torch.count_nonzero(got_ema)), total + want.numel()
        log(f"{tag} the EMA's change agrees with the CPU's on {agree / total:.4%} of G's {total} parameters; it "
            f"moved {moved / total:.4%} of them")
        require(agree >= 0.9 * total and moved >= 0.9 * total, f"the {card_name}'s EMA did not follow the CPU's")


@contextlib.contextmanager
def keep_last_step(module, b: dict, key: str):
    """While a training CLI runs, ``module.make_train_step`` hands out steps
    that keep their function and the arguments of their last call (the
    CLI's own state among them) in ``b[key]``: the timings run that step
    again with nothing rebuilt."""
    make = module.make_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(*step_args):
            b[key] = functools.partial(step, *step_args)
            return step(*step_args)

        return run

    module.make_train_step = recording
    try:
        yield
    finally:
        module.make_train_step = make


def run_training_cli(tag: str, main, argv: list, max_epoch: int) -> tuple:
    """One run of a training CLI from 0 counts -> (its records, launches,
    seconds), with its time, peak memory and records logged."""
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        run = main(argv + ["--max_epoch", str(max_epoch)])
    seconds = time.perf_counter() - t0
    launches = counts()
    log(f"[{tag}] --max_epoch {max_epoch}: {seconds:.2f} s for {len(run)} epochs of {[r['steps'] for r in run]} "
        f"steps, peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; by epoch: " + "; ".join(
            f"{r['seconds']:.2f} s, {r['data_wait_s']:.3f} s waiting for data, " + ", ".join(
                f"{k} {v:.4f}" for k, v in r["metrics"].items())
            + (f", valid DAMSM_loss {r['valid']['damsm_loss']:.4f}" if "valid" in r else "") for r in run)
        + f"; launches {launches}")
    require(len(run) == (2 if max_epoch == 2 else 1), f"{tag} trained epochs {[r['epoch'] for r in run]} (a resume "
                                                      f"trains epoch 3 alone)")
    require(all(np.isfinite(v) for r in run for v in r["metrics"].values()), f"{tag}: a loss is not finite: {run}")
    return run, launches, seconds


def path_damsm_pretrain(b: dict) -> list:
    """(b) ``models.damsm_pretrain.main`` at full width (the CUB vocabulary,
    embedding 256, 18 words, 256 px images, batch 64: 4 steps an epoch) from
    seeded encoders over the layout: 2 epochs with a validation pass over
    the 64 test images and a snapshot each, then a resume for a third.  Each
    run launches K1 once and K2 9 times a step and a validation batch and
    K2's backward never; the losses are finite, the best encoders are
    written as .npz, only the newest snapshot is kept."""
    out = os.path.join(b["root"], "damsm")
    argv = ["--data_dir", b["data"], "--output_dir", out, "--batch_size", str(CUB_TRAIN_BATCH),
            "--snapshot_interval", "1", "--device", "cuda"]
    paths, records = [], []
    for max_epoch in (2, 3):
        with keep_last_step(damsm_pretrain, b, "pretrain_step") if max_epoch == 3 else contextlib.nullcontext():
            run, launches, _ = run_training_cli("pretrain", damsm_pretrain.main, argv, max_epoch)
        steps, val = sum(r["steps"] for r in run), sum(r.get("valid", {}).get("batches", 0) for r in run)
        require(steps == len(run) * (N_CUB_TRAIN // CUB_TRAIN_BATCH) and val == len(run) * (N_CUB_TEST // CUB_TRAIN_BATCH),
                f"pretraining ran {steps} steps and {val} validation batches")
        require(all(np.isfinite(r["valid"]["damsm_loss"]) for r in run), "a validation loss is not finite")
        require(launches["normalize"] == steps + val and launches["avg_pool_3x3_s1_p1"] == 9 * (steps + val)
                and launches["avg_pool_3x3_s1_p1_backward"] == 0, f"pretraining launched {launches}")
        require(sorted(os.listdir(os.path.join(out, "checkpoints"))) == [f"epoch_{max_epoch}.pt"],
                "only the newest snapshot is kept")
        records += run
        paths.append(launches)
    b["text"], b["image"] = (os.path.join(out, f"best_{k}_encoder.npz") for k in ("text", "image"))
    require(os.path.isfile(b["text"]) and os.path.isfile(b["image"]), "the best encoders were not written")
    b["pretrain"] = records
    return paths


def path_counter_train(b: dict) -> list:
    """(c) ``models.main --model counter_model`` at the JAX CLI's defaults
    (gf 128, df 64, R_NUM 2, z 100, condition 100, embedding 256, 18 words,
    seven scales to 256 px, lambda 5, batch 64: 4 steps an epoch) from the
    pretrained best encoders (.npz): 2 epochs with a snapshot each and a
    resume for a third; then the generate CLI with ``--model
    counter_model`` on the third snapshot's EMA .npz for 64 captions.  Each
    training run launches K1 once (the 256 px image), K2 and its backward 9
    times a step (the DAMSM encoder on the 256 px fakes) and keeps only its
    newest snapshot; the losses are finite and the images not flat."""
    out = os.path.join(b["root"], "counter")
    argv = ["--model", "counter_model", "--data_dir", b["data"], "--output_dir", out, "--net_e", b["text"],
            "--image_encoder", b["image"], "--batch_size", str(COUNTER_BATCH), "--caps_per_img", str(CUB_CAPS),
            "--snapshot_interval", "1", "--num_workers", "8", "--device", "cuda"]
    paths, records = [], []
    for max_epoch in (2, 3):
        with keep_last_step(counter_trainer, b, "counter_step") if max_epoch == 3 else contextlib.nullcontext():
            run, launches, _ = run_training_cli("counter", train_main.main, argv, max_epoch)
        steps = sum(r["steps"] for r in run)
        require(steps == len(run) * (N_CUB_TRAIN // COUNTER_BATCH), f"the counter trained {steps} steps")
        require(launches["normalize"] == steps and launches["avg_pool_3x3_s1_p1"] == 9 * steps
                and launches["avg_pool_3x3_s1_p1_backward"] == 9 * steps, f"counter training launched {launches}")
        require(sorted(os.listdir(os.path.join(out, "checkpoints"))) == [f"epoch_{max_epoch}.npz",
                                                                         f"epoch_{max_epoch}.pt"],
                "only the newest snapshot is kept")
        records += run
        paths.append(launches)
    b["counter"] = records
    gen_dir = os.path.join(out, "generated")
    run_cli("generate from the counter's EMA snapshot", generate.main, [
        "--caption_file", b["captions"], "--output_dir", gen_dir, "--checkpoint",
        os.path.join(out, "checkpoints", "epoch_3.npz"), "--text_encoder", b["text"], "--captions_pickle", b["vocab"],
        "--model", "counter_model", "--device", "cuda"], N_COUNTER_GEN)
    images = read_pngs(gen_dir)
    stds = np.array([a.std() for a in images.values()])
    require(len(images) == N_COUNTER_GEN and all(a.shape == (256, 256, 3) for a in images.values()),
            "the counter's generated images")
    log(f"[counter] {len(images)} images from the EMA snapshot, pixel std {stds.min():.2f}-{stds.max():.2f}")
    require(stds.min() > 1.0, f"a generated image is flat (pixel std {stds.min():.2f})")
    return paths


def step_events_ms(fn, reps: int = 3) -> list:
    """CUDA events around each of ``reps`` calls of a whole step."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cli_step_timing(b: dict, key: str) -> tuple:
    """The last step of ``b[key]``'s resumed CLI run, run again on its own
    state (``keep_last_step``): once under torch's FLOP counter
    (convolutions and matrix products, forward and backward), then 3 times
    by events from a reset peak -> (the call, FLOPs, the median ms, the
    times, peak GiB); and the CLI's own seconds and data wait a step from
    its records."""
    from torch.utils.flop_counter import FlopCounterMode

    call = b.pop(f"{key}_step")
    with FlopCounterMode(display=False) as fc:
        call()
    torch.cuda.reset_peak_memory_stats()
    times = step_events_ms(call)
    steps = sum(r["steps"] for r in b[key])
    per_step = (sum(r["seconds"] for r in b[key]) / steps, sum(r["data_wait_s"] for r in b[key]) / steps)
    return call, fc.get_total_flops(), statistics.median(times), times, torch.cuda.max_memory_allocated() / 2 ** 30, \
        per_step


def pretrain_timings(b: dict) -> None:
    """(d) A pretraining step at full width on a batch of 64 from the layout,
    f32, TF32 off, on the CLI's own state: its time by events (the median
    of 3) and on the device (``step_device_time``), its operations against
    the f32 bound, peak memory; the CLI's time a step and the host's wait
    for data a step from the runs' records."""
    pcall, pflops, pms, ptimes, ppeak, per_step = cli_step_timing(b, "pretrain")
    log(f"[time pretrain] a step at embedding 256, the CUB vocabulary, 256 px, batch {CUB_TRAIN_BATCH}: {pms:.2f} ms "
        f"by events ({[round(x, 2) for x in ptimes]}; {CUB_TRAIN_BATCH / pms * 1e3:.1f} images/s), "
        f"{pflops / 1e12:.4f} TFLOP (f32 bound {pflops / PEAK_F32 * 1e3:.2f} ms, "
        f"{pflops / PEAK_F32 * 1e3 / pms:.1%} of the events' time), peak memory {ppeak:.2f} GiB; in the CLI a step "
        f"took {per_step[0] * 1e3:.1f} ms with the epochs' first steps and the host waited "
        f"{per_step[1] * 1e3:.1f} ms a step for data")
    step_device_time("time pretrain", pcall, pms, pflops)
    del pcall
    torch.cuda.empty_cache()


def counter_timings(b: dict) -> None:
    """(d) A CounterModel step at full width on a batch of 64 from the
    layout, f32, TF32 off, on the CLI's own state: as ``pretrain_timings``,
    and the G forward by part (``forward_flops``)."""
    call, flops, ms, times, peak, per_step = cli_step_timing(b, "counter")
    state, batch, z, eps = call.args
    gnet = state.gnet
    with torch.no_grad():
        caps = torch.from_numpy(batch.captions.astype(np.int64)).cuda()
        text_encoder = damsm.RNNEncoder.from_state_dict(damsm.load_rnn_state_dict(b["text"]), device="cuda")
        words, sent = text_encoder(caps, batch.cap_lens)
        g_parts = forward_flops(gnet, lambda: gnet(z, sent, words, caps == 0, eps))
    least = flops / PEAK_F32 * 1e3
    log(f"[time counter] a step at gf 128, df 64, R_NUM 2, seven scales to 256 px, batch {COUNTER_BATCH}: {ms:.1f} ms "
        f"by events ({[round(x, 1) for x in times]}; {COUNTER_BATCH / ms * 1e3:.1f} images/s), {flops / 1e12:.3f} "
        f"TFLOP ({flops / COUNTER_BATCH / 1e9:.1f} GFLOP an image; f32 bound {least:.1f} ms, {least / ms:.1%} of the "
        f"events' time), peak memory {peak:.2f} GiB; G's forward {sum(g_parts.values()) / COUNTER_BATCH / 1e9:.1f} "
        f"GFLOP an image (" + ", ".join(f"{k} {v / COUNTER_BATCH / 1e9:.1f}" for k, v in sorted(
            g_parts.items(), key=lambda kv: -kv[1])[:5]) + f"); in models.main a step took "
        f"{per_step[0] * 1e3:.1f} ms with the epochs' first steps and the host waited "
        f"{per_step[1] * 1e3:.1f} ms a step for data")
    step_device_time("time counter", call, ms, flops)
    del call, state, gnet
    torch.cuda.empty_cache()


L2_BYTES = 50 * 2 ** 20  # the L2 cache of one H100 SXM (NVIDIA's data sheet)


def cold_device_us(fn, empty, calls: int = 20):
    """Device time of one call of ``fn`` with ``empty()`` (an L2 flush) run
    before it: the sum of the kernels that torch.profiler records, less the
    kernels that ``empty`` launches on its own; or None where it records
    none."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(body) -> list:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                body()
            torch.cuda.synchronize()
        return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]

    fn()
    empty()
    torch.cuda.synchronize()
    flush_kernels = set()
    for _ in range(PROFILE_TRIES):  # a profiled run may come back without its device rows, as device_us allows
        rows = kernels(empty)
        if whole(rows, calls):
            flush_kernels = {e.key for e in rows}
            break
    if not flush_kernels:
        return None
    for _ in range(PROFILE_TRIES):
        rows = [e for e in kernels(lambda: (empty(), fn())) if e.key not in flush_kernels]
        if whole(rows, calls):
            return sum(getattr(e, "device_time_total", 0) for e in rows) / calls
    return None


def required_cold_us(fn, empty, what: str) -> tuple:
    """``cold_device_us`` for a reading the run requires, as ``required_us``:
    where the profiler records none, CUDA events around the flush and the
    call, less the flush's own."""
    us = cold_device_us(fn, empty)
    if us is not None:
        return us, "torch.profiler"
    log(f"[profiler] recorded no kernel of {what} after the L2 flush in {PROFILE_TRIES} profiled runs: timed by "
        f"CUDA events instead")
    return (median_ms(lambda: (empty(), fn())) - median_ms(empty)) * 1e3, "CUDA events: torch.profiler recorded none"


def cub_device_times(gen: torch.Generator, half: dict, floor_us: float, t: dict) -> None:
    """K1 under ``half`` on the device (required), beside its bound, in launch
    floors and beside ``torch.addcmul``: as every kernel is read here, with
    the same buffers call after call, and with the L2 cache emptied before
    each call by a read of 256 MB; the K1 cases of NORMALIZE_TIMED under
    ``clip`` cold as well.  Their bytes fit in L2, where the repeated calls
    find them.  Then the DAMSM image and text encoders a block of 32 on the
    device beside their time by events.  Run with
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
            (warm, src), lib_warm = required_us(lambda: normalize_kernel(x, recipe, dtype), f"K1 at {label}"), \
                device_us(lambda: library(x))
            log(f"[K1 normalize] {label} on the device ({src}), the same buffers call after call: "
                f"{against(warm, least)}, {warm / floor_us:.2f} launch floors; torch.addcmul "
                f"{'not measured' if lib_warm is None else f'{lib_warm / 1e3:.5f} ms'}")
        cold, src = required_cold_us(lambda: normalize_kernel(x, recipe, dtype), empty, f"K1 at {label}")
        lib_cold = cold_device_us(lambda: library(x), empty)
        log(f"[K1 normalize] {label} on the device ({src}), L2 emptied by a 256 MB read before each "
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
    Run with probe_device_times."""
    x = torch.randint(0, 256, (CA_BATCH, ca.IMAGE_SIZE, ca.IMAGE_SIZE, 3), generator=gen, device="cuda",
                      dtype=torch.uint8)
    require(normalize_bytes(x, torch.float32) > L2_BYTES, "K1 at CA's shape fits in L2")
    flush = torch.zeros(64 * 2 ** 20, device="cuda")  # 256 MB of f32
    empty = lambda: flush.sum()  # noqa: E731
    library = normalize_library_call("imagenet")
    least = bound(normalize_bytes(x, torch.float32))["bound_ms"]
    cold, src = required_cold_us(lambda: normalize_kernel(x, "imagenet"), empty, "K1 at CA's shape")
    lib_cold = cold_device_us(lambda: library(x), empty)
    log(f"[K1 normalize] imagenet float32 {list(x.shape)} on the device ({src}), cold (L2 emptied before "
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


# ---------------------------------------------------------------------------
# 13. multi-process: the FID and RP-COCO CLIs and the sharded AttnGAN++ step
#     on two ranks of the card (torch.distributed)
# ---------------------------------------------------------------------------

MULTI = os.path.join(SCRATCH, "multi")
MULTI_WORLD = 2
MULTI_IMAGES = 1024       # FID's images a side, the first of phase (1)'s folders
MULTI_RP = 512            # RP-COCO's items, the first of the CLIP phase's
MULTI_BATCH = 64          # the sharded step's global batch: 32 a rank
MULTI_STEPS = 2
MULTI_TIMEOUT = 600       # s for both ranks together
#: the sharded step against the one-process step: 3x the CPU test's bound of 4x the one-process step's
#: f32 rounding (tests/test_torch_multihost_train.py), the rounding here being the one-process step's
#: distance to the same step without cuDNN (no float64 step at this width fits beside it)
MULTI_BOUND = 12.0
MULTI_MODULES = ("g", "d64", "d128", "d256")


def multi_world() -> tuple:
    """The sharded step's world, the same from its seeds in every process:
    (config, seeded G and D state, the encoders' seeded state dicts, the
    global batches, the global noise of each step)."""
    cfg = trainer.TrainConfig(gan=TRAIN_GAN, batch_size=MULTI_BATCH, ntoken=gen_bench.COCO_NTOKEN)
    dicts = g_weights.TrainStateDicts(0, g_weights.random_g_state_dict(7, TRAIN_GAN), {}, {
        s: g_weights.random_d_state_dict(7 + s, TRAIN_GAN.df_dim, TRAIN_GAN.embedding_dim, s) for s in (64, 128, 256)})
    encoders = (damsm.random_rnn_state_dict(0, gen_bench.COCO_NTOKEN, nhidden=TRAIN_GAN.embedding_dim // 2),
                damsm.random_cnn_state_dict(0, nef=TRAIN_GAN.embedding_dim))
    batches = [trainer.synthetic_batch(cfg, np.random.RandomState(90 + k), MULTI_BATCH) for k in range(MULTI_STEPS)]
    noise = [generate.draw_noise(9, k, MULTI_BATCH, TRAIN_GAN.z_dim, TRAIN_GAN.condition_dim, "cpu")
             for k in range(MULTI_STEPS)]
    return cfg, dicts, encoders, batches, noise


def multi_steps(cfg, models, dicts, batches, noise, group, steps: int = MULTI_STEPS) -> tuple:
    """``steps`` steps from the seeded state, sharded over ``group`` (one
    process for ``None``) -> (per step: the metrics, each module's gradient,
    G's running statistics and the Ds' u, each as one vector on the host;
    the steps' ms by events; ``state_digest`` of the state they leave)."""
    device = next(models.gnet.parameters()).device
    state = trainer.init_state(cfg, models, dicts=dicts)
    step = trainer.make_sharded_train_step(cfg, models, group)
    rows = trainer.local_rows(MULTI_BATCH, group)
    records, times = [], []
    for batch, (z, eps) in list(zip(batches, noise))[:steps]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(state, trainer.shard_batch(batch, group), z[rows].to(device), eps[rows].to(device))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        modules = {"g": state.gnet, **{f"d{s}": d for s, d in state.dnets.items()}}
        records.append({
            "metrics": {k: float(v) for k, v in metrics.items()},
            **{k: torch.cat([p.grad.reshape(-1) for p in m.parameters()]).cpu() for k, m in modules.items()},
            "stats": torch.cat([v.reshape(-1) for k, v in state.gnet.state_dict().items()
                                if k.endswith(("running_mean", "running_var"))]).cpu(),
            "u": torch.cat([v.reshape(-1) for d in state.dnets.values()
                            for k, v in d.state_dict().items() if k.endswith(".u")]).cpu()})
    return records, times, state_digest(state)


def multi_ratios(got: list, one: list, plain: list) -> dict:
    """Per step and module, the L2 distance of ``got`` to the one-process
    step over MULTI_BOUND x (the one-process step's distance to the same step
    without cuDNN + 1e-5 of its norm): at most 1 passes; the metrics'
    largest distance relative to max(|one-process|, 1) over 3e-4 (3x the
    CPU test's 1e-4)."""
    out = {}
    for k, (g, o, p) in enumerate(zip(got, one, plain)):
        out[f"step{k + 1}.metrics"] = max(abs(g["metrics"][m] - v) / max(abs(v), 1.0)
                                          for m, v in o["metrics"].items()) / 3e-4
        for name in (*MULTI_MODULES, "stats", "u"):
            a, b, c = (x[name].double() for x in (g, o, p))
            out[f"step{k + 1}.{name}"] = float((a - b).norm()) / (
                MULTI_BOUND * (float((b - c).norm()) + 1e-5 * float(b.norm())) + 1e-300)
    return out


def state_digest(state) -> str:
    """sha256 of every parameter, buffer and EMA tensor a step leaves."""
    import hashlib

    h = hashlib.sha256()
    for module in (state.gnet, *state.dnets.values()):
        for v in module.state_dict().values():
            h.update(v.detach().cpu().numpy().tobytes())
    for v in state.g_ema.values():
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def rank_main(rank: int, world: int, port: int) -> None:
    """One rank of phase (10), started by ``path_multi``: the FID and RP-COCO
    CLIs with ``--coordinator`` (the first joins the cluster), then the
    sharded step on the group ``parallel.step_group`` picks (gloo: the ranks
    share the card); writes its seconds by stage, the step's ms by events,
    peak memory, the group's backend, its launch counts and a digest of its
    state to ``MULTI/rank<rank>.json``, and rank 0 its step records."""
    import torch.distributed as dist

    from tise_tpu_torch import parallel

    configure_precision("highest")
    with open(os.path.join(MULTI, "plan.json")) as f:
        plan = json.load(f)
    flags = ["--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world), "--process-id", str(rank)]
    out = {"seconds": {}}
    reset_counters()
    for tag, main_fn, argv in (("fid", fid.main, plan["fid"]), ("rp", rp_coco.main, plan["rp"])):
        t0 = time.perf_counter()
        main_fn([*argv, os.path.join(MULTI, f"{tag}_rank{rank}.txt"), *flags])
        torch.cuda.synchronize()
        out["seconds"][tag] = time.perf_counter() - t0
    t0 = time.perf_counter()
    device = torch.device("cuda", torch.cuda.current_device())
    group = parallel.step_group(device)
    out["backend"] = dist.get_backend(group)
    cfg, dicts, (text_state, image_state), batches, noise = multi_world()
    models = trainer.build_models(cfg, text_state, image_state, device)
    out["seconds"]["step world"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    records, out["step_ms"], out["digest"] = multi_steps(cfg, models, dicts, batches, noise, group)
    out["seconds"]["steps"] = time.perf_counter() - t0
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["launches"] = counts()
    if rank == 0:
        torch.save(records, os.path.join(MULTI, "rank0_records.pt"))
    with open(os.path.join(MULTI, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_ranks(world: int) -> list:
    """``world`` fresh processes of this script in rank mode on the card,
    each with its log file; ``wait_ranks`` ends them."""
    port = free_port()
    procs = []
    for rank in range(world):
        log_file = open(os.path.join(MULTI, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(rank), "--world",
                                        str(world), "--port", str(port)], cwd=ROOT, stdout=log_file,
                                       stderr=subprocess.STDOUT), log_file))
    return procs


def wait_ranks(procs: list, deadline: float) -> None:
    """Wait for the ranks of ``start_ranks``; all are killed when one fails
    or the monotonic clock passes ``deadline``, and none outlives this call."""
    failed = None
    try:
        while failed is None and any(p.poll() is None for p, _ in procs):
            failed = next((f"rank {r} exited with {p.returncode}" for r, (p, _) in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if time.monotonic() > deadline:
                failed = f"the ranks did not end within {MULTI_TIMEOUT} s of their start"
            time.sleep(0.5)
        failed = failed or next((f"rank {r} exited with {p.returncode}" for r, (p, _) in enumerate(procs)
                                 if p.returncode != 0), None)
    finally:
        for p, log_file in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log_file.close()
    for rank in range(len(procs)):
        with open(os.path.join(MULTI, f"rank{rank}.log")) as f:
            for line in f.read().splitlines()[-40 if failed else -8:]:
                log(f"[multi rank {rank}] {line}")
    require(failed is None, f"phase (10): {failed}")


def path_multi(d: dict, c: dict, smi: str) -> list:
    """(10) Two ranks on the one card, in fresh processes joined by
    ``torch.distributed`` at 127.0.0.1 (gloo; the kernels were built by
    ``setup``): the f32 FID CLI on the first 1,024 images of phase (1)'s
    two folders (the extractor's shard and allgather, K1 ``fid`` and K2)
    and the RP-COCO CLI on the first 512 CLIP items (the items sharded, the
    bank replicated, K1 ``clip``): each rank's result file byte-equal to the
    one-process run here, made while the ranks run; then the sharded
    AttnGAN++ step at the published COCO width (gf 64, df 32, R_NUM 3,
    256 px), global batch 64, 32 a rank, 2 steps over the gloo group
    (through the host), held to the one-process step (``multi_ratios``),
    both ranks ending with the same state.  After the ranks have ended,
    here: the one-process step, the same step without cuDNN (the referee of
    f32 rounding), and one step through a one-rank NCCL group, held the
    same way.  Returns each rank's launch counts."""
    import torch.distributed as dist

    from tise_tpu_torch import parallel

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"[multi] {smi}; the earlier phases hold {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card")
    os.makedirs(MULTI)
    folders = {}
    for side in ("a", "b"):
        folders[side] = os.path.join(MULTI, side)
        os.makedirs(folders[side])
        for name in sorted(os.listdir(d[side]))[:MULTI_IMAGES]:
            os.link(os.path.join(d[side], name), os.path.join(folders[side], name))
    rp_items = os.path.join(MULTI, "rp.pkl")
    result_io.save_pickle(rp_items, c["items"][:MULTI_RP])
    plan = {"fid": ["--path1", folders["a"], "--path2", folders["b"], "--weights", d["weights"], "--sqrtm", "eigh",
                    "--batch-size", str(BATCH), "--saved_file"],
            "rp": ["--image_dir", c["images"], "--weights", c["weights"], "--bpe_path", c["bpe"],
                   "--rp_input_file", rp_items, "--batch_size", str(BATCH), "--saved_file_path"]}
    with open(os.path.join(MULTI, "plan.json"), "w") as f:
        json.dump(plan, f)
    seconds = {}
    t_ranks = time.perf_counter()
    procs = start_ranks(MULTI_WORLD)
    deadline = time.monotonic() + MULTI_TIMEOUT
    try:  # the one-process CLI runs here while the ranks start up and run theirs
        for tag, main_fn in (("fid", fid.main), ("rp", rp_coco.main)):
            t0 = time.perf_counter()
            main_fn([*plan[tag], os.path.join(MULTI, f"{tag}_one.txt")])
            torch.cuda.synchronize()
            seconds[tag] = time.perf_counter() - t0
    except BaseException:
        for p, log_file in procs:
            p.kill()
            p.wait()
            log_file.close()
        raise
    wait_ranks(procs, deadline)
    seconds["ranks"] = time.perf_counter() - t_ranks

    cfg, dicts, (text_state, image_state), batches, noise = multi_world()
    models = trainer.build_models(cfg, text_state, image_state, "cuda")
    torch.cuda.reset_peak_memory_stats()
    one, one_ms, _ = multi_steps(cfg, models, dicts, batches, noise, None)
    peak_one = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    torch.backends.cudnn.enabled = False
    try:
        plain, plain_ms, _ = multi_steps(cfg, models, dicts, batches, noise, None)
    finally:
        torch.backends.cudnn.enabled = True
    seconds["no-cudnn steps"] = time.perf_counter() - t0
    parallel.init_distributed(f"127.0.0.1:{free_port()}", 1, 0, "cuda")
    try:
        nccl_group = parallel.step_group(torch.device("cuda", torch.cuda.current_device()))
        nccl_backend = dist.get_backend(nccl_group)
        require(nccl_backend == "nccl", f"one rank with a card of its own took {nccl_backend}, not nccl")
        nccl, nccl_ms, _ = multi_steps(cfg, models, dicts, batches, noise, nccl_group, steps=1)
    finally:
        dist.destroy_process_group()
    del models
    torch.cuda.empty_cache()
    log(f"[multi] here: FID CLI {seconds['fid']:.2f} s and RP-COCO CLI {seconds['rp']:.2f} s in one process (beside "
        f"the ranks, which took {seconds['ranks']:.1f} s from their start to their end); the "
        f"one-process step at batch {MULTI_BATCH} {[round(x, 1) for x in one_ms]} ms by events (peak "
        f"{peak_one:.2f} GiB), without cuDNN {[round(x, 1) for x in plain_ms]} ms "
        f"({seconds['no-cudnn steps']:.1f} s); the one-rank {nccl_backend} step {[round(x, 1) for x in nccl_ms]} ms")
    ratios = multi_ratios(nccl, one, plain)
    worst = max(ratios, key=ratios.get)
    log(f"[multi nccl] the one-rank NCCL step against the one-process step, each over its bound: "
        f"{ {k: round(v, 4) for k, v in ratios.items()} }")
    require(ratios[worst] <= 1.0, f"the one-rank NCCL step's {worst} is {ratios[worst]:.3f} x its bound")

    ranks = []
    for rank in range(MULTI_WORLD):
        with open(os.path.join(MULTI, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
        for tag in ("fid", "rp"):
            with open(os.path.join(MULTI, f"{tag}_rank{rank}.txt"), "rb") as f, \
                    open(os.path.join(MULTI, f"{tag}_one.txt"), "rb") as g:
                require(f.read() == g.read(), f"rank {rank}'s {tag} result file differs from one process's")
        r = ranks[-1]
        log(f"[multi rank {rank}] {smi}; the step's group {r['backend']}; seconds by stage "
            f"{ {k: round(v, 2) for k, v in r['seconds'].items()} }; the step at {MULTI_BATCH // MULTI_WORLD} a rank "
            f"{[round(x, 1) for x in r['step_ms']]} ms by events (two ranks sharing one card: not a two-card rate); "
            f"peak {r['peak_gib']:.2f} GiB; launches {r['launches']}")
    require(all(r["backend"] == "gloo" for r in ranks), "ranks sharing one card must step over gloo")
    require(ranks[0]["digest"] == ranks[1]["digest"], "the ranks ended the sharded step with different states")
    ratios = multi_ratios(torch.load(os.path.join(MULTI, "rank0_records.pt")), one, plain)
    worst = max(ratios, key=ratios.get)
    log(f"[multi] FID and RP-COCO result files byte-equal on both ranks and in one process; the two-rank step "
        f"against the one-process step, each over its bound: { {k: round(v, 4) for k, v in ratios.items()} }; "
        f"both ranks' states equal (sha256 {ranks[0]['digest'][:16]})")
    require(ratios[worst] <= 1.0, f"the two-rank step's {worst} is {ratios[worst]:.3f} x its bound")
    for r in ranks:
        require(r["launches"]["normalize"] > 0 and r["launches"]["avg_pool_3x3_s1_p1"] > 0
                and r["launches"]["avg_pool_3x3_s1_p1_backward"] == 9 * MULTI_STEPS, f"a rank launched {r['launches']}")
    log(f"[multi] phase (10) took {time.perf_counter() - t_phase:.1f} s ({seconds['ranks']:.1f} s of it the ranks, "
        f"with the one-process CLI runs beside them)")
    return [r["launches"] for r in ranks]


def main() -> None:
    t_start = time.perf_counter()
    mark = lambda what: log(f"[elapsed] {time.perf_counter() - t_start:.1f} s at the end of {what}")  # noqa: E731
    smi = setup()
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {
        "normalize": check_normalize(gen),
        "avg_pool_3x3_s1_p1": check_avg_pool(gen),
        "avg_pool_3x3_s1_p1_backward": check_pool_backward(gen),
        "epilogue_matmul": check_epilogue_matmul(gen),
        **check_layout_probes(),
        "stem_mm": check_stem_mm(),
    }
    mark("the kernel checks")
    d = make_data()
    state_dict = fid.load_weights(d["weights"], "weights")
    check_trunks_against_cpu(state_dict)
    f32 = path_fid_f32(d, state_dict)
    per_path = [f32["launches"], path_fid_fast(d, state_dict, f32), path_is_star(d), path_o_is(d), path_probes()]
    mark("the Inception paths")
    c = make_clip_data()
    per_path += [path_rp(c), path_pa(c)]
    towers = clip_checks(c)
    mark("the CLIP paths")
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
    t_gen = time.perf_counter()
    g = make_gen_data()
    check_generators_against_cpu(g)
    path_generate(g)
    path_generate_grouped(g)
    path_gen_example(g)
    per_path += path_gen_metrics(g, d)
    gen_bench_timings()
    path_calibration(g)
    log(f"[gen] the generation phase took {time.perf_counter() - t_gen:.1f} s")
    t_train = time.perf_counter()
    tr = make_train_data()
    check_encoder_gradient(tr)
    check_train_step_against_cpu(tr)
    per_path += path_train(tr)
    train_t = train_timings(tr)
    log(f"[train] the training phase took {time.perf_counter() - t_train:.1f} s")
    t_counter = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"[counter] the earlier phases hold {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card")
    cb = make_cub_train_data()
    check_pretrain_step_against_cpu()
    check_counter_step_against_cpu()
    per_path += path_damsm_pretrain(cb)
    pretrain_timings(cb)
    per_path += path_counter_train(cb)
    counter_timings(cb)
    log(f"[counter] the DAMSM pretraining and CounterModel phase took {time.perf_counter() - t_counter:.1f} s")
    mark("the training phases")
    warm_profiler()
    pool_device_times(gen)
    epilogue_device_times(gen)
    floor_us = launch_floor()
    normalize_device_times(gen, floor_us)
    probe_device_times(floor_us)
    clip_device_times(towers)
    cub_device_times(gen, half, floor_us, encoders)
    ca_device_times(gen, floor_us, counter_t)
    train_device_times(gen, floor_us, train_t)
    mark("the device times")
    # after the profiler: with phase (10) before them, torch.profiler here came back without device rows
    # for many of its readings (NVIDIA H100 80GB HBM3, 700.00 W); its ranks are fresh processes
    per_path += path_multi(d, c, smi)
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
    if "--rank" in sys.argv:  # one rank of phase (10), started by path_multi
        args = dict(zip(sys.argv[1::2], map(int, sys.argv[2::2])))
        sys.exit(rank_main(args["--rank"], args["--world"], args["--port"]))
    sys.exit(main())
