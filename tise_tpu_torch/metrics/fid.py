"""FID — Fréchet Inception Distance (mirrors tise_tpu/metrics/fid.py;
reference: image_realism/FID/fid_score.py).

Pipeline parity:
  folder -> PIL resize 299 bilinear (transforms.Resize, fid_score.py:208-213)
         -> [0,1] -> TTUR renormalization (inception.py:120-124; kernel K1)
         -> InceptionV3 pool3 (2048)  [kernel K2 in every A/C/E pool branch;
            ``--precision fast``: the bf16 BN-folded trunk, K2 on the thin
            fan-out slices; ``--device-resize-from N``: the host only decodes
            N x N images, K1 and the resize to 299 run on the device]
         -> mean / covariance         (np.mean / np.cov, fid_score.py:194-195)
  FID = ||mu1-mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2))   (fid_score.py:121-171;
        ``--sqrtm ns-pallas`` runs the matrix square root through kernel K3)

Either path may be a cached ``.npz`` with ``mu``/``sigma`` (fid_score.py:200-203).
``legacy_compat`` reproduces the reference's drop_last tail-batch discard
(fid_score.py:216); the default keeps every image (padded + masked batches).
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from tise_tpu_torch.backbones.inception_fast import FastInception
from tise_tpu_torch.backbones.inception_v3 import InceptionV3
from tise_tpu_torch.core import io as result_io
from tise_tpu_torch.core import weights as weights_io
from tise_tpu_torch.core.config import (add_device_flag, add_distributed_flags, add_precision_flag, configure_precision,
                                        maybe_init_distributed, resolve_device)
from tise_tpu_torch.core.data import ImageFolderLoader
from tise_tpu_torch.metrics.extractor import BatchedExtractor, run_resumable
from tise_tpu_torch.ops import sqrtm, stats

IMAGE_SIZE = 299


def make_pool3_extractor(
    state_dict: Mapping[str, np.ndarray], device, *, device_resize_from: int = 0, fast: bool = False
) -> BatchedExtractor:
    """The InceptionV3 pool3 extractor on ``device`` under the "fid" recipe.
    ``fast=True`` routes the forward through the BN-folded bf16 FastInception
    (bf16-tolerance parity with the module); the default keeps the f32 module
    for reference float parity."""
    if fast:
        fast_model = FastInception(state_dict, torch.bfloat16, device=device)

        def apply_fn(x: torch.Tensor):
            return {"pool3": fast_model(x, endpoints=("pool3",))["pool3"].float()}

    else:
        model = InceptionV3.from_state_dict(state_dict, device=device)

        def apply_fn(x: torch.Tensor):
            return model(x, endpoints=("pool3",))

    return BatchedExtractor(apply_fn, recipe="fid", device=device,
                            device_resize_to=IMAGE_SIZE if device_resize_from else None)


def compute_statistics_of_path(
    path: str,
    extractor: Optional[BatchedExtractor],
    batch_size: int = 64,
    *,
    legacy_compat: bool = False,
    streaming: bool = False,
    host_image_size: int = IMAGE_SIZE,
    snapshot_path: str = "",
    build_extractor: Optional[Callable[[], BatchedExtractor]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """mu/sigma of a folder (or load a cached npz); fid_score.py:199-220.
    ``host_image_size`` < 299 pairs with a device-resize extractor.
    ``snapshot_path`` makes the extraction resumable (extractor.run_resumable,
    bit-equal result); ``streaming`` accumulates the moments on the device."""
    if not os.path.exists(path):
        raise RuntimeError(f"Invalid path: {path}")
    if path.endswith(".npz"):
        return result_io.load_stats_npz(path)
    if extractor is None:
        raise ValueError("an extractor is needed for an image folder")
    loader = ImageFolderLoader.from_dir(path, batch_size, host_image_size, drop_last=legacy_compat)
    if loader.num_images() == 0:
        raise RuntimeError(f"No images found under: {path}")
    if snapshot_path:
        # drop_last truncation applied to the global list up front (the
        # resumable loader restarts mid-list)
        acts = run_resumable(
            build_extractor or (lambda: extractor),
            loader.files[: loader.num_images()],
            batch_size=batch_size,
            image_size=host_image_size,
            keys=("pool3",),
            snapshot_path=snapshot_path,
        )["pool3"]
    else:
        acts = extractor.run(loader, keys=("pool3",))["pool3"]
    if streaming:
        state = stats.init_moments(acts.shape[1], device=extractor.device)
        state = stats.update_moments(state, torch.from_numpy(acts).to(extractor.device))
        return stats.finalize_moments(state)
    return stats.exact_stats(acts)


def calculate_fid_given_paths(
    path1: str,
    path2: str,
    state_dict: Optional[Mapping[str, np.ndarray]],
    batch_size: int = 64,
    *,
    device=None,
    legacy_compat: bool = False,
    sqrtm_method: str = "scipy",
    device_resize_from: int = 0,
    fast: bool = False,
    snapshot_dir: str = "",
) -> float:
    device = resolve_device(device)
    extractor = build = None
    if not (path1.endswith(".npz") and path2.endswith(".npz")):
        build = lambda: make_pool3_extractor(  # noqa: E731
            state_dict, device, device_resize_from=device_resize_from, fast=fast)
        extractor = build()
    if snapshot_dir:
        os.makedirs(snapshot_dir, exist_ok=True)
    stats_of = []
    for i, path in enumerate((path1, path2), start=1):
        snap = os.path.join(snapshot_dir, f"fid_path{i}.snapshot.npz") if snapshot_dir else ""
        stats_of.append(compute_statistics_of_path(
            path, extractor, batch_size, legacy_compat=legacy_compat,
            host_image_size=device_resize_from or IMAGE_SIZE, snapshot_path=snap, build_extractor=build,
        ))
    (m1, s1), (m2, s2) = stats_of
    return sqrtm.frechet_distance(m1, s1, m2, s2, method=sqrtm_method, device=device)


def save_statistics(
    path: str,
    out_npz: str,
    state_dict: Mapping[str, np.ndarray],
    batch_size: int = 64,
    *,
    device=None,
    legacy_compat: bool = False,
    device_resize_from: int = 0,
    fast: bool = False,
) -> None:
    """Compute mu/sigma of an image folder and cache them in the reference's
    npz layout (fid_score.py:200-203); the npz then serves as
    --path1/--path2 of any later run."""
    extractor = make_pool3_extractor(state_dict, resolve_device(device), device_resize_from=device_resize_from, fast=fast)
    mu, sigma = compute_statistics_of_path(path, extractor, batch_size, legacy_compat=legacy_compat,
                                           host_image_size=device_resize_from or IMAGE_SIZE)
    result_io.save_stats_npz(out_npz, mu, sigma)


def load_weights(weights_path: Optional[str], what: str):
    """torchvision-layout state_dict from a .pth or a JAX-package .npz."""
    if weights_path is None:
        raise SystemExit(
            f"{what}: pass --weights pointing to a torchvision inception_v3 "
            "state_dict (.pth) or a converted .npz (see tise_tpu_torch/core/weights.py)."
        )
    return weights_io.load_inception_state_dict(weights_path)


def add_fid_flags(p: argparse.ArgumentParser, weights_help: str) -> None:
    """The reference's flag surface (fid_score.py:51-64) plus this package's
    additions, shared by FID and O-FID."""
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--dims", type=int, default=2048, choices=[2048])
    p.add_argument("-c", "--gpu", default="", type=str,
                   help="CUDA_VISIBLE_DEVICES for this run, as in the reference")
    p.add_argument("--path1", type=str, required=True)
    p.add_argument("--path2", type=str, default="")
    p.add_argument("--saved_file", type=str, default="")
    p.add_argument("--save_stats", type=str, default="",
                   help="write mu/sigma of --path1 to this npz instead of computing a distance")
    p.add_argument("--weights", type=str, default=None, help=weights_help)
    p.add_argument("--legacy-compat", action="store_true", help="reproduce drop_last tail discard")
    p.add_argument("--sqrtm", type=str, default="scipy", choices=["scipy", "eigh", "ns", "ns-pallas"])
    p.add_argument("--device-resize-from", type=int, default=0,
                   help="source image size; the resize to 299 happens on the device (fast path, ~PIL parity)")
    p.add_argument("--snapshot_dir", type=str, default="",
                   help="resumable extraction: rows+cursor snapshots under this dir; a killed "
                        "run resumes from them (bit-equal result; see extractor.run_resumable)")
    add_precision_flag(p)
    add_device_flag(p)
    add_distributed_flags(p)


def parse_fid_args(p: argparse.ArgumentParser, argv) -> argparse.Namespace:
    args = p.parse_args(argv)
    if args.gpu:
        os.environ["CUDA_VISIBLE_DEVICES"] = args.gpu  # before the first CUDA call
    configure_precision(args.precision)
    maybe_init_distributed(args)
    if not args.save_stats and not args.path2:
        p.error("--path2 is required (or pass --save_stats to cache statistics of --path1)")
    return args


def run_cli(args: argparse.Namespace, label: str, write_result, needs: str) -> Optional[float]:
    """The body shared by the FID and O-FID CLIs: cache statistics
    (``--save_stats``; returns None) or compute, write, print and return the
    distance."""
    device = resolve_device(args.device)
    fast = args.precision == "fast"
    if args.save_stats:
        save_statistics(args.path1, args.save_stats, load_weights(args.weights, needs), args.batch_size,
                        device=device, legacy_compat=args.legacy_compat,
                        device_resize_from=args.device_resize_from, fast=fast)
        print(f"stats: {args.save_stats}")
        return None
    state_dict = None
    if not (args.path1.endswith(".npz") and args.path2.endswith(".npz")):
        state_dict = load_weights(args.weights, needs)
    value = calculate_fid_given_paths(
        args.path1,
        args.path2,
        state_dict,
        args.batch_size,
        device=device,
        legacy_compat=args.legacy_compat,
        sqrtm_method=args.sqrtm,
        device_resize_from=args.device_resize_from,
        fast=fast,
        snapshot_dir=args.snapshot_dir,
    )
    if args.saved_file:
        write_result(args.saved_file, value)
    print(f"{label}: {value}")
    return value


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_fid_flags(p, "inception weights (.pth/.npz)")
    run_cli(parse_fid_args(p, argv), "FID", result_io.write_fid_result, "FID needs InceptionV3 weights")


if __name__ == "__main__":
    main()
