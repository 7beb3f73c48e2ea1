"""Data acquisition tooling (the port's own copy of
tise_tpu/core/download.py, which imports no JAX; reference layer L0:
download_scripts/, utils/).

The reference ships five gdown-based fetch scripts with an identical
fetch+unzip loop (download_scripts/download_pretrained_models.py:19-45 et
al.) plus a raw Google-Drive downloader
(utils/download_from_google_drive.py:6-34).  This module reimplements that
surface without the gdown dependency: a confirm-token-aware Drive HTTP
fetcher, skip-if-exists resume, and in-place unzip.  All manifests from the
reference README are registered so one command fetches a bundle:

    python -m tise_tpu_torch.core.download --bundle evaluation_data --dest data/

(Requires network egress and the ``requests`` package, imported only when a
file is fetched; in air-gapped environments place the files manually at the
documented paths.)
"""
from __future__ import annotations

import argparse
import os
import tarfile
import zipfile
from typing import Dict, Optional, Tuple

CHUNK = 32768

#: bundle -> {relative dest path: google drive file id or http(s) URL}.
#: Ids mirror the reference's download_scripts/*.py manifests exactly (they
#: are Drive-hosted data artifacts, not code); dest paths define the on-disk
#: layout the metric CLIs expect.  Sources: download_evaluation_data.py:6-16,
#: download_pretrained_models.py:6-17, download_cub_data.py:6-9,
#: download_ms_coco_metadata.py:6-8, download_data_for_calibration_optional.py:6-11,
#: download_ms_coco_images.sh.
BUNDLES: Dict[str, Dict[str, str]] = {
    "evaluation_data": {
        "image_realism/captions/cub_image_realism_captions.pkl": "1CiVX30GYstnDTeIALzcmIiZwEOB_8GmV",
        "text_relevance/captions/CUB_RP_captions.pkl": "1rgviKILsxaZC7geYAzQG_LtNs9ZiTK4n",
        "counting_alignment/captions/CA_input_captions.pkl": "102oFdZSLLeYVuMDH4yDdta8ZqTGyCw9F",
        "image_realism/captions/coco_image_realism_captions.pkl": "1dlJio9C1ALkq8HeSpv4eN5qKkouCSsWj",
        "image_realism/FID/data.zip": "1b-xxEHQDFqzYVKanmHJNRgRuxOAQ0k-D",
        "object_fidelity/O-FID/data.zip": "18dbKvDADfs1psx3JtVylDE7NR0YAZzz5",
        "positional_alignment/captions/PA_input_captions.pkl": "1GIvnWUblvKtyb2KSngSbYeTE8qtxwyZi",
        "semantic_object_accuracy/captions.zip": "17GHoILW9KTwhh2aFbCNcC4zg1RPXAFnk",
        "text_relevance/captions/COCO_RP_captions.pkl": "1bZvXauK5443dFnVeFL8bIdxG8IyaZiXY",
    },
    "pretrained_models": {
        "text_to_images_models/DAMSMencoders/bird.zip": "1n3bDJ6uXZMtbgMtKSYJ3uExo11lrgaNW",
        "text_to_images_models/pretrained_models/cub_attn_gan_plus_plus_released.pth": "1pPtNww0Ift1v118cvYe6Fht-y2yal1tR",
        "text_to_images_models/pretrained_models/cub_counter_model.pth": "1PHTLhItcxyGJ4hFzMCdo76QcCQwAW2BP",
        "text_to_images_models/DAMSMencoders/coco.zip": "1kXB7HgKdEk-u25MFS2roB9GDnYAiyXg5",
        "text_to_images_models/pretrained_models/coco_attn_gan_plus_plus_released.pth": "1KSRyPL5S9_I9tGxDTBLNUHPuXzZ55TCR",
        "image_realism/IS/bird/inception_finetuned_models.zip": "1N2NI6BZW_bKz96CvWTNKU8SAeKuAEtis",
        "counting_alignment/weights.zip": "1W7hXzD3KsmoKJQzlBBhWTN3-sW--njqG",
        "object_fidelity/weights.zip": "1h5mdtCtf9ADqfSAfiqyppYGqipYRvvRg",
        "semantic_object_accuracy/weights.zip": "1XzyEOnta_1u4oJ6ebBdEGTK5-hwjxwv7",
    },
    "cub_data": {
        "text_to_images_models/data/bird.zip": "1dZFKKGiEHU5mZV7hbTQmwS4MnhxM3vWG",
        "text_to_images_models/data/birds/CUB_200_2011.tgz": "1hbzc_P1FuxMkcabkgn9ZKinBwW683j45",
    },
    "ms_coco_metadata": {
        "text_to_images_models/data/coco.zip": "1sbjzc1pTuWLG8AdXJATwgwC08VABEs2K",
    },
    "ms_coco_images": {
        "text_to_images_models/data/coco/train2014.zip": "http://images.cocodataset.org/zips/train2014.zip",
        "text_to_images_models/data/coco/val2014.zip": "http://images.cocodataset.org/zips/val2014.zip",
    },
    "calibration_data": {
        "classifier_calibration/data/coco_object_validation_feature_data.npz": "1btKm82ImFYa63lM88pcGxdla6inuaYbB",
        "classifier_calibration/data/cub_validation_feature_data.npz": "1PAQl2K4Ul33jFiHisQL_Iub3DGug2wnk",
        "classifier_calibration/data/image_net_validation_feature_data.npz": "1fY-84uIbD2--j_bRd0pjhupPPW2oD4Qx",
        "classifier_calibration/data/tf_image_net_validation_feature_data.npz": "1MaCE-UmUV1XsRRj3A71mE-pc2Q0huHLT",
    },
}


def download_from_google_drive(file_id: str, dest: str) -> str:
    """Drive download with the large-file confirm-token dance
    (utils/download_from_google_drive.py:6-34 semantics)."""
    import requests

    url = "https://docs.google.com/uc?export=download"
    session = requests.Session()
    resp = session.get(url, params={"id": file_id}, stream=True)
    token: Optional[str] = None
    for key, val in resp.cookies.items():
        if key.startswith("download_warning"):
            token = val
    if token:
        resp = session.get(url, params={"id": file_id, "confirm": token}, stream=True)
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    with open(dest, "wb") as f:
        for chunk in resp.iter_content(CHUNK):
            if chunk:
                f.write(chunk)
    return dest


def download_http(url: str, dest: str) -> str:
    """Plain HTTP fetch (the reference uses wget for the COCO image zips,
    download_ms_coco_images.sh)."""
    import requests

    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    with requests.get(url, stream=True) as resp:
        resp.raise_for_status()
        with open(dest, "wb") as f:
            for chunk in resp.iter_content(CHUNK):
                if chunk:
                    f.write(chunk)
    return dest


def fetch_and_unzip(src: str, dest: str, *, skip_existing: bool = True) -> str:
    """Reference loop: skip existing, download (Drive id or http(s) URL),
    extract .zip/.tgz in place (download_pretrained_models.py:19-45)."""
    if skip_existing and os.path.isfile(dest):
        print(f"{dest} exists; skipping")
        return dest
    if src.startswith(("http://", "https://")):
        download_http(src, dest)
    else:
        download_from_google_drive(src, dest)
    base = os.path.dirname(dest) or "."
    if dest.endswith(".zip"):
        with zipfile.ZipFile(dest) as z:
            z.extractall(base)
    elif dest.endswith(".tgz"):
        with tarfile.open(dest, "r") as t:
            t.extractall(base)
    return dest


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--bundle", choices=sorted(BUNDLES), default=None)
    p.add_argument("--file_id", type=str, default=None, help="raw Drive file id")
    p.add_argument("--dest", type=str, default=".", help="destination root directory")
    p.add_argument("--list", action="store_true", help="print bundle manifests and exit")
    args = p.parse_args(argv)

    if args.list:
        for bundle in sorted(BUNDLES) if not args.bundle else [args.bundle]:
            print(f"{bundle}:")
            for name, src in BUNDLES[bundle].items():
                print(f"  {name}  <-  {src}")
        return
    if args.file_id:
        # --dest may be a directory (notably the '.' default): the raw id
        # needs a real file path or fetch_and_unzip would see the existing
        # directory and silently skip the download
        dest = args.dest
        if os.path.isdir(dest):
            dest = os.path.join(dest, args.file_id)
        fetch_and_unzip(args.file_id, dest)
        return
    if not args.bundle:
        p.error("pass --bundle, --file_id, or --list")
    for name, src in BUNDLES[args.bundle].items():
        fetch_and_unzip(src, os.path.join(args.dest, name))


if __name__ == "__main__":
    main()
