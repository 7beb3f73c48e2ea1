"""The port's FID slice (tise_tpu_torch.metrics) against the JAX package's on
the CPU: the same folders, the same weights npz, the same flags.

Two folders of 12 64x64 PNGs (resized to 299 by PIL on the host, as in the
reference) and one npz of planted, well-conditioned weights made by numpy
(tise_tpu_torch.backbones.inception_v3.random_state_dict) in the JAX
package's pytree layout.  The extractor's batching, padding, legacy drop and
snapshot semantics are also checked with a cheap stand-in forward, which
keeps this file well inside the tier-1 time budget.  The same CLIs under
``--precision fast`` are in tests/test_torch_fid_fast.py.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from tise_tpu.backbones import inception_v3 as jinception
from tise_tpu.core import weights as jweights
from tise_tpu.core.data import ImageFolderLoader as JaxImageFolderLoader
from tise_tpu.metrics import fid as jfid
from tise_tpu.metrics import o_fid as jo_fid
from tise_tpu_torch.backbones.inception_v3 import random_state_dict
from tise_tpu_torch.core import io as result_io
from tise_tpu_torch.core.data import ImageFolderLoader, list_images, load_image
from tise_tpu_torch.metrics import extractor as textractor
from tise_tpu_torch.metrics import fid as tfid
from tise_tpu_torch.metrics import o_fid as to_fid
from tise_tpu_torch.ops import stats
from tise_tpu_torch.ops.preprocess import RECIPES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


def _write_folder(root, n, seed, block):
    """n blocky RGB images: random colours on a grid of block x block pixel
    cells, so whole-image features vary from image to image (i.i.d. pixel
    noise would average out at pool3 and leave a near-zero covariance)."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    cells = 64 // block
    for i in range(n):
        arr = np.kron(rng.randint(0, 256, (cells, cells, 3)), np.ones((block, block, 1))).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(root, f"{i:03d}.png"))
    return str(root)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("fid")
    weights = str(root / "planted.npz")
    params = jinception.params_from_torch_state_dict(random_state_dict(seed=0, num_classes=10), num_classes=10)
    jweights.save_pytree_npz(weights, params)
    return {
        "root": root,
        "a": _write_folder(root / "a", 12, seed=1, block=16),
        "b": _write_folder(root / "b", 12, seed=2, block=4),
        "weights": weights,
    }


@pytest.fixture(scope="module")
def cli_runs(world):
    """Each package's FID CLI and --save_stats on the same inputs, once."""
    root, out = world["root"], {}
    for name, main, device in (("jax", jfid.main, []), ("torch", tfid.main, ["--device", "cpu"])):
        saved = str(root / f"fid_{name}.txt")
        main(["--path1", world["a"], "--path2", world["b"], "--weights", world["weights"],
              "--sqrtm", "eigh", "--batch-size", "4", "--saved_file", saved, *device])
        stats_npz = str(root / f"stats_a_{name}.npz")
        main(["--path1", world["a"], "--save_stats", stats_npz, "--weights", world["weights"],
              "--batch-size", "4", *device])
        out[name] = {"saved": saved, "stats": stats_npz}
    return out


def test_fid_cli_matches_jax(cli_runs):
    """|dFID| <= max(1e-3, 1e-4 |FID|) between the two CLIs."""
    ref = result_io.read_fid_result(cli_runs["jax"]["saved"])
    got = result_io.read_fid_result(cli_runs["torch"]["saved"])
    assert np.isfinite(got) and got > 0.0
    assert abs(got - ref) <= max(1e-3, 1e-4 * abs(ref)), (got, ref)


def test_result_file_format(cli_runs):
    with open(cli_runs["torch"]["saved"]) as f:
        text = f.read()
    assert re.fullmatch(r"FID: [-+0-9.eE]+", text)
    assert float(text.split(": ")[1]) == result_io.read_fid_result(cli_runs["torch"]["saved"])


def test_save_stats_match_jax(cli_runs):
    """--save_stats mu and sigma agree with the JAX package's.  mu within
    1e-4 of its scale.  pool3 features here vary little from image to image
    next to their size (std ~1e-2 of the mean), so sigma is held to what
    features agreeing to eps = 1e-5 of their scale allow:
    |d sigma| <= 2 eps max|mu| sqrt(max diag sigma)."""
    mu, sigma = result_io.load_stats_npz(cli_runs["torch"]["stats"])
    ref_mu, ref_sigma = result_io.load_stats_npz(cli_runs["jax"]["stats"])
    assert mu.shape == (2048,) and sigma.shape == (2048, 2048)
    np.testing.assert_allclose(mu, ref_mu, rtol=1e-4, atol=1e-4 * np.abs(ref_mu).max())
    bound = 2 * 1e-5 * np.abs(ref_mu).max() * np.sqrt(np.diag(ref_sigma).max())
    np.testing.assert_allclose(sigma, ref_sigma, rtol=0, atol=bound)


def test_npz_paths_and_o_fid_match_jax(world, cli_runs):
    """Two cached npz give a distance with no extraction; O-FID writes its
    own label, and both packages agree on the float64 host path to 1e-8."""
    npz_t, npz_j = cli_runs["torch"]["stats"], cli_runs["jax"]["stats"]
    saved_t, saved_j = str(world["root"] / "ofid_t.txt"), str(world["root"] / "ofid_j.txt")
    to_fid.main(["--path1", npz_t, "--path2", npz_j, "--sqrtm", "eigh", "--saved_file", saved_t, "--device", "cpu"])
    jo_fid.main(["--path1", npz_t, "--path2", npz_j, "--sqrtm", "eigh", "--saved_file", saved_j])
    with open(saved_t) as f:
        text = f.read()
    assert text.startswith("O-FID: ")
    got, ref = result_io.read_fid_result(saved_t), result_io.read_fid_result(saved_j)
    assert abs(got - ref) <= 1e-8 * max(1.0, abs(ref))


@pytest.mark.parametrize("main", [tfid.main, to_fid.main])
def test_cli_without_device_raises_where_there_is_no_card(world, main):
    """The CLIs run on the card unless told otherwise: with no --device and
    no CUDA device they raise and name --device cpu; no silent CPU run."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--path1", world["a"], "--path2", world["b"], "--weights", world["weights"]])
    with pytest.raises(RuntimeError, match="--device cpu"):
        tfid.calculate_fid_given_paths(world["a"], world["b"], None)


@pytest.mark.parametrize("value", [0.0, 12.345678901234567, 1e-9, 31.5])
def test_result_files_byte_identical_to_jax(tmp_path, value):
    """FID and O-FID result files: the same bytes as the JAX package's
    writers, read back to the same float by both readers."""
    from tise_tpu.core import io as jio

    pairs = (
        (jio.write_fid_result, result_io.write_fid_result),
        (lambda p, v: jio._write(p, f"O-FID: {v}"), result_io.write_o_fid_result),  # jax o_fid.py:80
    )
    for i, (jwrite, twrite) in enumerate(pairs):
        jpath, tpath = str(tmp_path / f"j{i}.txt"), str(tmp_path / f"t{i}.txt")
        jwrite(jpath, value)
        twrite(tpath, value)
        with open(jpath, "rb") as fj, open(tpath, "rb") as ft:
            assert fj.read() == ft.read()
        assert result_io.read_fid_result(tpath) == jio.read_fid_result(jpath) == value


def test_stats_npz_crosses_between_packages(tmp_path):
    """A stats npz written by either package loads in the other unchanged."""
    from tise_tpu.core import io as jio

    rng = np.random.RandomState(8)
    mu, sigma = rng.randn(6), rng.randn(6, 6)
    result_io.save_stats_npz(str(tmp_path / "t.npz"), mu, sigma)
    jio.save_stats_npz(str(tmp_path / "j.npz"), mu, sigma)
    for got in (jio.load_stats_npz(str(tmp_path / "t.npz")), result_io.load_stats_npz(str(tmp_path / "j.npz"))):
        np.testing.assert_array_equal(got[0], mu)
        np.testing.assert_array_equal(got[1], sigma)


def test_pth_weights_load_as_in_jax(tmp_path):
    """A torchvision .pth loads as is; carried into the JAX layout by the
    JAX loader and back by state_dict_from_jax_params, it is unchanged."""
    from tise_tpu_torch.core import weights as tweights

    sd = random_state_dict(seed=4, num_classes=6)
    path = str(tmp_path / "w.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    got = tweights.load_inception_state_dict(path)
    back = tweights.state_dict_from_jax_params(jweights.load_inception_params(path, num_classes=6))
    assert set(got) == set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_loader_matches_jax_loader(world):
    """Sorted walk, PIL resize and pad-and-mask batches equal the JAX
    package's byte for byte."""
    files = list_images(world["a"])
    ours = list(ImageFolderLoader(files, 5, 299))
    ref = list(JaxImageFolderLoader(files, 5, 299))
    assert len(ours) == len(ref) == 3
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.images, r.images)
        np.testing.assert_array_equal(o.mask, r.mask)
        assert list(o.paths) == list(r.paths)


def _cheap_extractor(calls=None, fail_at=None):
    """A stand-in forward: per-image channel means of the normalized batch."""

    def apply_fn(x):
        if calls is not None:
            calls.append(x.shape[0])
            if fail_at is not None and len(calls) == fail_at:
                raise RuntimeError("injected failure")
        return {"pool3": x.mean(dim=(1, 2)), "other": x[:, 0, 0, :]}

    return textractor.BatchedExtractor(apply_fn, recipe="fid", device="cpu")


def test_legacy_compat_drops_tail_rows(world):
    """--legacy-compat keeps only whole batches: 12 images at batch 5 -> 10 rows."""
    ex = _cheap_extractor()
    mu, sigma = tfid.compute_statistics_of_path(world["a"], ex, 5, legacy_compat=True)
    files = list_images(world["a"])
    assert JaxImageFolderLoader(files, 5, 299, drop_last=True).num_images() == 10
    imgs = np.stack([load_image(f, (299, 299)) for f in files[:10]]).astype(np.float32)
    scale, shift = (np.asarray(v, np.float32) for v in RECIPES["fid"])
    rows = (imgs * scale + shift).mean(axis=(1, 2), dtype=np.float64)
    ref_mu, ref_sigma = stats.exact_stats(rows)
    # f32 means over 299x299 pixels, summed in another order than numpy's
    np.testing.assert_allclose(mu, ref_mu, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(sigma, ref_sigma, rtol=1e-3, atol=1e-7)
    mu_all, _ = tfid.compute_statistics_of_path(world["a"], ex, 5)
    assert not np.allclose(mu_all, mu)


def test_run_drops_padding_and_filters_keys(world):
    ex = _cheap_extractor()
    out = ex.run(ImageFolderLoader(list_images(world["a"]), 5, 32), keys=("pool3",))
    assert set(out) == {"pool3"} and out["pool3"].shape == (12, 3)


def test_streaming_matches_exact(world):
    ex = _cheap_extractor()
    mu_s, sigma_s = tfid.compute_statistics_of_path(world["b"], ex, 4, streaming=True)
    mu_e, sigma_e = tfid.compute_statistics_of_path(world["b"], ex, 4)
    np.testing.assert_allclose(mu_s, mu_e, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sigma_s, sigma_e, rtol=1e-3, atol=1e-6)


def test_run_resumable_snapshot_and_resume_bit_equal(world, tmp_path):
    """A run that fails after its first snapshot leaves it; the rerun resumes
    from the cursor, processes only the rest, and gives the straight run's
    rows bit for bit; a finished run deletes the snapshot."""
    files = list_images(world["a"])
    straight = _cheap_extractor().run(ImageFolderLoader(files, 2, 64))
    snap = str(tmp_path / "x.snapshot.npz")
    kw = dict(batch_size=2, image_size=64, snapshot_path=snap, snapshot_every=4)

    calls = []
    with pytest.raises(RuntimeError, match="injected"):
        textractor.run_resumable(lambda: _cheap_extractor(calls, fail_at=5), files, **kw)
    assert os.path.exists(snap)
    with np.load(snap) as z:
        cursor = int(z["cursor"])
    assert cursor == 6

    calls2 = []
    resumed = textractor.run_resumable(lambda: _cheap_extractor(calls2), files, **kw)
    assert sum(calls2) == 2 * (len(files) - cursor) // 2 and len(calls2) == (len(files) - cursor) // 2
    assert not os.path.exists(snap)
    assert set(resumed) == set(straight)
    for k in straight:
        np.testing.assert_array_equal(resumed[k], straight[k])


def test_stale_snapshot_is_ignored(world, tmp_path):
    files = list_images(world["a"])
    snap = str(tmp_path / "s.snapshot.npz")
    textractor._save_snapshot(snap, "not-this-run", {"pool3": [np.zeros((4, 3), np.float32)]}, 4)
    out = textractor.run_resumable(lambda: _cheap_extractor(), files, batch_size=4, image_size=32,
                                   snapshot_path=snap, keys=("pool3",))
    assert out["pool3"].shape == (12, 3) and not os.path.exists(snap)


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports anything of jax,
    flax or tise_tpu, nor pandas or tabulate (the port uses neither), nor
    matplotlib or requests (imported only by the calls that need them):
    every module under tise_tpu_torch/ is imported in a
    fresh interpreter (tools included), and chip_smoke.py is loaded as a
    module without running it."""
    code = (
        "import importlib, importlib.util, pkgutil, sys, tise_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(tise_tpu_torch.__path__, 'tise_tpu_torch.')]\n"
        "for required in ('metrics.fid', 'metrics.o_fid', 'metrics.is_star', 'metrics.o_is', 'ops.kl',\n"
        "                 'backbones.inception_fast', 'backbones.inception_slim',\n"
        "                 'metrics.rp_coco', 'metrics.pa', 'metrics.clip_scorer',\n"
        "                 'backbones.clip_vit', 'backbones.clip_fast', 'backbones.clip_tokenizer',\n"
        "                 'tools.mosaic_probe', 'tools.stem_mm_probe',\n"
        "                 'backbones.damsm', 'metrics.rp_cub', 'benchmark',\n"
        "                 'backbones.detection.coco_classes', 'backbones.detection.ops',\n"
        "                 'backbones.detection.resnet_fpn', 'backbones.detection.rcnn',\n"
        "                 'backbones.detection.weights', 'backbones.detection.predictor',\n"
        "                 'metrics.crop_objects', 'metrics.soa',\n"
        "                 'backbones.counter', 'metrics.ca', 'ranking.ranking_score',\n"
        "                 'models.attngan_pp.layers', 'models.attngan_pp.attention',\n"
        "                 'models.attngan_pp.generator', 'models.counter_model.generator',\n"
        "                 'models.weights', 'models.visualize', 'models.generate', 'models.gen_example',\n"
        "                 'models.gen_bench', 'calibration.temperature', 'calibration.plots',\n"
        "                 'calibration.cli', 'core.download',\n"
        "                 'models.attngan_pp.discriminator', 'models.attngan_pp.losses',\n"
        "                 'models.attngan_pp.trainer', 'models.attngan_pp.train_loop', 'models.datasets',\n"
        "                 'models.main', 'models.sampling', 'models.damsm_pretrain',\n"
        "                 'models.counter_model.discriminator', 'models.counter_model.trainer',\n"
        "                 'parallel', 'parallel.multihost'):\n"
        "    assert 'tise_tpu_torch.' + required in names, required\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "banned = ('jax', 'jaxlib', 'flax', 'tise_tpu', 'pandas', 'tabulate', 'matplotlib', 'requests')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in banned]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


def test_extractor_uses_the_given_device():
    ex = _cheap_extractor()
    out = ex(np.zeros((2, 8, 8, 3), np.uint8))
    assert out["pool3"].device == torch.device("cpu") and out["pool3"].shape == (2, 3)
