"""The port's IS* (CUB, COCO) and O-IS CLIs end to end against the JAX
package's on the CPU: the same folder of 12 blocky PNGs and the same weight
files (tests/tf_slim_ref.py's slim variables and tests/tf2015_ref.py's 2015
constants from numpy seeds, and a numpy-made 80-class torchvision-layout
state dict), read by both packages.  Each CLI configuration runs once per
package for the whole module, and the tests that read it share the run.
"""

import os
import re

import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from tests.tf2015_ref import random_2015_consts
from tests.tf_slim_ref import random_slim_vars
from tise_tpu.backbones import inception_v3 as jinception
from tise_tpu.core import io as jio
from tise_tpu.core import weights as jweights
from tise_tpu.metrics import is_star as jis_star
from tise_tpu.metrics import o_is as jo_is
from tise_tpu_torch.backbones.inception_v3 import random_state_dict
from tise_tpu_torch.core import io as tio
from tise_tpu_torch.metrics import is_star as tis_star
from tise_tpu_torch.metrics import o_is as to_is

_FLOAT = r"[-+0-9.eE]+"


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("is_cli")
    slim, g2015, w80 = str(root / "slim.npz"), str(root / "g2015.npz"), str(root / "w80.npz")
    np.savez(slim, **random_slim_vars(seed=0, num_classes=51))
    np.savez(g2015, **random_2015_consts(seed=0))
    jweights.save_pytree_npz(w80, jinception.params_from_torch_state_dict(random_state_dict(seed=2, num_classes=80), 80))
    rng = np.random.RandomState(7)
    folder = root / "images"
    folder.mkdir()
    for i in range(12):  # blocky images, so the class posteriors vary from image to image
        arr = np.kron(rng.randint(0, 256, (4, 4, 3)), np.ones((16, 16, 1))).astype(np.uint8)
        Image.fromarray(arr).save(str(folder / f"{i:03d}.png"))
    return {"root": root, "slim": slim, "g2015": g2015, "w80": w80, "images": str(folder)}


def _run_pair(files, tag, jmain, tmain, argv):
    """Both packages' CLI on ``argv``: {package: result file path}."""
    out = {}
    for name, main, more in (("jax", jmain, []), ("torch", tmain, ["--device", "cpu"])):
        out[name] = str(files["root"] / f"{tag}_{name}.txt")
        main([*argv, "--saved_file", out[name], *more])
    return out


def _text(paths):
    out = {}
    for name, path in paths.items():
        with open(path) as f:
            out[name] = f.read()
    return out


def _assert_results_agree(text, pattern, reader_paths):
    """The file has the reference's format; (mean, std) agree to 1e-4
    relative (std also within 1e-4 of the mean: it is a difference of
    scores); equal values give equal bytes."""
    assert re.fullmatch(pattern, text["torch"]), text["torch"]
    (jm, js), (tm, ts) = reader_paths
    assert np.isfinite(tm) and tm >= 1.0
    assert tm == pytest.approx(jm, rel=1e-4)
    assert abs(ts - js) <= 1e-4 * max(abs(js), jm)
    if (jm, js) == (tm, ts):
        assert text["torch"] == text["jax"]


@pytest.fixture(scope="module")
def cub_runs(files):
    """IS* CUB result files: both packages at batch 4 and 5 with --seed 1,
    and the port at batch 5 with --seed 2; {(package, batch, seed): path}."""
    runs = {}
    for bs, seed in (("4", "1"), ("5", "1"), ("5", "2")):
        argv = ["--image_folder", files["images"], "--flavor", "cub", "--weights", files["slim"],
                "--batch_size", bs, "--splits", "2", "--seed", seed]
        if seed == "1":
            pair = _run_pair(files, f"cub{bs}_seed{seed}", jis_star.main, tis_star.main, argv)
            runs.update({(name, bs, seed): path for name, path in pair.items()})
        else:
            runs["torch", bs, seed] = str(files["root"] / f"cub{bs}_seed{seed}_torch.txt")
            tis_star.main([*argv, "--saved_file", runs["torch", bs, seed], "--device", "cpu"])
    return runs


@pytest.fixture(scope="module")
def o_is_runs(files):
    """Both packages' O-IS result files at batch 5."""
    return _run_pair(files, "o_is", jo_is.main, to_is.main,
                     ["--image_dir", files["images"], "--weights", files["w80"], "--batch_size", "5"])


@pytest.mark.parametrize("bs", ["4", "5"])
def test_is_star_cub_cli_matches_jax(cub_runs, bs):
    """Seeded shuffle, tail drop (12 images at batch 4 and 5: 12 and 10 kept)
    and the slim backbone: same (mean, std) as the JAX CLI."""
    paths = {name: cub_runs[name, bs, "1"] for name in ("jax", "torch")}
    _assert_results_agree(_text(paths), rf"IS = {_FLOAT}  \+-  {_FLOAT}",
                          (jio.read_is_result(paths["jax"]), tio.read_is_result(paths["torch"])))


def test_is_star_cub_shuffle_seed_changes_the_kept_images(cub_runs):
    """At batch 5 two of the 12 shuffled images are dropped; which two depends
    on --seed, so the score does."""
    values = [tio.read_is_result(cub_runs["torch", "5", seed]) for seed in ("1", "2")]
    assert values[0] != values[1]


def test_is_star_coco_cli_matches_jax(files):
    """No shuffle, every image (12 at batch 5, the tail padded and masked)."""
    paths = _run_pair(files, "coco", jis_star.main, tis_star.main,
                      ["--image_folder", files["images"], "--flavor", "coco", "--weights", files["g2015"],
                       "--batch_size", "5", "--splits", "3"])
    _assert_results_agree(_text(paths), r"\[Inception Score\] mean: \d+\.\d{5} std: \d+\.\d{5}",
                          (jio.read_is_coco_result(paths["jax"]), tio.read_is_coco_result(paths["torch"])))


def test_o_is_cli_matches_jax(o_is_runs):
    _assert_results_agree(_text(o_is_runs), rf"O-IS: {_FLOAT} \+-  {_FLOAT}",
                          (jio.read_o_is_result(o_is_runs["jax"]), tio.read_o_is_result(o_is_runs["torch"])))


def test_snapshot_file_gives_the_same_result(files, o_is_runs):
    """--snapshot_file runs the resumable drain: the same bytes as the plain
    run of the same CLI, and the snapshot is gone when the run ends."""
    snap, snapshot = str(files["root"] / "o_is_snap.txt"), str(files["root"] / "o_is.snapshot.npz")
    to_is.main(["--image_dir", files["images"], "--weights", files["w80"], "--batch_size", "5", "--device", "cpu",
                "--saved_file", snap, "--snapshot_file", snapshot, "--precision", "fast"])
    with open(o_is_runs["torch"]) as f, open(snap) as g:
        assert f.read() == g.read()  # on the CPU "fast" (TF32 in the forward) changes nothing
    assert not os.path.exists(snapshot)


@pytest.mark.parametrize("main,argv", [
    (tis_star.main, ["--image_folder", "x", "--flavor", "coco", "--weights", "w.npz"]),
    (to_is.main, ["--image_dir", "x", "--weights", "w.npz"]),
])
def test_clis_raise_without_a_card_unless_asked_for_the_cpu(main, argv):
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(argv)


def test_empty_folder_raises(files, tmp_path):
    with pytest.raises(RuntimeError, match="No images found"):
        to_is.main(["--image_dir", str(tmp_path), "--weights", files["w80"], "--device", "cpu"])
    with pytest.raises(RuntimeError, match="No images found"):
        tis_star.main(["--image_folder", str(tmp_path), "--flavor", "coco", "--weights", files["g2015"], "--device", "cpu"])
