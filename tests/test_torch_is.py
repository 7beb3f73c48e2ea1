"""The port's IS* (CUB, COCO) and O-IS slice against the JAX package's on the
CPU: ops.kl, the slim / 2015-GraphDef name maps, the logits extractors and the
three CLIs end to end.

Weights are the random slim variables and 2015 constants of
tests/tf_slim_ref.py and tests/tf2015_ref.py (numpy seeds) saved as npz, and a
numpy-made 80-class torchvision-layout state dict; both packages read the same
files.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.tf2015_ref import random_2015_consts
from tests.tf_slim_ref import random_slim_vars
from tise_tpu.backbones import inception_slim as jslim
from tise_tpu.backbones import inception_v3 as jinception
from tise_tpu.core import io as jio
from tise_tpu.core import weights as jweights
from tise_tpu.metrics import is_star as jis_star
from tise_tpu.metrics import o_is as jo_is
from tise_tpu.ops import kl as jkl
from tise_tpu_torch.backbones import inception_slim as tslim
from tise_tpu_torch.backbones.inception_v3 import random_state_dict
from tise_tpu_torch.core import config as tconfig
from tise_tpu_torch.core import io as tio
from tise_tpu_torch.core import weights as tweights
from tise_tpu_torch.metrics import is_star as tis_star
from tise_tpu_torch.metrics import o_is as to_is
from tise_tpu_torch.ops import kl as tkl

TEMPERATURES = (tconfig.IS_STAR_TEMPERATURE_CUB, tconfig.IS_STAR_TEMPERATURE_COCO, tconfig.O_IS_TEMPERATURE)


# -- ops/kl -------------------------------------------------------------------


@pytest.mark.parametrize("temperature", TEMPERATURES)
def test_temperature_softmax_matches_jax(temperature):
    """f32 softmax(logits / T) within 1e-6 (another library's exp and sum)."""
    logits = np.random.RandomState(0).randn(37, 50).astype(np.float32) * 3.0
    ref = np.asarray(jkl.temperature_softmax(jnp.asarray(logits), temperature))
    got = tkl.temperature_softmax(torch.from_numpy(logits), temperature)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,splits", [(40, 10), (37, 10), (9, 2)])
def test_split_scores_match_jax_in_f64(n, splits):
    """The host float64 split KL: the same numpy arithmetic, 1e-12."""
    rng = np.random.RandomState(1)
    p = rng.dirichlet(np.ones(20), size=n)
    np.testing.assert_allclose(tkl.split_kl_scores(p, splits), jkl.split_kl_scores(p, splits), rtol=1e-12, atol=0)
    assert tkl.inception_score(p, splits) == pytest.approx(jkl.inception_score(p, splits), rel=1e-12)


@pytest.mark.parametrize("shuffle_seed", [None, 3])
def test_inception_score_from_logits_matches_jax(shuffle_seed):
    """Logits to (mean, std) within 1e-6 relative (the f32 softmax's)."""
    logits = np.random.RandomState(2).randn(64, 30).astype(np.float32) * 2.0
    ref = jkl.inception_score_from_logits(logits, 0.9, 4, shuffle_seed)
    got = tkl.inception_score_from_logits(logits, 0.9, 4, shuffle_seed, device="cpu")
    assert got == pytest.approx(ref, rel=1e-6)


def test_inception_score_from_logits_raises_without_a_card():
    with pytest.raises(RuntimeError, match="--device cpu"):
        tkl.inception_score_from_logits(np.zeros((4, 3), np.float32), 1.0, 2)


# -- name maps and the weight carrier ----------------------------------------


def _assert_same_state(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("prefixed", [False, True])
def test_slim_name_map_matches_jax(prefixed):
    """Every tensor of the slim map equals the JAX map's carried across by
    state_dict_from_jax_params (HWIO -> OIHW, fc transposed, gamma = 1 where
    the checkpoint has none, a stored gamma kept)."""
    flat = random_slim_vars(seed=0, num_classes=51)
    flat["conv0/BatchNorm/gamma"] = np.full((32,), 1.5, np.float32)
    if prefixed:
        flat = {f"inception_v3/{k}": v for k, v in flat.items()}
    ref = tweights.state_dict_from_jax_params(jslim.params_from_slim_vars(flat, 51))
    got = tslim.params_from_slim_vars(flat, 51)
    _assert_same_state(got, ref)
    assert got["fc.weight"].shape == (51, 2048) and got["Conv2d_1a_3x3.conv.weight"].shape == (32, 3, 3, 3)
    np.testing.assert_array_equal(got["Conv2d_1a_3x3.bn.weight"], 1.5)
    np.testing.assert_array_equal(got["Conv2d_2a_3x3.bn.weight"], 1.0)


def test_slim_map_without_logits():
    flat = {k: v for k, v in random_slim_vars(seed=1).items() if not k.startswith("logits/")}
    with pytest.raises(KeyError):
        tslim.params_from_slim_vars(flat, 51)
    got = tslim.params_from_slim_vars(flat, 0)
    _assert_same_state(got, tweights.state_dict_from_jax_params(jslim.params_from_slim_vars(flat, 0)))
    assert "fc.weight" not in got


def test_2015_name_map_matches_jax():
    flat = random_2015_consts(seed=0)
    assert tslim.is_2015_layout(flat) and jslim.is_2015_layout(flat)
    assert not tslim.is_2015_layout(random_slim_vars(seed=0))
    ref = tweights.state_dict_from_jax_params(jslim.params_from_2015_vars(flat))
    _assert_same_state(tslim.params_from_2015_vars(flat), ref)


def test_2015_expected_and_missing_names_match_jax():
    assert tslim.expected_2015_names() == jslim.expected_2015_names()
    flat = random_2015_consts(seed=0)
    assert tslim.missing_2015_names(flat) == []
    for k in ("mixed_10/tower_2/conv/batchnorm/beta", "conv_3/conv2d_params", "mixed_8/tower_1/conv_3/batchnorm/moving_mean"):
        del flat[k]
    assert tslim.missing_2015_names(flat) == jslim.missing_2015_names(flat) != []


def test_carrier_takes_the_80_class_tree(tmp_path):
    """load_inception_params(num_classes=80) of a .pth -> the JAX tree ->
    state_dict_from_jax_params gives the .pth back; the npz the JAX package
    saves from it loads in the port to the same."""
    sd = random_state_dict(seed=5, num_classes=80)
    pth = str(tmp_path / "w80.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    tree = jweights.load_inception_params(pth, num_classes=80)
    _assert_same_state(tweights.state_dict_from_jax_params(tree), sd)
    npz = str(tmp_path / "w80.npz")
    jweights.save_pytree_npz(npz, tree)
    _assert_same_state(tweights.load_inception_state_dict(npz), sd)


# -- logits --------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("is")
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


def _assert_logits_close(got, ref):
    """rtol 1e-4, atol 1e-4 of the logits' scale: the f32 trunks' tolerance."""
    got, ref = got.numpy(), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * max(np.abs(ref).max(), 1e-3))


@pytest.mark.parametrize("flavor,width", [("cub", 50), ("coco", 1008)])
def test_is_star_logits_match_jax(files, flavor, width):
    """CUB: 51-way fc, class 0 sliced off, tf pools, v/127.5 - 1.  COCO:
    pool3 @ softmax/weights, no bias, tf2015 pools, (v - 128)/128."""
    u8 = np.random.RandomState(3).randint(0, 256, (8, 75, 75, 3)).astype(np.uint8)
    path = files["slim"] if flavor == "cub" else files["g2015"]
    ref = jslim.make_logits_extractor(path, flavor)(u8)["logits"]
    ex = tslim.make_logits_extractor(path, flavor, "cpu")
    assert ex.recipe == ("is_star" if flavor == "cub" else "is_star_2015")
    got = ex(u8)["logits"]
    assert got.shape == (8, width)
    _assert_logits_close(got, ref)


def test_coco_extractor_takes_slim_style_names(files, tmp_path):
    flat = {k: v for k, v in random_slim_vars(seed=4).items() if not k.startswith("logits/")}
    flat["softmax/weights"] = random_2015_consts(seed=0)["softmax/weights"]
    path = str(tmp_path / "slim_style.npz")
    np.savez(path, **flat)
    u8 = np.random.RandomState(5).randint(0, 256, (8, 75, 75, 3)).astype(np.uint8)
    _assert_logits_close(tslim.make_logits_extractor(path, "coco", "cpu")(u8)["logits"],
                         jslim.make_logits_extractor(path, "coco")(u8)["logits"])


def test_unknown_flavor_raises(files):
    with pytest.raises(ValueError):
        tslim.make_logits_extractor(files["slim"], "imagenet", "cpu")


def test_o_is_logits_match_jax(files):
    u8 = np.random.RandomState(6).randint(0, 256, (8, 75, 75, 3)).astype(np.uint8)
    ref = jo_is.make_logits_extractor(jweights.load_inception_params(files["w80"], num_classes=80))(u8)["logits"]
    ex = to_is.make_logits_extractor(tweights.load_inception_state_dict(files["w80"]), "cpu")
    assert ex.recipe == "half"
    got = ex(u8)["logits"]
    assert got.shape == (8, 80)
    _assert_logits_close(got, ref)


# -- the CLIs end to end --------------------------------------------------------


def _run_pair(files, tag, jmain, tmain, argv):
    out = {}
    for name, main, more in (("jax", jmain, []), ("torch", tmain, ["--device", "cpu"])):
        saved = str(files["root"] / f"{tag}_{name}.txt")
        main([*argv, "--saved_file", saved, *more])
        with open(saved) as f:
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


_FLOAT = r"[-+0-9.eE]+"


def test_is_star_cub_cli_matches_jax(files):
    """Seeded shuffle, tail drop (12 images at batch 4 and 5: 12 and 10 kept)
    and the slim backbone: same (mean, std) as the JAX CLI."""
    for bs in ("4", "5"):
        text = _run_pair(files, f"cub{bs}", jis_star.main, tis_star.main,
                         ["--image_folder", files["images"], "--flavor", "cub", "--weights", files["slim"],
                          "--batch_size", bs, "--splits", "2", "--seed", "1"])
        paths = [str(files["root"] / f"cub{bs}_{n}.txt") for n in ("jax", "torch")]
        _assert_results_agree(text, rf"IS = {_FLOAT}  \+-  {_FLOAT}",
                              (jio.read_is_result(paths[0]), tio.read_is_result(paths[1])))


def test_is_star_cub_shuffle_seed_changes_the_kept_images(files):
    """At batch 5 two of the 12 shuffled images are dropped; which two depends
    on --seed, so the score does."""
    values = []
    for seed in ("1", "2"):
        saved = str(files["root"] / f"cub_seed{seed}.txt")
        tis_star.main(["--image_folder", files["images"], "--flavor", "cub", "--weights", files["slim"],
                       "--batch_size", "5", "--splits", "2", "--seed", seed, "--saved_file", saved, "--device", "cpu"])
        values.append(tio.read_is_result(saved))
    assert values[0] != values[1]


def test_is_star_coco_cli_matches_jax(files):
    """No shuffle, every image (12 at batch 5, the tail padded and masked)."""
    text = _run_pair(files, "coco", jis_star.main, tis_star.main,
                     ["--image_folder", files["images"], "--flavor", "coco", "--weights", files["g2015"],
                      "--batch_size", "5", "--splits", "3"])
    paths = [str(files["root"] / f"coco_{n}.txt") for n in ("jax", "torch")]
    _assert_results_agree(text, r"\[Inception Score\] mean: \d+\.\d{5} std: \d+\.\d{5}",
                          (jio.read_is_coco_result(paths[0]), tio.read_is_coco_result(paths[1])))


def test_o_is_cli_matches_jax(files):
    text = _run_pair(files, "o_is", jo_is.main, to_is.main,
                     ["--image_dir", files["images"], "--weights", files["w80"], "--batch_size", "5"])
    paths = [str(files["root"] / f"o_is_{n}.txt") for n in ("jax", "torch")]
    _assert_results_agree(text, rf"O-IS: {_FLOAT} \+-  {_FLOAT}",
                          (jio.read_o_is_result(paths[0]), tio.read_o_is_result(paths[1])))


def test_snapshot_file_gives_the_same_result(files):
    """--snapshot_file runs the resumable drain: the same bytes, and the
    snapshot is gone when the run ends."""
    plain, snap = str(files["root"] / "o_is_plain.txt"), str(files["root"] / "o_is_snap.txt")
    snapshot = str(files["root"] / "o_is.snapshot.npz")
    argv = ["--image_dir", files["images"], "--weights", files["w80"], "--batch_size", "5", "--device", "cpu"]
    to_is.main([*argv, "--saved_file", plain])
    to_is.main([*argv, "--saved_file", snap, "--snapshot_file", snapshot, "--precision", "fast"])
    with open(plain) as f, open(snap) as g:
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


# -- result files ----------------------------------------------------------------


@pytest.mark.parametrize("mean,std", [(1.0, 0.0), (12.345678901234567, 0.123456789), (1.0000001, 1e-9)])
def test_result_files_byte_identical_to_jax(tmp_path, mean, std):
    """IS*, IS* COCO and O-IS result files: the same bytes as the JAX
    package's writers, read back to the same floats by both readers."""
    for name in ("is", "is_coco", "o_is"):
        jpath, tpath = str(tmp_path / f"j_{name}.txt"), str(tmp_path / f"t_{name}.txt")
        getattr(jio, f"write_{name}_result")(jpath, mean, std)
        getattr(tio, f"write_{name}_result")(tpath, mean, std)
        with open(jpath, "rb") as fj, open(tpath, "rb") as ft:
            assert fj.read() == ft.read()
        assert getattr(tio, f"read_{name}_result")(tpath) == getattr(jio, f"read_{name}_result")(jpath)


def test_tf32_forward_is_scoped():
    """--precision fast on the f32 trunks allows TF32 inside the forward only."""
    tconfig.configure_precision("fast")
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    with tconfig.tf32_forward(True):
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    with tconfig.tf32_forward(False):
        assert not torch.backends.cudnn.allow_tf32
