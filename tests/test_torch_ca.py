"""The port's counter and CA CLI (tise_tpu_torch.backbones.counter,
tise_tpu_torch.metrics.ca) against the JAX package's on the CPU.

Peak stimulation is held to JAX's on random maps and on integer-valued maps
with planted ties (tied maxima inside a window, ties at the lower middle
order statistic); the counter, from one seeded CountSeg-layout state dict
converted by both packages, at 128 px; the count rule and the RMSE bit for
bit; the CA CLI at 448 px on 8 items byte for byte.  Random weights put
some counts and gates near a rounding or sign boundary, so the items are
planted from the port's own forward: each item's ground-truth classes are
classes whose gate and count lie at least ``MARGIN`` from their boundary on
that image, and the test asserts the margin again on the values the JAX CLI
computed.  Each JAX CLI runs once for the module.
"""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from tise_tpu.backbones import counter as jcounter
from tise_tpu.core import weights as jweights
from tise_tpu.metrics import ca as jca
from tise_tpu_torch.backbones import counter as tcounter
from tise_tpu_torch.backbones.detection.coco_classes import COCO_CLASSES
from tise_tpu_torch.core import io as tio
from tise_tpu_torch.metrics import ca as tca

N_ITEMS = 8
MARGIN = 0.02  # of a gate from 0 and of a count from a rounding boundary; the packages differ by ~1e-5
_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# peak stimulation
# ---------------------------------------------------------------------------


def _both_peaks(crm: np.ndarray):
    jconf, jmask = jax.jit(jcounter.peak_stimulation)(jnp.asarray(crm))
    tconf, tmask = tcounter.peak_stimulation(torch.from_numpy(crm))
    return (np.asarray(jconf), np.asarray(jmask)), (tconf.numpy(), tmask.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_peak_stimulation_matches_jax_on_random_maps(seed):
    crm = (np.random.RandomState(seed).randn(2, 80, 14, 14) * 3).astype(np.float32)
    (jconf, jmask), (tconf, tmask) = _both_peaks(crm)
    np.testing.assert_array_equal(tmask, jmask)
    np.testing.assert_allclose(tconf, jconf, rtol=1e-6, atol=1e-6)
    assert 0 < tmask.sum() < tmask.size


@pytest.mark.parametrize("shape", [(2, 80, 14, 14), (2, 80, 6, 10), (2, 80, 7, 9)])
def test_peak_stimulation_matches_jax_with_planted_ties(shape):
    """Integer maps in [-3, 3] tie inside most windows and at the median; a
    plateau and a map of one value are planted too.  Every tied maximum is
    a peak, and the median is the lower middle order statistic (an even h*w
    in the first two shapes)."""
    rng = np.random.RandomState(sum(shape))
    crm = rng.randint(-3, 4, shape).astype(np.float32)
    crm[0, 0] = 1.0  # one value everywhere: every position is a peak
    crm[0, 1, 2:5, 2:5] = 9.0  # a plateau of tied maxima
    (jconf, jmask), (tconf, tmask) = _both_peaks(crm)
    np.testing.assert_array_equal(tmask, jmask)
    np.testing.assert_allclose(tconf, jconf, rtol=1e-6, atol=1e-6)
    assert tmask[0, 0].all() and tmask[0, 1, 2:5, 2:5].all() and tconf[0, 0] == 1.0
    h, w = shape[2:]
    flat = np.sort(crm.reshape(*shape[:2], h * w), axis=-1)
    lower = flat[..., (h * w - 1) // 2]
    if h * w % 2 == 0:  # numpy's median would be the mean of the two middle values
        assert (lower != np.median(crm.reshape(*shape[:2], -1), axis=-1)).any()
    assert not (tmask & (crm < lower[..., None, None])).any()


# ---------------------------------------------------------------------------
# the counter and its weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def countseg():
    """A seeded CountSeg-layout state dict and its conversions by both packages."""
    sd = tcounter.random_countseg_state_dict(0)
    return {"sd": sd, "jax": jcounter.params_from_countseg(sd), "torch": tcounter.state_dict_from_countseg(sd)}


def _imagenet(u8: np.ndarray) -> np.ndarray:
    return ((u8.astype(np.float32) / 255.0 - _IMAGENET_MEAN) / _IMAGENET_STD).astype(np.float32)


def test_counter_matches_jax_at_128px(countseg):
    x = _imagenet(np.random.RandomState(3).randint(0, 256, (2, 128, 128, 3)).astype(np.uint8))
    jconf, jden = jax.jit(jcounter.FCResNet50PRM().apply)(countseg["jax"], x)
    model = tcounter.FCResNet50PRM.from_state_dict(countseg["torch"], "cpu")
    with torch.inference_mode():
        tconf, tden = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    jconf, jden = np.asarray(jconf), np.asarray(jden)
    assert tconf.shape == (2, 80) and tden.shape == jden.shape == (2, 80, 4, 4)
    for got, want in ((tconf.numpy(), jconf), (tden.numpy(), jden)):
        scale = float(np.abs(want).max())
        assert scale > 0.1 and float(np.abs(got - want).max()) <= 1e-4 * scale


def test_state_dict_from_jax_params_round_trip(countseg, tmp_path):
    """The JAX package's params, carried across, are the port's own
    conversion of the same checkpoint bit for bit (through the ``.npz`` file
    too); the parameter tree of the JAX module's ``init`` loads into the
    port's module."""
    direct = countseg["torch"]
    carried = tcounter.state_dict_from_jax_params(countseg["jax"])
    assert sorted(carried) == sorted(direct)
    for k in direct:
        assert carried[k].dtype == direct[k].dtype and np.array_equal(carried[k], direct[k]), k
    path = str(tmp_path / "counter.npz")
    jweights.save_pytree_npz(path, countseg["jax"])
    loaded = tcounter.load_counter_weights(path)
    assert all(np.array_equal(loaded[k], direct[k]) for k in direct)
    shapes = jax.eval_shape(jcounter.FCResNet50PRM().init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.RandomState(1)
    init = jax.tree_util.tree_map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    model = tcounter.FCResNet50PRM.from_state_dict(tcounter.state_dict_from_jax_params(init), "cpu")
    assert model.classifier.bias is not None and model.classifier.weight.shape == (240, 2048, 1, 1)


def test_countseg_prefixes_and_classifier_names(countseg):
    sd = countseg["sd"]
    renamed = {("module.backbone." + k if not k.startswith("classifier") else "module." + k.replace(
        "classifier", "classifier.0")): v for k, v in sd.items()}
    del renamed["module.classifier.0.bias"]
    got = tcounter.state_dict_from_countseg(renamed)
    assert "classifier.bias" not in got
    assert all(np.array_equal(got[k], v) for k, v in countseg["torch"].items() if k != "classifier.bias")
    assert tcounter.FCResNet50PRM.from_state_dict(got, "cpu").classifier.bias is None


def test_predict_counts_and_rmse_equal_jax():
    """The count rule and the RMSE are the JAX package's own numpy, bit for
    bit: gates at exactly 0, counts at exact halves (round half to even)."""
    rng = np.random.RandomState(5)
    conf = rng.randn(6, 80).astype(np.float32)
    conf[0, :10] = 0.0
    density = (rng.randn(6, 80, 14, 14) * 2).astype(np.float32)
    density[1, :8] = np.float32(0.5) + np.arange(8, dtype=np.float32)[:, None, None]  # means k + 0.5 exactly
    conf[1, :8] = 1.0
    got, want = tcounter.predict_counts(conf, density), jcounter.predict_counts(conf, density)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got[1, :8], np.round(np.arange(8) + 0.5)) and not got[0, :10].any()
    for pred, gt in (({"cat": 2.0}, {"cat": 1, "dog": 3}), ({}, {"person": 4}), ({"a": 1.0, "b": 7.0}, {"b": 5})):
        assert tca.rmse_for_item(pred, gt) == jca.rmse_for_item(pred, gt)


def test_ca_result_file_round_trip_and_nan(tmp_path):
    path = str(tmp_path / "ca.txt")
    tio.write_ca_result(path, 1.5666183219064238)
    with open(path) as f:
        assert f.read() == "CA = 1.5666183219064238"
    assert tio.read_ca_result(path) == 1.5666183219064238
    tio.write_ca_result(path, float("nan"))
    with pytest.raises(ValueError, match=re.escape(path) + ".*'CA = nan'"):
        tio.read_ca_result(path)


# ---------------------------------------------------------------------------
# the CA CLI
# ---------------------------------------------------------------------------


def make_ca_world(root, countseg_sd, n_items: int = N_ITEMS) -> dict:
    """``n_items`` seeded 64 x 64 PNGs (the CLIs resize them to 448), the
    CountSeg-layout weights as a ``.pt``, and items planted from the port's
    forward: 1-3 ground-truth classes of counts 1-5 an item, drawn from the
    classes whose gate and count clear ``MARGIN`` on that image."""
    images = root / "images"
    images.mkdir()
    rng = np.random.RandomState(11)
    ids = [f"{1000 + 7 * i}" for i in range(n_items)]
    for cid in ids:
        Image.fromarray(rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)).save(images / f"{cid}.png")
    weights = root / "coco14.pt"
    torch.save({k: torch.from_numpy(v) for k, v in countseg_sd.items()}, weights)
    engine = tca.CountingEngine(tcounter.state_dict_from_countseg(countseg_sd), "cpu")
    u8 = np.stack([tca.load_image(str(images / f"{cid}.png"), (tca.IMAGE_SIZE,) * 2) for cid in ids])
    conf, density = (t.numpy() for t in engine.dispatch(u8))
    means = density.mean(axis=(2, 3))
    clear = (np.abs(conf) >= MARGIN) & (np.abs(means - np.floor(means) - 0.5) >= MARGIN)
    items = []
    for i, cid in enumerate(ids):
        classes = rng.choice(np.flatnonzero(clear[i]), rng.randint(1, 4), replace=False)
        items.append({"caption_id": cid, "counting_info": {COCO_CLASSES[c]: int(rng.randint(1, 6)) for c in classes}})
    pkl = root / "items.pkl"
    tio.save_pickle(str(pkl), items)
    return {"root": root, "images": str(images), "weights": str(weights), "pkl": str(pkl), "items": items}


@pytest.fixture(scope="module")
def world(tmp_path_factory, countseg):
    return make_ca_world(tmp_path_factory.mktemp("ca"), countseg["sd"])


def _argv(world, result):
    return ["--image_dir", world["images"], "--ct_input_file", world["pkl"], "--weights", world["weights"],
            "--result_file", result]


@pytest.fixture(scope="module")
def cli_runs(world):
    """Each package's CLI once, recording the (confidence, density) its count rule saw."""
    seen = {"jax": [], "torch": []}
    out = {}
    for name, module, counter, extra in (("jax", jca, jcounter, []), ("torch", tca, tcounter, ["--device", "cpu"])):
        rule = counter.predict_counts

        def recording(conf, density, _seen=seen[name], _rule=rule):
            _seen.append((np.asarray(conf), np.asarray(density)))
            return _rule(conf, density)

        counter.predict_counts = recording
        try:
            result = str(world["root"] / f"{name}.txt")
            module.main(_argv(world, result) + extra)
        finally:
            counter.predict_counts = rule
        with open(result, "rb") as f:
            out[name] = f.read()
    return {"text": out, "seen": {k: tuple(np.concatenate(v) for v in zip(*s)) for k, s in seen.items()}}


def test_ca_cli_byte_identical_to_jax(world, cli_runs):
    """The result files are equal byte for byte; every gate and count that
    the items read clears ``MARGIN`` in both packages, which differ by far
    less."""
    assert cli_runs["text"]["torch"] == cli_runs["text"]["jax"]
    ca = float(cli_runs["text"]["torch"].decode()[len("CA = "):])
    assert math.isfinite(ca) and ca > 0
    (jconf, jden), (tconf, tden) = cli_runs["seen"]["jax"], cli_runs["seen"]["torch"]
    assert jconf.shape == tconf.shape == (N_ITEMS, 80) and tden.shape == (N_ITEMS, 80, 14, 14)
    jmeans, tmeans = jden.mean(axis=(2, 3)), tden.mean(axis=(2, 3))
    assert float(np.abs(tconf - jconf).max()) < MARGIN / 10 and float(np.abs(tmeans - jmeans).max()) < MARGIN / 10
    for i, item in enumerate(world["items"]):
        for name in item["counting_info"]:
            c = COCO_CLASSES.index(name)
            for conf, mean in ((jconf[i, c], jmeans[i, c]), (tconf[i, c], tmeans[i, c])):
                assert abs(conf) >= MARGIN / 2 and abs(mean - math.floor(mean) - 0.5) >= MARGIN / 2, (i, name)
    counts = tcounter.predict_counts(tconf, tden)
    assert len(np.unique(counts)) >= 3 and (counts == 0).any()


def test_ca_resumed_run_equals_straight_run(world, cli_runs, monkeypatch):
    """A run that fails after its first snapshot (batches of 2, a snapshot
    every 2 items) leaves the snapshot; the same command resumes from it to
    the straight run's value, counting only the items after the cursor."""
    straight = float(cli_runs["text"]["torch"].decode()[len("CA = "):])
    engine = tca.CountingEngine(tcounter.load_counter_weights(world["weights"]), "cpu")
    items = tio.load_pickle(world["pkl"])
    snap = str(world["root"] / "ca.snapshot.npz")
    dispatched = []

    def failing(images_u8, _dispatch=engine.dispatch):
        if len(dispatched) == 2:
            raise RuntimeError("injected failure")
        dispatched.append(len(images_u8))
        return _dispatch(images_u8)

    monkeypatch.setattr(engine, "dispatch", failing)
    with pytest.raises(RuntimeError, match="injected failure"):
        tca.compute_ca(items, world["images"], engine, batch_size=2, snapshot_path=snap, snapshot_every=2)
    assert os.path.exists(snap)
    monkeypatch.undo()
    counted = []
    monkeypatch.setattr(engine, "pull", lambda handle, _pull=engine.pull: counted.append(1) or _pull(handle))
    resumed = tca.compute_ca(items, world["images"], engine, batch_size=2, snapshot_path=snap, snapshot_every=2)
    assert resumed == straight and len(counted) == 2 and not os.path.exists(snap)


def test_ca_cli_without_device_raises_where_there_is_no_card(world, tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="--device cpu"):
        tca.main(_argv(world, str(tmp_path / "ca.txt")))
    assert not os.path.exists(tmp_path / "ca.txt")
