"""The port's ClipPairScorer and its RP-COCO and PA CLIs against the JAX
package's on the CPU, at the full width of ViT-B/32.

One ``.npz`` of the JAX package's ``random_params`` feeds both packages; a
merge table written by the test, a seeded pool of 40 synthetic captions and
12 seeded non-square PNGs make the inputs.  Random weights tie no caption to
an image, so the items are planted from the JAX bank logits of every
(image, pool caption) pair: even items take their image's top caption as the
ground truth (RP success), odd items a lower one; PA's caption pairs are
chosen the same way.  Every decision then sits clear of the logit
tolerance, which the tests assert, so the byte comparison of the result
files is a check and not a coin toss.

The JAX CLIs run on a one-device mesh: on the suite's eight virtual CPU
devices the JAX package's bank path fails (its bank comes back sharded over
the data axis and the rank program asks for it replicated), a fault of the
multi-device JAX path that one card never meets.  Each CLI configuration
runs once per package for the module.
"""

import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from tests.test_torch_clip import WORDS, write_merge_table
from tise_tpu.backbones import clip_tokenizer as jtok
from tise_tpu.backbones import clip_vit as jclip
from tise_tpu.core import io as jio
from tise_tpu.core import weights as jweights
from tise_tpu.core.mesh import make_mesh
from tise_tpu.metrics import clip_scorer as jscorer
from tise_tpu.metrics import pa as jpa
from tise_tpu.metrics import rp_coco as jrp
from tise_tpu_torch.backbones import clip_vit as tclip
from tise_tpu_torch.backbones.clip_tokenizer import SimpleTokenizer
from tise_tpu_torch.core import io as tio
from tise_tpu_torch.core.data import center_crop_resize
from tise_tpu_torch.metrics import clip_scorer as tscorer
from tise_tpu_torch.metrics import pa as tpa
from tise_tpu_torch.metrics import rp_coco as trp

N_IMAGES, POOL, K = 12, 40, 100
PHRASES = ("left", "under")
TOL = 1e-4  # logits: rtol and atol of their scale


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_clip(tmp_path_factory):
    """The JAX CLIP weights (made once: random_params compiles the whole
    model), saved as the ``.npz`` both packages read, and the one-device
    mesh the JAX scorer runs on."""
    root = tmp_path_factory.mktemp("clip_weights")
    params = jax.tree_util.tree_map(np.asarray, jclip.random_params(jax.random.PRNGKey(0)))
    npz = str(root / "clip.npz")
    jweights.save_pytree_npz(npz, params)
    return {"params": params, "npz": npz, "mesh": make_mesh(devices=jax.devices()[:1])}


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_clip):
    root = tmp_path_factory.mktemp("clip_cli")
    bpe = write_merge_table(root / "bpe.txt", WORDS)
    rng = np.random.RandomState(0)
    pool = []
    while len(pool) < POOL:
        cap = " ".join(rng.choice(WORDS, rng.randint(3, 10)))
        if cap not in pool:
            pool.append(cap)
    images = root / "images"
    images.mkdir()
    for i in range(N_IMAGES):  # 256x320 and 320x256 blocks of colour: the resize and the crop both act
        h, w = (256, 320) if i % 2 else (320, 256)
        arr = np.kron(rng.randint(0, 256, (h // 32, w // 32, 3)), np.ones((32, 32, 1))).astype(np.uint8)
        Image.fromarray(arr).save(str(images / f"{i}.png"))
    return {"root": root, "bpe": bpe, "pool": pool, "images": str(images),
            "tokens": jtok.SimpleTokenizer(bpe).tokenize(pool)}


def _u8(world, ids):
    return np.stack([center_crop_resize(os.path.join(world["images"], f"{i}.png"), 224) for i in ids])


@pytest.fixture(scope="module")
def scorers(jax_clip):
    return {"jax": jscorer.ClipPairScorer(jax_clip["params"], mesh=jax_clip["mesh"]),
            "torch": tscorer.ClipPairScorer(tclip.load_params(jax_clip["npz"]), "cpu")}


@pytest.fixture(scope="module")
def bank_logits(world, scorers):
    """Each package's text bank of the pool and its logits of every
    (image, pool caption) pair [12, 40], through ``logits_from_bank``."""
    imgs = _u8(world, range(N_IMAGES))
    idx = np.tile(np.arange(POOL, dtype=np.int32), (N_IMAGES, 1))
    out = {}
    for name, scorer in scorers.items():
        bank = scorer.encode_text_bank(world["tokens"], batch_size=16)  # three chunks
        out[name] = {"bank": np.asarray(bank), "logits": scorer.logits_from_bank(imgs, bank, idx)}
    return out


def _margin_ok(logits, chosen, others, tol):
    """The chosen caption's logit is clear of the best other one by more
    than twice the logit tolerance (each side may move by ``tol``)."""
    return abs(logits[chosen] - max(logits[j] for j in others)) > 2 * tol


@pytest.fixture(scope="module")
def inputs(world, bank_logits):
    """The RP pickle (12 items, K = 100), its first 10 items cut to K = 10
    for the run without the bank, and the PA pickle (2 phrases x 5 items on
    images 0-9), planted from the JAX bank logits."""
    lg = bank_logits["jax"]["logits"]
    tol = TOL * float(np.abs(lg).max())
    rng = np.random.RandomState(1)
    pool = world["pool"]
    items, small = [], []
    for i in range(N_IMAGES):
        order = np.argsort(-lg[i])
        gt = order[0] if i % 2 == 0 else order[rng.randint(6, POOL)]
        mism = rng.choice([j for j in range(POOL) if j != gt], K - 1)
        assert _margin_ok(lg[i], gt, mism, tol) and _margin_ok(lg[i], gt, mism[:9], tol), i
        items.append({"caption_id": i, "caption": pool[gt], "mismatched_captions": [pool[j] for j in mism]})
        if i < 10:
            small.append({**items[-1], "mismatched_captions": items[-1]["mismatched_captions"][:9]})
    threshold = np.log(0.6 / 0.4)  # P(gt) > 0.6 <=> logit difference > log 1.5
    pa_data = {}
    for p, phrase in enumerate(PHRASES):
        os.makedirs(os.path.join(world["images"], phrase))
        pa_data[phrase] = []
        for j in range(5):
            i = 5 * p + j
            order = np.argsort(-lg[i])
            c, f = (order[0], order[-1]) if j % 2 == 0 else tuple(rng.choice(POOL, 2, replace=False))
            assert abs(lg[i][c] - lg[i][f] - threshold) > 2 * tol, (phrase, j)
            shutil.copy(os.path.join(world["images"], f"{i}.png"), os.path.join(world["images"], phrase, f"{j}.png"))
            pa_data[phrase].append({"caption_id": j, "caption": pool[c], "false_caption": pool[f]})
    root = world["root"]
    paths = {"rp": str(root / "rp.pkl"), "rp10": str(root / "rp10.pkl"), "pa": str(root / "pa.pkl")}
    for key, obj in (("rp", items), ("rp10", small), ("pa", pa_data)):
        jio.save_pickle(paths[key], obj)
    return paths


@pytest.fixture(scope="module")
def cli_runs(world, jax_clip, inputs):
    """Each CLI configuration once: {run: result file text}."""
    root, out = world["root"], {}
    common = ["--image_dir", world["images"], "--weights", jax_clip["npz"], "--bpe_path", world["bpe"],
              "--batch_size", "8"]
    runs = (
        ("rp_jax", jrp.main, ["--rp_input_file", inputs["rp"]]),
        ("rp_torch", trp.main, ["--rp_input_file", inputs["rp"], "--device", "cpu"]),
        ("rp10_jax", jrp.main, ["--rp_input_file", inputs["rp10"]]),
        ("rp10_torch_no_dedup", trp.main, ["--rp_input_file", inputs["rp10"], "--no-dedup-text", "--device", "cpu",
                                           "--gpu_id", "3"]),
        ("pa_jax", jpa.main, ["--pa_input_file", inputs["pa"]]),
        ("pa_torch", tpa.main, ["--pa_input_file", inputs["pa"], "--device", "cpu"]),
    )
    one_device = lambda params, fast=False: jscorer.ClipPairScorer(params, mesh=jax_clip["mesh"], fast=fast)  # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrp, "ClipPairScorer", one_device)
        mp.setattr(jpa, "ClipPairScorer", one_device)
        for name, main, argv in runs:
            saved = str(root / f"{name}.txt")
            main([*common, *argv, "--saved_file_path", saved])
            with open(saved, "rb") as f:
                out[name] = f.read()
    return out


def _close(got, want, tol=TOL):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def test_text_bank_and_bank_logits_match_jax(bank_logits):
    got, ref = bank_logits["torch"], bank_logits["jax"]
    assert got["bank"].shape == ref["bank"].shape == (POOL, 512)
    np.testing.assert_allclose(np.linalg.norm(got["bank"], axis=1), 1.0, rtol=1e-5)
    _close(got["bank"], ref["bank"])
    assert got["logits"].shape == (N_IMAGES, POOL) and got["logits"].dtype == np.float32
    _close(got["logits"], ref["logits"])


def test_logits_match_jax_and_the_bank_path(world, scorers, bank_logits):
    """``logits`` (each item's token set through the text tower) against
    JAX's, and against the port's own bank path on the same captions."""
    rng = np.random.RandomState(3)
    idx = rng.randint(0, POOL, (3, 4)).astype(np.int32)
    imgs = _u8(world, [0, 5, 7])
    toks = world["tokens"][idx]
    got, ref = scorers["torch"].logits(imgs, toks), scorers["jax"].logits(imgs, toks)
    assert got.shape == (3, 4)
    _close(got, ref)
    via_bank = bank_logits["torch"]["logits"][[0, 5, 7]][np.arange(3)[:, None], idx]
    _close(via_bank, got, 1e-5)


def test_empty_bank(scorers):
    bank = scorers["torch"].encode_text_bank(np.zeros((0, 77), np.int32))
    assert tuple(bank.shape) == (0, 512)


def test_rp_cli_byte_identical_to_jax(cli_runs):
    text = cli_runs["rp_torch"].decode()
    assert re.fullmatch(r"R-precision: [-+0-9.eE]+ \+- [-+0-9.eE]+", text), text
    assert cli_runs["rp_torch"] == cli_runs["rp_jax"]
    mean, std = (float(v) for v in text[len("R-precision: "):].split(" +- "))
    assert 0.0 < mean < 1.0 and std > 0.0  # planted: about half the items succeed


def test_rp_cli_without_the_bank_byte_identical_to_jax(cli_runs):
    """--no-dedup-text re-encodes each item's captions; its file equals the
    JAX CLI's (bank path, exact either way) on the same 10 items of K = 10."""
    assert cli_runs["rp10_torch_no_dedup"] == cli_runs["rp10_jax"]
    assert cli_runs["rp10_jax"].startswith(b"R-precision: ")


def test_pa_cli_byte_identical_to_jax(cli_runs):
    text = cli_runs["pa_torch"].decode()
    assert re.fullmatch(r"PA = [-+0-9.eE]+", text), text
    assert cli_runs["pa_torch"] == cli_runs["pa_jax"]
    assert 0.0 < float(text[5:]) < 1.0


def test_pa_matches_host_softmax(world, scorers, inputs):
    """The port's PA against the rule computed here from its logits."""
    data = tio.load_pickle(inputs["pa"])
    tok = SimpleTokenizer(world["bpe"])
    scores = []
    for phrase, items in data.items():
        imgs = np.stack([center_crop_resize(os.path.join(world["images"], phrase, f"{it['caption_id']}.png"), 224)
                         for it in items])
        logits = scorers["torch"].logits(imgs, np.stack([tok.tokenize([it["caption"], it["false_caption"]])
                                                         for it in items])).astype(np.float64)
        p = 1.0 / (1.0 + np.exp(logits[:, 1] - logits[:, 0]))
        scores.append(float(np.mean(p > 0.6)))
    pa, _ = tpa.compute_pa(data, world["images"], scorers["torch"], tok, batch_size=4)
    assert pa == pytest.approx(np.mean(scores), abs=1e-12)


class _FailingScorer:
    """The port's scorer, failing at its ``fail_at``-th image batch."""

    def __init__(self, inner, fail_at):
        self.inner, self.fail_at, self.batches = inner, fail_at, 0

    def _count(self):
        self.batches += 1
        if self.batches == self.fail_at:
            raise RuntimeError("injected failure")

    def dispatch_from_bank(self, *args):
        self._count()
        return self.inner.dispatch_from_bank(*args)

    def logits(self, *args):
        self._count()
        return self.inner.logits(*args)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _counting(scorer_cls, seen):
    class Counting(scorer_cls):
        def dispatch_from_bank(self, images_u8, *args):
            seen.append(len(images_u8))
            return super().dispatch_from_bank(images_u8, *args)

        def logits(self, images_u8, *args):
            seen.append(len(images_u8))
            return super().logits(images_u8, *args)

    return Counting


def test_rp_snapshot_resumes_to_the_same_result(world, jax_clip, scorers, inputs, cli_runs, monkeypatch):
    """A run that fails after its first snapshot leaves it; the CLI with
    --snapshot_file resumes from the cursor, scores only the rest and writes
    the straight run's bytes; a finished run deletes the snapshot."""
    items = tio.load_pickle(inputs["rp"])
    paths = [os.path.join(world["images"], f"{it['caption_id']}.png") for it in items]
    snap = str(world["root"] / "rp.snapshot.npz")
    with pytest.raises(RuntimeError, match="injected"):
        trp.score_items(items, paths, _FailingScorer(scorers["torch"], fail_at=3),
                        SimpleTokenizer(world["bpe"]), batch_size=4, snapshot_path=snap, snapshot_every=4)
    with np.load(snap) as z:
        assert int(z["cursor"]) == 8
    seen = []
    monkeypatch.setattr(trp, "ClipPairScorer", _counting(tscorer.ClipPairScorer, seen))
    saved = str(world["root"] / "rp_resumed.txt")
    trp.main(["--image_dir", world["images"], "--rp_input_file", inputs["rp"], "--weights", jax_clip["npz"],
              "--bpe_path", world["bpe"], "--batch_size", "4", "--snapshot_file", snap, "--device", "cpu",
              "--saved_file_path", saved])
    assert seen == [4] and not os.path.exists(snap)
    with open(saved, "rb") as f:
        assert f.read() == cli_runs["rp_torch"]


def test_pa_snapshot_resumes_to_the_same_result(world, jax_clip, scorers, inputs, cli_runs, monkeypatch):
    """PA resumes past the phrases its snapshot holds."""
    data = tio.load_pickle(inputs["pa"])
    snap = str(world["root"] / "pa.snapshot.npz")
    with pytest.raises(RuntimeError, match="injected"):
        tpa.compute_pa(data, world["images"], _FailingScorer(scorers["torch"], fail_at=2),
                       SimpleTokenizer(world["bpe"]), batch_size=8, snapshot_path=snap)
    assert os.path.exists(snap)
    seen = []
    monkeypatch.setattr(tpa, "ClipPairScorer", _counting(tscorer.ClipPairScorer, seen))
    saved = str(world["root"] / "pa_resumed.txt")
    tpa.main(["--image_dir", world["images"], "--pa_input_file", inputs["pa"], "--weights", jax_clip["npz"],
              "--bpe_path", world["bpe"], "--batch_size", "8", "--snapshot_file", snap, "--device", "cpu",
              "--saved_file_path", saved])
    assert seen == [5] and not os.path.exists(snap)
    with open(saved, "rb") as f:
        assert f.read() == cli_runs["pa_torch"]


@pytest.mark.parametrize("n,seed", [(100, 0), (103, 0), (50, 7), (9, 1), (2048, 3)])
def test_make_bins_equals_jax(n, seed):
    assert trp.make_bins(n, 10, seed) == jrp.make_bins(n, 10, seed)


@pytest.mark.parametrize("main", [trp.main, tpa.main])
def test_cli_without_device_raises_where_there_is_no_card(main):
    """The CLIs run on the card unless told otherwise: with no --device and
    no CUDA device they raise and name --device cpu."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--weights", "unused.npz", "--bpe_path", "unused.txt"])


@pytest.mark.parametrize("value", [0.0, 0.5, 1 / 3, 0.123456789012345])
def test_result_files_byte_identical_to_jax(tmp_path, value):
    for i, (jwrite, twrite, args) in enumerate((
            (jio.write_rp_coco_result, tio.write_rp_coco_result, (value, value / 7)),
            (jio.write_pa_result, tio.write_pa_result, (value,)))):
        jpath, tpath = str(tmp_path / f"j{i}.txt"), str(tmp_path / f"t{i}.txt")
        jwrite(jpath, *args)
        twrite(tpath, *args)
        with open(jpath, "rb") as fj, open(tpath, "rb") as ft:
            assert fj.read() == ft.read()
    assert tio.read_rp_coco_result(str(tmp_path / "t0.txt")) == jio.read_rp_coco_result(str(tmp_path / "j0.txt"))
    assert tio.read_pa_result(str(tmp_path / "t1.txt")) == jio.read_pa_result(str(tmp_path / "j1.txt")) == value
