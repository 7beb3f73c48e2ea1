"""The port's RP-CUB CLI (tise_tpu_torch.metrics.rp_cub) and its CUB track
runner (tise_tpu_torch.benchmark) against the JAX package's on the CPU.

The DAMSM encoders run at full width (a vocabulary of 5,450 words, embedding
300, 2 x 128 LSTM units, nef 256, InceptionV3 at 299) with seeded numpy
weights in the reference's ``.pth`` layout (the image encoder also as the
JAX package's ``.npz``).  24 blocky PNGs and a pool of 40 synthetic captions
(mixed case, punctuation, words out of the vocabulary, a caption that
tokenizes to nothing and one longer than the 32 tokens kept) make the inputs.
Random weights tie no caption to an image, so the items are planted from the
JAX encoders' cosines of every (image, pool caption) pair: even items take
their image's best caption (a success), odd items a lower one (a failure),
and every decision's margin over the best mismatched caption clears the
tolerance, which the fixture asserts; the byte comparison of the result
files is then a check and not a coin toss.  With fewer than 27,000 items the
reference's ``--legacy-compat`` bins are empty past the first, so both
packages write ``nan`` there; ``legacy_bins`` itself is held on 30,000
successes.

Each JAX CLI and the JAX runner run once for the module.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from chip_smoke import FailingScorer
from tests.tf_slim_ref import random_slim_vars
from tise_tpu import benchmark as jbench
from tise_tpu.backbones import damsm as jdamsm
from tise_tpu.core import io as jio
from tise_tpu.core import weights as jweights
from tise_tpu.metrics import rp_cub as jrp
from tise_tpu.ops.preprocess import normalize as jnormalize
from tise_tpu_torch import benchmark as tbench
from tise_tpu_torch.backbones import damsm as tdamsm
from tise_tpu_torch.backbones.inception_v3 import random_state_dict as inception_state_dict
from tise_tpu_torch.core import io as tio
from tise_tpu_torch.core.data import load_image
from tise_tpu_torch.metrics import rp_cub as trp

N_IMAGES, POOL, K, NTOKEN = 24, 40, 100, 5450
TOL = 1e-4  # cosines: the port's may differ from JAX's by well under this


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


def _caption_pool(rng):
    words = [f"w{i}" for i in range(1, NTOKEN)]
    pool = ["Zzz qqq, unknown!", " ".join(rng.choice(words, 40))]  # tokenizes to nothing; longer than 32
    while len(pool) < POOL:
        ws = list(rng.choice(words, rng.randint(2, 26)))
        ws[0] = ws[0].upper()
        ws.insert(rng.randint(len(ws)), "café")  # ascii filter: "caf", not in the vocabulary
        cap = " ".join(ws[:-1]) + ", " + ws[-1] + "."
        if cap not in pool:
            pool.append(cap)
    return pool


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Images, vocabulary pickle, weights (.pth and the image encoder's JAX
    .npz) and the JAX cosines [24, 40] of every image against the pool."""
    root = tmp_path_factory.mktemp("rp_cub")
    rng = np.random.RandomState(0)
    images = root / "images"
    images.mkdir()
    for i in range(N_IMAGES):
        arr = np.kron(rng.randint(0, 256, (4, 4, 3)), np.ones((16, 16, 1))).astype(np.uint8)
        Image.fromarray(arr).save(str(images / f"{i}.png"))
    ixtoword = {0: "<end>", **{i: f"w{i}" for i in range(1, NTOKEN)}}
    vocab = str(root / "captions.pickle")
    jio.save_pickle(vocab, [[], [], ixtoword, {w: i for i, w in ixtoword.items()}])
    rnn_sd, cnn_sd = tdamsm.random_rnn_state_dict(seed=1, ntoken=NTOKEN), tdamsm.random_cnn_state_dict(seed=2)
    paths = {"text": str(root / "text_encoder200.pth"), "image": str(root / "image_encoder200.pth"),
             "image_npz": str(root / "image_encoder200.npz")}
    for key, sd in (("text", rnn_sd), ("image", cnn_sd)):
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, paths[key])
    cnn_params = jax.tree_util.tree_map(np.asarray, jdamsm.cnn_params_from_torch(cnn_sd))
    jweights.save_pytree_npz(paths["image_npz"], cnn_params)

    pool = _caption_pool(rng)
    wordtoix = {w: i for i, w in ixtoword.items()}
    caps, lens = jrp.pack_caption_sets([[jrp.tokenize_caption(c, wordtoix) for c in pool]], 32)
    assert lens[0, 0] == 1 and lens[0, 1] == 32 and (lens[0, 2:] > 1).all()
    _, sent = jdamsm.RNNEncoder(ntoken=NTOKEN).apply(jdamsm.rnn_params_from_torch(rnn_sd), caps[0], lens[0])
    u8 = np.stack([load_image(str(images / f"{i}.png"), (256, 256)) for i in range(N_IMAGES)])
    _, code = jax.jit(lambda p, x: jdamsm.CNNEncoder().apply(p, jnormalize(x, "half")))(cnn_params, jnp.asarray(u8))
    code, sent = np.asarray(code, np.float64), np.asarray(sent, np.float64)
    cos = code @ sent.T / (np.linalg.norm(code, axis=1)[:, None] * np.linalg.norm(sent, axis=1)[None])
    return {"root": root, "images": str(images), "vocab": vocab, "pool": pool, "cos": cos, "weights": paths,
            "rnn_sd": rnn_sd, "cnn_sd": cnn_sd}


@pytest.fixture(scope="module")
def items(world):
    """The planted RP pickle: 24 items of a caption and 99 mismatched ones."""
    rng = np.random.RandomState(1)
    cos, pool, out = world["cos"], world["pool"], []
    for i in range(N_IMAGES):
        order = np.argsort(-cos[i])
        for _ in range(50):  # draw until the decision clears the tolerance
            gt = order[0] if i % 2 == 0 else order[rng.randint(6, POOL)]
            mism = rng.choice([j for j in range(POOL) if j != gt], K - 1)
            if abs(cos[i, gt] - cos[i, mism].max()) > 2 * TOL:
                break
        assert abs(cos[i, gt] - cos[i, mism].max()) > 2 * TOL, i
        assert (cos[i, gt] > cos[i, mism].max()) == (i % 2 == 0), i
        out.append({"caption_id": i, "caption": pool[gt], "mismatched_captions": [pool[j] for j in mism]})
    path = str(world["root"] / "CUB_RP_captions.pkl")
    jio.save_pickle(path, out)
    return path


def _common(world, items, image_key="image"):
    return ["--image_dir", world["images"], "--rp_input_file", items, "--captions_pickle", world["vocab"],
            "--text_encoder", world["weights"]["text"], "--image_encoder", world["weights"][image_key]]


@pytest.fixture(scope="module")
def cli_runs(world, items):
    """Each CLI configuration once: {run: result file bytes}."""
    out = {}
    runs = (
        ("jax", jrp.main, ["--batch_size", "8"]),
        ("jax_legacy", jrp.main, ["--batch_size", "8", "--legacy-compat"]),
        ("torch", trp.main, ["--batch_size", "5", "--device", "cpu", "--gpu_id", "3"]),
        ("torch_legacy", trp.main, ["--batch_size", "8", "--legacy-compat", "--device", "cpu"]),
    )
    for name, main, argv in runs:
        saved = str(world["root"] / f"{name}.txt")
        main([*_common(world, items), *argv, "--saved_file_path", saved])
        with open(saved, "rb") as f:
            out[name] = f.read()
    return out


def test_rp_cub_cli_byte_identical_to_jax(cli_runs):
    text = cli_runs["torch"].decode()
    assert re.fullmatch(r"R mean:\d\.\d{6} std:\d\.\d{6}", text), text
    assert cli_runs["torch"] == cli_runs["jax"]
    mean, std = (float(v) for v in re.findall(r"\d\.\d{6}", text))
    assert 0.0 < mean < 1.0 and std > 0.0  # planted: half the items succeed


def test_rp_cub_cli_legacy_byte_identical_to_jax(cli_runs):
    assert cli_runs["torch_legacy"] == cli_runs["jax_legacy"] == b"R mean:nan std:nan"


def test_scorer_matches_jax_cosines(world, items):
    """The port's scores of the planted items within TOL of the JAX
    encoders' cosines, and the per-item successes of compute_rp_cub
    alternate as planted."""
    scorer = trp.DamsmScorer(world["rnn_sd"], world["cnn_sd"], "cpu")
    rp_input = tio.load_pickle(items)
    wordtoix = trp.load_vocab(world["vocab"])[1]
    caps, lens = trp.pack_caption_sets(
        [[trp.tokenize_caption(c, wordtoix) for c in [it["caption"], *it["mismatched_captions"]]]
         for it in rp_input[:4]], trp.MAX_LEN)
    u8 = np.stack([load_image(os.path.join(world["images"], f"{i}.png"), (256, 256)) for i in range(4)])
    got = scorer.pull(scorer.dispatch(u8, caps, lens))
    pool = {c: j for j, c in enumerate(world["pool"])}
    ref = np.array([[world["cos"][i, pool[c]] for c in [it["caption"], *it["mismatched_captions"]]]
                    for i, it in enumerate(rp_input[:4])])
    assert got.shape == (4, K) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL / 10)
    mean, std, successes = trp.compute_rp_cub(rp_input, world["images"], scorer, wordtoix, batch_size=7)
    np.testing.assert_array_equal(successes, (np.arange(N_IMAGES) % 2 == 0).astype(np.float64))
    bins = trp.equal_bins(successes, seed=0)
    assert (mean, std) == (float(np.average(bins)), float(np.std(bins)))


def test_rp_cub_snapshot_resumes_to_the_same_result(world, items, cli_runs, monkeypatch):
    """A run that fails after its first snapshot leaves it; the CLI with
    --snapshot_file resumes from the cursor, scores only the rest and writes
    the straight run's bytes; a finished run deletes the snapshot."""
    rp_input = tio.load_pickle(items)
    wordtoix = trp.load_vocab(world["vocab"])[1]
    snap = str(world["root"] / "rp.snapshot.npz")
    scorer = trp.DamsmScorer(world["rnn_sd"], world["cnn_sd"], "cpu")
    with pytest.raises(RuntimeError, match="injected"):
        trp.score_items(rp_input, world["images"], FailingScorer(scorer, fail_at=3), wordtoix, batch_size=4,
                        snapshot_path=snap, snapshot_every=4)
    with np.load(snap) as z:
        assert int(z["cursor"]) == 8
    seen = []

    class Counting(trp.DamsmScorer):
        def dispatch(self, images_u8, *args):
            seen.append(len(images_u8))
            return super().dispatch(images_u8, *args)

    monkeypatch.setattr(trp, "DamsmScorer", Counting)
    saved = str(world["root"] / "rp_resumed.txt")
    trp.main([*_common(world, items, "image_npz"), "--batch_size", "4", "--snapshot_file", snap, "--device", "cpu",
              "--saved_file_path", saved])
    assert seen == [4] * 4 and not os.path.exists(snap)
    with open(saved, "rb") as f:
        assert f.read() == cli_runs["torch"]


def test_rp_cub_cli_refuses_a_vocabulary_of_another_size(world, items, tmp_path):
    vocab = str(tmp_path / "captions.pickle")
    ixtoword = {i: f"w{i}" for i in range(NTOKEN + 1)}
    jio.save_pickle(vocab, [[], [], ixtoword, {w: i for i, w in ixtoword.items()}])
    argv = _common(world, items)
    argv[argv.index("--captions_pickle") + 1] = vocab
    with pytest.raises(ValueError, match="embeds 5450 words"):
        trp.main([*argv, "--device", "cpu"])


# ---------------------------------------------------------------------------
# helpers and result files against the JAX package
# ---------------------------------------------------------------------------

_VOCAB = {w: i for i, w in enumerate(["<end>", "a", "red", "bird", "wing", "has", "and", "tail", "caf", "ab"])}


@pytest.mark.parametrize("sent", ["A red, red bird!!", "unknown words only", "", "this bird has a red wing",
                                  "café RED-bird éé", "a��b red", "a_b red  \n tail",
                                  "bird wing 123 tail"])
def test_tokenize_caption_equals_jax(sent):
    assert trp.tokenize_caption(sent, _VOCAB) == jrp.tokenize_caption(sent, _VOCAB)


@pytest.mark.parametrize("sets,max_len", [([[[1, 2, 3], [4]], [[5, 6], []]], 5), ([[[1] * 40, [2, 3]]], 32),
                                          ([[[], []]], 4), ([[[7, 8, 9]]], 2)])
def test_pack_caption_sets_equals_jax(sets, max_len):
    got, ref = trp.pack_caption_sets(sets, max_len), jrp.pack_caption_sets(sets, max_len)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)


@pytest.mark.parametrize("n,seed,p", [(30000, 0, 0.3), (30000, 5, 0.8), (24, 0, 0.5), (103, 2, 0.5), (7, 1, 0.5)])
def test_bins_equal_jax(n, seed, p):
    """equal_bins at every size; legacy_bins (the off-by-one slices) on the
    reference's 30,000 items."""
    successes = (np.random.RandomState(seed).uniform(size=n) < p).astype(np.float64)
    assert np.array_equal(trp.equal_bins(successes, seed=seed), jrp.equal_bins(successes, seed=seed), equal_nan=True)
    if n == 30000:
        got = trp.legacy_bins(successes, seed)
        assert np.array_equal(got, jrp.legacy_bins(successes, seed)) and np.isfinite(got).all()


@pytest.mark.parametrize("value", [0.0, 0.5, 1 / 3, 0.123456789012345, 0.9999996])
def test_rp_cub_result_file_byte_identical_to_jax(tmp_path, value):
    jpath, tpath = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jio.write_rp_cub_result(jpath, value, value / 7)
    tio.write_rp_cub_result(tpath, value, value / 7)
    with open(jpath, "rb") as fj, open(tpath, "rb") as ft:
        assert fj.read() == ft.read()
    assert tio.read_rp_cub_result(tpath) == jio.read_rp_cub_result(jpath)


@pytest.mark.parametrize("write,read,args", [
    ("write_fid_result", "read_fid_result", (26.581254719518654,)),
    ("write_is_result", "read_is_result", (15.125445365905762, 0.1348673403263092)),
    ("write_is_coco_result", "read_is_coco_result", (54.62964, 1.53601)),
    ("write_rp_coco_result", "read_rp_coco_result", (0.7247999999999999, 0.025110953785151234)),
    ("write_pa_result", "read_pa_result", (0.47753623188405797,)),
])
def test_finite_results_read_as_jax_reads_them(tmp_path, write, read, args):
    path = str(tmp_path / "r.txt")
    getattr(tio, write)(path, *args)
    assert getattr(tio, read)(path) == getattr(jio, read)(path)


@pytest.mark.parametrize("text,read", [("FID: nan", "read_fid_result"), ("IS = nan  +-  nan", "read_is_result"),
                                       ("R mean:nan std:nan", "read_rp_cub_result"), ("", "read_pa_result"),
                                       ("IS = 3.5  +-  nan", "read_is_result")])
def test_results_without_their_numbers_raise_a_value_error(tmp_path, text, read):
    path = str(tmp_path / "r.txt")
    with open(path, "w") as f:
        f.write(text)
    with pytest.raises(ValueError, match=re.escape(path) + ".*" + re.escape(repr(text))):
        getattr(tio, read)(path)


@pytest.mark.parametrize("main", [trp.main, tbench.main])
def test_entry_points_without_device_raise_where_there_is_no_card(main, tmp_path):
    assert not torch.cuda.is_available()
    argv = {trp.main: ["--captions_pickle", "x", "--text_encoder", "x", "--image_encoder", "x"],
            tbench.main: ["--track", "cub", "--method_name", "m", "--images", "x",
                          "--output_root", str(tmp_path)]}[main]
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(argv)


# ---------------------------------------------------------------------------
# the CUB track runner
# ---------------------------------------------------------------------------


def _flag(argv, name):
    return argv[argv.index(name) + 1]


@pytest.fixture
def stubbed(tmp_path, monkeypatch):
    """A layout of placeholder files and stubbed metric mains in both
    packages, each recording its argv and writing a result file."""
    data, weights = tmp_path / "data", tmp_path / "weights"
    for root, table in ((data, tbench.DATA), (weights, tbench.WEIGHTS)):
        for rel in table.values():
            os.makedirs((root / rel).parent, exist_ok=True)
            (root / rel).write_bytes(b"x")
    (tmp_path / "gen").mkdir()
    calls = []
    results = {"fid": lambda a: tio.write_fid_result(_flag(a, "--saved_file"), 15.01),
               "is_star": lambda a: tio.write_is_result(_flag(a, "--saved_file"), 15.13, 0.3),
               "rp": lambda a: tio.write_rp_cub_result(_flag(a, "--saved_file_path"), 0.7731, 0.01)}

    def stub(package, name):
        def run(argv):
            calls.append((package, name, list(argv)))
            results[name](argv)
        return run

    import tise_tpu.metrics.fid as jfid
    import tise_tpu.metrics.is_star as jis
    import tise_tpu_torch.metrics.fid as tfid
    import tise_tpu_torch.metrics.is_star as tis

    for package, mods in (("jax", (jfid, jis, jrp)), ("torch", (tfid, tis, trp))):
        for name, mod in zip(("fid", "is_star", "rp"), mods):
            monkeypatch.setattr(mod, "main", stub(package, name))
    argv = ["--track", "cub", "--method_name", "MyModel", "--images", str(tmp_path / "gen"),
            "--data_root", str(data), "--weights_root", str(weights), "--output_root", str(tmp_path / "results")]
    return {"argv": argv, "calls": calls, "out": str(tmp_path / "results" / "MyModel"), "results": results}


@pytest.mark.parametrize("extra", [[], ["--batch_size", "4", "--precision", "fast"]])
def test_runner_builds_the_jax_runners_argv_and_device(stubbed, extra):
    jvalues = jbench.main(stubbed["argv"] + extra)
    tvalues = tbench.main(stubbed["argv"] + extra + ["--device", "cpu"])
    assert tvalues == jvalues == {"FID": 15.01, "IS*": 15.13, "RP": pytest.approx(77.31)}
    jcalls = [(n, a) for p, n, a in stubbed["calls"] if p == "jax"]
    tcalls = [(n, a) for p, n, a in stubbed["calls"] if p == "torch"]
    assert [n for n, _ in tcalls] == [n for n, _ in jcalls] == ["fid", "is_star", "rp"]
    for (name, jargv), (_, targv) in zip(jcalls, tcalls):
        assert targv == jargv + ["--device", "cpu"], name


def test_runner_resume_parses_finished_stages(stubbed):
    """A resumed run parses the stages whose result exists and runs again
    exactly the one whose result is lost and the one whose result does not
    parse; the values stay, and timings.json keeps the earlier wall-clocks."""
    argv = stubbed["argv"] + ["--device", "cpu"]
    first = tbench.main(argv)
    with open(os.path.join(stubbed["out"], "metrics.json")) as f:
        assert json.load(f) == first
    os.remove(os.path.join(stubbed["out"], "rp.txt"))
    with open(os.path.join(stubbed["out"], "fid.txt"), "w") as f:
        f.write("garbage\n")
    stubbed["calls"].clear()
    assert tbench.main(argv + ["--resume"]) == first
    assert sorted(n for _, n, _ in stubbed["calls"]) == ["fid", "rp"]
    with open(os.path.join(stubbed["out"], "timings.json")) as f:
        assert sorted(json.load(f)) == ["fid", "is_star", "rp"]
    stubbed["calls"].clear()
    assert tbench.main(argv + ["--resume"]) == first and stubbed["calls"] == []
    tbench.main(argv + ["--only", "fid,rp", "--skip", "rp"])
    assert [n for _, n, _ in stubbed["calls"]] == ["fid"]


def test_runner_resume_refuses_other_flags(stubbed):
    argv = stubbed["argv"] + ["--device", "cpu", "--only", "fid"]
    tbench.main(argv)
    with pytest.raises(SystemExit, match="resume refused"):
        tbench.main(argv + ["--precision", "fast", "--resume"])
    tbench.main(argv + ["--batch_size", "4", "--resume"])  # the values do not depend on the batch size


def test_runner_goes_on_after_a_failed_stage(tmp_path, capsys):
    """Plan.execute: a stage that raises prints FAIL and the run goes on, a
    stage with a missing input is skipped; with --resume the stages whose
    result exists are parsed and the failed one runs again."""
    order = []

    def stage(name, fail=False, inputs=()):
        result = tmp_path / f"{name}.txt"

        def run():
            order.append(name)
            if fail:
                raise RuntimeError("boom")
            result.write_text("1")
        return tbench.Stage(name, list(inputs), run, lambda: {name: float(result.read_text())}, result=str(result))

    plan = tbench.Plan([stage("a"), stage("b", fail=True), stage("c", inputs=[str(tmp_path / "nowhere")]),
                        stage("d")])
    assert plan.execute(resume=False) == {"a": 1.0, "d": 1.0} and order == ["a", "b", "d"]
    out = capsys.readouterr().out
    assert "[benchmark] FAIL b: RuntimeError: boom" in out and "[benchmark] SKIP c (missing: " in out
    order.clear()
    assert plan.execute(resume=True) == {"a": 1.0, "d": 1.0} and order == ["b"]
    assert sorted(plan.timings) == ["a", "d"]


def test_runner_fails_a_stage_whose_result_has_no_number(stubbed, monkeypatch, capsys):
    """A ``FID: nan`` file is FAIL fid, with a message that names the file."""
    import tise_tpu_torch.metrics.fid as tfid

    monkeypatch.setattr(tfid, "main", lambda a: tio._write(_flag(a, "--saved_file"), "FID: nan"))
    values = tbench.main(stubbed["argv"] + ["--device", "cpu"])
    assert "FID" not in values and set(values) == {"IS*", "RP"}
    fid_txt = os.path.join(stubbed["out"], "fid.txt")
    assert re.search(r"\[benchmark\] FAIL fid: ValueError: " + re.escape(fid_txt) + ".*'FID: nan'",
                     capsys.readouterr().out)


def test_runner_refuses_the_coco_track(tmp_path):
    """The COCO track is refused where there is no card unless ``--device
    cpu`` is asked for, before anything is written; and a ``--resume`` of it
    under another ``--proposals`` than its results were made with is
    refused (the CUB track's refusal under another ``--precision`` is
    test_runner_resume_refuses_other_flags)."""
    argv = ["--track", "coco", "--method_name", "m", "--images", "x", "--output_root", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        tbench.main(argv)
    assert not os.path.exists(tmp_path / "out")
    tbench.main(argv + ["--device", "cpu", "--only", "fid"])
    with pytest.raises(SystemExit, match="resume refused: .*'proposals': \\(1000, 256\\)"):
        tbench.main(argv + ["--device", "cpu", "--only", "fid", "--resume", "--proposals", "256"])


@pytest.fixture(scope="module")
def layout(world, items):
    """The standard --data_root/--weights_root layout over the planted world:
    FID statistics of 2048 dims, the reference-layout FID trunk, slim IS*
    weights, the DAMSM encoders (the image one as the JAX .npz sibling)."""
    root = world["root"] / "layout"
    data, weights = root / "data", root / "weights"

    def put(table, base, key, src=None):
        path = base / table[key]
        os.makedirs(path.parent, exist_ok=True)
        if src is not None:
            os.link(src, path)
        return path

    rng = np.random.RandomState(3)
    a = rng.randn(2048, 32)
    np.savez(put(tbench.DATA, data, "cub_fid_stats"), mu=rng.randn(2048) * 0.1, sigma=a @ a.T / 32 + np.eye(2048))
    put(tbench.DATA, data, "cub_rp_captions", items)
    put(tbench.DATA, data, "cub_captions_pickle", world["vocab"])
    torch.save({k: torch.from_numpy(v) for k, v in inception_state_dict(seed=4).items()},
               put(tbench.WEIGHTS, weights, "inception"))
    np.savez(put(tbench.WEIGHTS, weights, "inception_cub"), **random_slim_vars(seed=0, num_classes=51))
    put(tbench.WEIGHTS, weights, "damsm_text", world["weights"]["text"])
    os.link(world["weights"]["image_npz"],
            os.path.splitext(put(tbench.WEIGHTS, weights, "damsm_image"))[0] + ".npz")
    argv = ["--track", "cub", "--method_name", "rand", "--images", world["images"], "--data_root", str(data),
            "--weights_root", str(weights), "--batch_size", "8"]
    return {"root": root, "argv": argv}


@pytest.fixture(scope="module")
def runner_values(layout):
    return {"jax": jbench.main(layout["argv"] + ["--output_root", str(layout["root"] / "jax")]),
            "torch": tbench.main(layout["argv"] + ["--output_root", str(layout["root"] / "torch"), "--device", "cpu"])}


def test_runner_gives_the_jax_runners_values(runner_values, layout):
    """FID within max(1e-3, 1e-4 |FID|), IS* within 1e-4 relative, RP (planted:
    half the items succeed, in ten unequal bins) equal."""
    got, ref = runner_values["torch"], runner_values["jax"]
    assert set(got) == set(ref) == {"FID", "IS*", "RP"}
    assert all(np.isfinite(v) for v in got.values()), got
    assert abs(got["FID"] - ref["FID"]) <= max(1e-3, 1e-4 * abs(ref["FID"]))
    assert got["IS*"] == pytest.approx(ref["IS*"], rel=1e-4)
    assert got["RP"] == ref["RP"] and 40.0 < got["RP"] < 60.0
    with open(layout["root"] / "torch" / "rand" / "metrics.json") as f:
        assert json.load(f) == got
