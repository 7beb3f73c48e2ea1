"""The port's multi-process layer (tise_tpu_torch.parallel) and its ten metric
CLIs on a real two-rank CPU gloo cluster.

``shard_items`` and ``merge_moments`` are held to the JAX package's
functions (the JAX process index and count monkeypatched), and
``psum_moments`` to the JAX one under ``jax.pmap`` over two of the suite's
virtual CPU devices.  Then one cluster of two worker processes
(tests/torch_multihost_worker.py), started once for the module, runs what
tests/multihost_worker.py runs for the JAX package (the extractor's shard
and allgather over 9 images, a float64 payload, an empty shard, and legacy
``drop_last`` on the global list, with a cheap stand-in forward) and then
all ten CLIs' ``main``s in sequence with ``--coordinator``, while this
process runs each CLI once alone.  Every result file, SOA pickle and crop
must equal the one-process run's, byte for byte.

The CLI inputs are those of the ``test_torch_<cli>`` files at their sizes
and widths (full-width ViT-B/32, DAMSM, InceptionV3 and the counter with
seeded weights; the stub detector of test_torch_soa.py).  The ranks see
other batches than one process, so the RP, PA and RP-CUB items and PA's
caption pairs are planted from the port's own scores, every decision clear
of ``TOL``, as those files plant them from JAX's; InceptionV3's batches are
padded to one shape, so FID, IS* and O-IS see the same bits.
"""

import contextlib
import io
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from tests.test_torch_ca import make_ca_world
from tests.test_torch_clip import WORDS, write_merge_table
from tests.test_torch_fid import _write_folder
from tests.test_torch_rp_cub import _caption_pool
from tests.test_torch_soa import LABELS, StubDetector, read_folder, write_images
from tests.tf_slim_ref import random_slim_vars
from tests.torch_multihost_worker import cheap_forward
from tise_tpu.core import config as jconfig
from tise_tpu.ops import stats as jstats
from tise_tpu.parallel import multihost as jmultihost
from tise_tpu_torch.backbones import clip_vit, counter, damsm
from tise_tpu_torch.backbones.clip_tokenizer import SimpleTokenizer
from tise_tpu_torch.backbones.inception_v3 import random_state_dict
from tise_tpu_torch.core import config as tconfig
from tise_tpu_torch.core import io as tio
from tise_tpu_torch.core.data import ImageFolderLoader, center_crop_resize, list_images, load_image
from tise_tpu_torch.metrics import crop_objects, extractor, rp_coco, rp_cub, soa
from tise_tpu_torch.metrics.clip_scorer import ClipPairScorer
from tise_tpu_torch.ops import stats
from tise_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TOL = 1e-4  # of a score's scale: how far the ranks' scores may move from one process's
CLUSTER_TIMEOUT = 600  # s, from the wait for a cluster to the end of its last process
RESULT_CLIS = ("fid", "o_fid", "is_star", "o_is", "rp_coco", "pa", "rp_cub", "ca")


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# a cluster of worker processes
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_cluster(script: str, folder: str, world: int = WORLD) -> list:
    """``world`` processes of ``tests/<script> RANK WORLD PORT FOLDER``, each
    on one thread, their output in ``FOLDER/rank<RANK>.log``."""
    port = str(free_port())
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    procs = []
    for rank in range(world):
        log = open(os.path.join(folder, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, os.path.join(REPO, "tests", script), str(rank), str(world),
                                        port, folder], cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT),
                      log))
    return procs


def finish_cluster(procs: list, folder: str, timeout: float = CLUSTER_TIMEOUT) -> None:
    """Wait for every process; kill them all as soon as one fails or when
    ``timeout`` has passed since this call, and fail with their logs."""
    deadline, failed = time.monotonic() + timeout, None
    try:
        while failed is None and any(proc.poll() is None for proc, _ in procs):
            failed = next((f"rank {r} exited with {proc.returncode}" for r, (proc, _) in enumerate(procs)
                           if proc.poll() not in (None, 0)), None)
            if time.monotonic() > deadline:
                failed = f"the cluster did not end within {timeout} s"
            time.sleep(0.2)
        failed = failed or next((f"rank {r} exited with {proc.returncode}" for r, (proc, _) in enumerate(procs)
                                 if proc.returncode != 0), None)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        logs = "".join(open(os.path.join(folder, f"rank{r}.log")).read()[-4000:] for r in range(len(procs)))
        pytest.fail(f"{failed}\n{logs}")


# ---------------------------------------------------------------------------
# function by function against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,world", [(0, 2), (1, 2), (9, 2), (10, 3), (6, 1)])
def test_shard_items_equals_jax(n, world, monkeypatch):
    items = [f"item{i}" for i in range(n)]
    for p in range(world):
        monkeypatch.setattr(jmultihost, "process_index", lambda p=p: p)
        monkeypatch.setattr(jmultihost, "process_count", lambda: world)
        monkeypatch.setattr(multihost, "process_index", lambda p=p: p)
        monkeypatch.setattr(multihost, "process_count", lambda: world)
        got, ref = multihost.shard_items(items), jmultihost.shard_items(items)
        assert got[0] == ref[0] and got[1].dtype == ref[1].dtype
        np.testing.assert_array_equal(got[1], ref[1])


def test_one_process_allgather_only_scatters():
    out = multihost.allgather_rows(np.asarray([[1.0, 2.0], [3.0, 4.0]]), np.asarray([2, 0]), 3)
    np.testing.assert_array_equal(out, [[3.0, 4.0], [0.0, 0.0], [1.0, 2.0]])
    assert not multihost.is_distributed() and multihost.shard_items(list("abc"))[0] == list("abc")


def _moments(seed: int):
    """A seeded port ``MomentState`` (the worker's ``seeded_moments``) and
    the same arrays as the JAX package's."""
    acts = np.random.RandomState(seed).standard_normal((5, 6)).astype(np.float32)
    port = stats.update_moments(stats.init_moments(6, device="cpu"), torch.from_numpy(acts))
    return port, jstats.MomentState(*(jnp.asarray(t.numpy()) for t in port))


def test_merge_moments_equals_jax():
    (a, ja), (b, jb) = _moments(0), _moments(1)
    got, ref = stats.merge_moments(a, b), jstats.merge_moments(ja, jb)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_distributed_flags_match_jax():
    """The flags and their defaults are the JAX CLIs'; without
    ``--coordinator`` nothing joins a cluster."""
    import argparse

    parsers = []
    for add in (jconfig.add_distributed_flags, tconfig.add_distributed_flags):
        p = argparse.ArgumentParser()
        add(p)
        parsers.append(p)
    for flag in ("--coordinator", "--num-processes", "--process-id"):
        got, ref = (next(a for a in p._actions if flag in a.option_strings) for p in parsers[::-1])
        assert (got.default, got.type, got.dest) == (ref.default, ref.type, ref.dest), flag
    args = parsers[1].parse_args([])
    tconfig.maybe_init_distributed(args)
    assert not torch.distributed.is_initialized() and not hasattr(args, "device")


def test_snapshots_are_refused_across_processes(monkeypatch):
    """A snapshot is one process's: the resumable extractor and every item
    loop with a snapshot file refuse a multi-process run."""
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError):
        extractor.run_resumable(lambda: None, ["x.png"], batch_size=1, image_size=8, snapshot_path="s.npz")
    with pytest.raises(NotImplementedError):
        rp_coco.score_items([], [], None, None, snapshot_path="s.npz")
    with pytest.raises(NotImplementedError):
        rp_cub.score_items([], "", None, {}, snapshot_path="s.npz")


# ---------------------------------------------------------------------------
# the inputs of the ten CLIs, and the plan the ranks run
# ---------------------------------------------------------------------------


def _plant_clip(root, pool_tokens, pool, images, scorer):
    """RP items (12, K = 100) and a PA pickle (2 phrases x 5 items) planted
    from the port's bank logits, as tests/test_torch_clip_cli.py plants them
    from JAX's."""
    u8 = np.stack([center_crop_resize(os.path.join(images, f"{i}.png"), 224) for i in range(12)])
    bank = scorer.encode_text_bank(pool_tokens)
    lg = scorer.logits_from_bank(u8, bank, np.tile(np.arange(len(pool), dtype=np.int32), (12, 1)))
    tol = TOL * float(np.abs(lg).max())
    rng = np.random.RandomState(1)
    items = []
    for i in range(12):
        order = np.argsort(-lg[i])
        for _ in range(50):
            gt = order[0] if i % 2 == 0 else order[rng.randint(6, len(pool))]
            mism = rng.choice([j for j in range(len(pool)) if j != gt], 99)
            if abs(lg[i][gt] - lg[i][mism].max()) > 2 * tol:
                break
        assert abs(lg[i][gt] - lg[i][mism].max()) > 2 * tol, i
        items.append({"caption_id": i, "caption": pool[gt], "mismatched_captions": [pool[j] for j in mism]})
    threshold = np.log(0.6 / 0.4)  # P(gt) > 0.6 <=> logit difference > log 1.5
    pa_data = {}
    for p, phrase in enumerate(("left", "under")):
        os.makedirs(os.path.join(images, phrase))
        pa_data[phrase] = []
        for j in range(5):
            i = 5 * p + j
            order = np.argsort(-lg[i])
            for _ in range(50):
                c, f = (order[0], order[-1]) if j % 2 == 0 else tuple(rng.choice(len(pool), 2, replace=False))
                if abs(lg[i][c] - lg[i][f] - threshold) > 2 * tol:
                    break
            assert abs(lg[i][c] - lg[i][f] - threshold) > 2 * tol, (phrase, j)
            shutil.copy(os.path.join(images, f"{i}.png"), os.path.join(images, phrase, f"{j}.png"))
            pa_data[phrase].append({"caption_id": j, "caption": pool[c], "false_caption": pool[f]})
    paths = {"rp": str(root / "rp.pkl"), "pa": str(root / "pa.pkl")}
    tio.save_pickle(paths["rp"], items)
    tio.save_pickle(paths["pa"], pa_data)
    return paths, len(set(c for it in items for c in [it["caption"], *it["mismatched_captions"]]))


def _clip_inputs(root):
    folder = root / "clip"
    images = folder / "images"
    images.mkdir(parents=True)
    rng = np.random.RandomState(0)
    pool = []
    while len(pool) < 40:
        cap = " ".join(rng.choice(WORDS, rng.randint(3, 10)))
        if cap not in pool:
            pool.append(cap)
    for i in range(12):  # 256x320 and 320x256 blocks of colour: the resize and the crop both act
        h, w = (256, 320) if i % 2 else (320, 256)
        arr = np.kron(rng.randint(0, 256, (h // 32, w // 32, 3)), np.ones((32, 32, 1))).astype(np.uint8)
        Image.fromarray(arr).save(str(images / f"{i}.png"))
    bpe = write_merge_table(folder / "bpe.txt", WORDS)
    sd = clip_vit.random_state_dict(seed=0)
    weights = str(folder / "clip.npz")
    np.savez(weights, **sd)
    scorer = ClipPairScorer(sd, "cpu")
    paths, n_unique = _plant_clip(folder, SimpleTokenizer(bpe).tokenize(pool), pool, str(images), scorer)
    return {"images": str(images), "bpe": bpe, "weights": weights, "n_unique": n_unique, **paths}


def _rp_cub_inputs(root):
    """24 blocky PNGs, the vocabulary pickle, full-width DAMSM encoders as
    ``.pth`` and 24 items planted from the port's cosines, as
    tests/test_torch_rp_cub.py plants them from JAX's."""
    folder = root / "rp_cub"
    images = folder / "images"
    images.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(24):
        arr = np.kron(rng.randint(0, 256, (4, 4, 3)), np.ones((16, 16, 1))).astype(np.uint8)
        Image.fromarray(arr).save(str(images / f"{i}.png"))
    ntoken = 5450
    ixtoword = {0: "<end>", **{i: f"w{i}" for i in range(1, ntoken)}}
    vocab = str(folder / "captions.pickle")
    tio.save_pickle(vocab, [[], [], ixtoword, {w: i for i, w in ixtoword.items()}])
    rnn_sd, cnn_sd = damsm.random_rnn_state_dict(seed=1, ntoken=ntoken), damsm.random_cnn_state_dict(seed=2)
    paths = {"text": str(folder / "text_encoder200.pth"), "image": str(folder / "image_encoder200.pth")}
    for key, sd in (("text", rnn_sd), ("image", cnn_sd)):
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, paths[key])
    pool = _caption_pool(rng)
    scorer = rp_cub.DamsmScorer(rnn_sd, cnn_sd, "cpu")
    caps, lens = rp_cub.pack_caption_sets(
        [[rp_cub.tokenize_caption(c, {w: i for i, w in ixtoword.items()}) for c in pool]], rp_cub.MAX_LEN)
    u8 = np.stack([load_image(str(images / f"{i}.png"), (256, 256)) for i in range(24)])
    with torch.inference_mode():
        code = scorer.image_codes(torch.from_numpy(u8)).double().numpy()
        sent = scorer.sentence_codes(torch.from_numpy(caps[0]).long(), lens[0]).double().numpy()
    cos = code @ sent.T / (np.linalg.norm(code, axis=1)[:, None] * np.linalg.norm(sent, axis=1)[None])
    rng, items = np.random.RandomState(1), []
    for i in range(24):
        order = np.argsort(-cos[i])
        for _ in range(50):
            gt = order[0] if i % 2 == 0 else order[rng.randint(6, len(pool))]
            mism = rng.choice([j for j in range(len(pool)) if j != gt], 99)
            if abs(cos[i, gt] - cos[i, mism].max()) > 2 * TOL:
                break
        assert abs(cos[i, gt] - cos[i, mism].max()) > 2 * TOL, i
        items.append({"caption_id": i, "caption": pool[gt], "mismatched_captions": [pool[j] for j in mism]})
    pkl = str(folder / "CUB_RP_captions.pkl")
    tio.save_pickle(pkl, items)
    return {"images": str(images), "vocab": vocab, "items": pkl, **paths}


def _plan(root) -> dict:
    """Every CLI's argv, with ``{rank}`` where a process writes a file of
    its own (``one`` for the one-process run) and ``{run}`` where the
    processes of a run share a folder (``one`` or ``dist``)."""
    images9 = root / "images9"
    images9.mkdir()
    rng = np.random.RandomState(0)
    for i in range(9):  # odd: the padded tail batch on both paths
        Image.fromarray(rng.randint(0, 256, (16, 16, 3)).astype(np.uint8)).save(str(images9 / f"{i}.png"))
    a = _write_folder(root / "a", 12, seed=1, block=16)
    b = _write_folder(root / "b", 12, seed=2, block=4)
    inception, w80, slim = str(root / "inception.pth"), str(root / "w80.pth"), str(root / "slim.npz")
    for path, seed, classes in ((inception, 0, 10), (w80, 2, 80)):
        torch.save({k: torch.from_numpy(v) for k, v in random_state_dict(seed=seed, num_classes=classes).items()},
                   path)
    np.savez(slim, **random_slim_vars(seed=0, num_classes=51))
    clip = _clip_inputs(root)
    cub = _rp_cub_inputs(root)
    (root / "ca").mkdir()
    ca = make_ca_world(root / "ca", counter.random_countseg_state_dict(0))
    write_images(str(root / "src"), 11, seed=0)
    for j, label in enumerate(LABELS):
        write_images(str(root / "labels" / f"label_{label:02d}_{label:02d}"), 3 + j % 3, seed=10 + j)
    for run in ("one", "0", "1"):
        (root / f"out_{run}").mkdir()
    out = str(root / "out_{rank}")
    cpu = ["--device", "cpu"]
    clip_common = ["--image_dir", clip["images"], "--weights", clip["weights"], "--bpe_path", clip["bpe"],
                   "--batch_size", "8"]
    clis = [
        ("fid", "tise_tpu_torch.metrics.fid", ["--path1", a, "--path2", b, "--weights", inception, "--sqrtm", "eigh",
                                               "--batch-size", "4", "--saved_file", f"{out}/fid.txt"]),
        ("o_fid", "tise_tpu_torch.metrics.o_fid", ["--path1", a, "--path2", b, "--weights", w80, "--sqrtm", "eigh",
                                                   "--batch-size", "4", "--saved_file", f"{out}/o_fid.txt"]),
        ("is_star", "tise_tpu_torch.metrics.is_star", ["--image_folder", a, "--flavor", "cub", "--weights", slim,
                                                       "--batch_size", "5", "--splits", "2", "--seed", "1",
                                                       "--saved_file", f"{out}/is_star.txt"]),
        ("o_is", "tise_tpu_torch.metrics.o_is", ["--image_dir", a, "--weights", w80, "--batch_size", "5",
                                                 "--saved_file", f"{out}/o_is.txt"]),
        ("rp_coco", "tise_tpu_torch.metrics.rp_coco", [*clip_common, "--rp_input_file", clip["rp"],
                                                       "--saved_file_path", f"{out}/rp_coco.txt"]),
        ("pa", "tise_tpu_torch.metrics.pa", [*clip_common, "--pa_input_file", clip["pa"],
                                             "--saved_file_path", f"{out}/pa.txt"]),
        ("rp_cub", "tise_tpu_torch.metrics.rp_cub", ["--image_dir", cub["images"], "--rp_input_file", cub["items"],
                                                     "--captions_pickle", cub["vocab"], "--text_encoder", cub["text"],
                                                     "--image_encoder", cub["image"], "--batch_size", "8",
                                                     "--saved_file_path", f"{out}/rp_cub.txt"]),
        ("ca", "tise_tpu_torch.metrics.ca", ["--image_dir", ca["images"], "--ct_input_file", ca["pkl"],
                                             "--weights", ca["weights"], "--batch_size", "4",
                                             "--result_file", f"{out}/ca.txt"]),
        ("crop_objects", "tise_tpu_torch.metrics.crop_objects", ["--source_image_dir", str(root / "src"),
                                                                 "--saved_cropped_object_dir",
                                                                 str(root / "crops_{run}")]),
        ("soa", "tise_tpu_torch.metrics.soa", ["--images", str(root / "labels"), "--detected_results",
                                               str(root / "det_{run}"), "--saved_file", f"{out}/soa.txt"]),
    ]
    return {"images9": str(images9), "clis": [(n, m, [*argv, *cpu]) for n, m, argv in clis],
            "n_unique": clip["n_unique"]}


def _run_one_process(plan: dict, root) -> dict:
    """Each CLI alone in this process: {cli: printed text}, and the rows of
    the text banks RP-COCO encoded."""
    import importlib

    logs, banks, encode = {}, [], ClipPairScorer.encode_text_bank

    def recording_bank(self, tokens, **kw):
        banks.append(len(tokens))
        return encode(self, tokens, **kw)

    with mock.patch.object(crop_objects, "build_detector", lambda args: StubDetector()), \
            mock.patch.object(soa, "build_detector", lambda args: StubDetector()), \
            mock.patch.object(ClipPairScorer, "encode_text_bank", recording_bank):
        for name, module, argv in plan["clis"]:
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                importlib.import_module(module).main([a.replace("{rank}", "one").replace("{run}", "one")
                                                      for a in argv])
            logs[name] = text.getvalue()
    return {"logs": logs, "banks": banks}


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """The plan's inputs; the two-rank cluster runs it while this process
    runs each CLI alone and the extractor's one-process oracles."""
    root = tmp_path_factory.mktemp("multihost")
    plan = _plan(root)
    with open(root / "plan.json", "w") as f:
        json.dump(plan, f)
    procs = start_cluster("torch_multihost_worker.py", str(root))
    try:
        one = _run_one_process(plan, root)
        ext = extractor.BatchedExtractor(cheap_forward, recipe="fid", device="cpu")
        one["feat"] = ext.run(ImageFolderLoader.from_dir(plan["images9"], 4, 16))["feat"]
        one["files"] = list_images(plan["images9"])
    finally:
        finish_cluster(procs, str(root))
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in range(WORLD)]
    return {"root": root, "plan": plan, "one": one, "ranks": ranks}


# ---------------------------------------------------------------------------
# the two-rank cluster
# ---------------------------------------------------------------------------


def test_extraction_odd_count_matches_one_process(cluster):
    """9 images over 2 ranks at batch 4: each rank pads its tail batch, and
    the gathered rows are the one-process rows bit for bit, on both ranks."""
    for got in cluster["ranks"]:
        np.testing.assert_array_equal(got["feat"], cluster["one"]["feat"])
        np.testing.assert_array_equal(got["lens"], [float(len(p)) for p in cluster["one"]["files"]])


def test_allgather_keeps_float64_and_int64_bits(cluster):
    for got in cluster["ranks"]:
        assert got["pi"].dtype == np.float64 and got["ids"].dtype == np.int64
        np.testing.assert_array_equal(got["pi"], np.arange(9, dtype=np.float64) + np.pi)
        np.testing.assert_array_equal(got["ids"], np.arange(9, dtype=np.int64) * 2 ** 40 + 7)


def test_empty_shard_enters_the_gathers(cluster):
    """One file over two ranks: rank 1's shard is empty, and its dummy
    forward keeps it in the same allgathers (the cluster would hang)."""
    for got in cluster["ranks"]:
        np.testing.assert_array_equal(got["feat_one"], cluster["one"]["feat"][:1])


def test_legacy_drop_last_acts_on_the_global_list(cluster):
    """drop_last at batch 4 keeps the first 8 of the 9 global files, not
    the first 4 of each rank's shard."""
    for got in cluster["ranks"]:
        np.testing.assert_array_equal(got["feat_drop"], cluster["one"]["feat"][:8])


def test_psum_moments_equals_jax_psum(cluster):
    """The two ranks' seeded moments summed by ``psum_moments`` over gloo,
    against ``jax.lax.psum`` of the JAX package's ``psum_moments`` over two
    virtual CPU devices."""
    states = [_moments(r)[1] for r in range(WORLD)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    ref = jax.pmap(lambda s: jstats.psum_moments(s, "i"), axis_name="i", devices=jax.devices()[:WORLD])(stacked)
    for got in cluster["ranks"]:
        for field in stats.MomentState._fields:
            np.testing.assert_array_equal(got[f"psum_{field}"], np.asarray(getattr(ref, field))[0], err_msg=field)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("cli", RESULT_CLIS)
def test_cli_result_file_equals_one_process(cluster, cli):
    """Each rank's result file is the one-process run's, byte for byte."""
    root = cluster["root"]
    want = _read(root / "out_one" / f"{cli}.txt")
    assert want.strip()
    for rank in range(WORLD):
        assert _read(root / f"out_{rank}" / f"{cli}.txt") == want, (cli, rank)


def test_rp_coco_bank_is_replicated(cluster):
    """Each rank encodes the bank of every item's captions, as one process
    does, not of its own shard's."""
    for rank in range(WORLD):
        with open(cluster["root"] / f"rank{rank}" / "banks.json") as f:
            assert json.load(f) == cluster["one"]["banks"] == [cluster["plan"]["n_unique"]]


def _expected_crop_names(one_names, files, world):
    """The one-process crops renamed by the strided rule: rank p runs files
    p::world and numbers its crops p, p + world, ..."""
    rank_of = {os.path.basename(f).split(".")[0]: i % world for i, f in enumerate(files)}
    count = list(range(world))
    out = {}
    for name in sorted(one_names, key=lambda n: int(n.rsplit("_", 1)[1][:-4])):
        head = name.rsplit("_", 1)[0]
        rank = rank_of[next(s for s in rank_of if head.startswith(s + "_"))]
        out[name] = f"{head}_{count[rank]}.png"
        count[rank] += world
    return out


def test_crops_equal_one_process_under_the_strided_index(cluster):
    """The shared crop folder holds the one-process crops, pixel for pixel,
    under the JAX CLI's multi-process names; no sentinel is left; both ranks
    print the allgathered total."""
    root = cluster["root"]
    one, dist = read_folder(root / "crops_one"), read_folder(root / "crops_dist")
    assert one and sorted(os.listdir(root / "crops_dist")) == sorted(dist)
    names = _expected_crop_names(one, sorted(os.listdir(root / "src")), WORLD)
    assert sorted(dist) == sorted(names.values())
    for name, renamed in names.items():
        np.testing.assert_array_equal(dist[renamed], one[name], err_msg=name)
    wrote = f"wrote {len(one)} crops to "
    assert wrote in cluster["one"]["logs"]["crop_objects"]
    for rank in range(WORLD):
        assert wrote in (root / f"rank{rank}" / "crop_objects.log").read_text()


def test_soa_pickles_and_result_equal_one_process(cluster):
    """The ranks split the label folders: every per-label pickle equals the
    one-process run's, byte for byte; only rank 0 writes the result file
    (equal to the one-process file) and ``result_file.pkl`` (the same dict:
    its order is the listing order of the folder)."""
    root = cluster["root"]
    one, dist = root / "det_one", root / "det_dist"
    pickles = sorted(f for f in os.listdir(one) if f.startswith("detected_"))
    assert len(pickles) == len(LABELS) and sorted(f for f in os.listdir(dist) if f.startswith("detected_")) == pickles
    for name in pickles:
        assert _read(dist / name) == _read(one / name), name
    with open(one / "result_file.pkl", "rb") as f, open(dist / "result_file.pkl", "rb") as g:
        assert pickle.load(g) == pickle.load(f)
    assert _read(root / "out_0" / "soa.txt") == _read(root / "out_one" / "soa.txt")
    assert not os.path.exists(root / "out_1" / "soa.txt")
