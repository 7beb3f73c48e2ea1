"""The port's training data, loop and CLI (tise_tpu_torch.models.{datasets,main,
sampling}, models.attngan_pp.train_loop) on the CPU.

The dataset's batches against the JAX package's on layouts the tests write
in the reference's format (a flat layout whose vocabulary is built from
``text/*.txt``, and a ``birds`` layout with CUB's bounding boxes), with and
without augmentation; ``models.main`` with ``--device cpu`` for two epochs
of one step, then a resume for a third; the snapshot's ``.npz`` through the
port's generate CLI and strict load; the loop's logs; the sampling helpers;
and what the CLI refuses.
"""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from tise_tpu.models import datasets as jdatasets
from tise_tpu_torch.backbones import damsm
from tise_tpu_torch.metrics.rp_cub import DamsmScorer
from tise_tpu_torch.models import datasets, generate, main as train_main, sampling
from tise_tpu_torch.models import weights as tweights
from tise_tpu_torch.models.attngan_pp import train_loop, trainer
from tise_tpu_torch.models.attngan_pp.generator import GanConfig

WORDS = ["a", "bird", "with", "red", "wings", "and", "short", "beak", "sits", "on", "branch", "small", "yellow",
         "belly", "the", "long", "tail", "white"]
TINY = ["--gf_dim", "8", "--df_dim", "8", "--z_dim", "8", "--condition_dim", "8", "--text_emb_dim", "16",
        "--words_num", "6", "--caps_per_img", "2", "--batch_size", "4", "--num_workers", "2"]


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


def write_layout(root: str, n_train: int, n_test: int, seed: int, birds: bool = False) -> str:
    """The reference's layout: ``<split>/filenames.pickle``,
    ``<split>/class_info.pickle``, ``text/<key>.txt`` (two captions an image,
    some longer than 6 words), JPEGs of about 300 px, and for ``birds``
    CUB_200_2011's images.txt and bounding_boxes.txt."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "text"))
    image_dir = os.path.join(root, "CUB_200_2011", "images") if birds else root
    os.makedirs(image_dir, exist_ok=True)
    names = {"train": [f"k{i:02d}" for i in range(n_train)], "test": [f"t{i:02d}" for i in range(n_test)]}
    rows = []
    for split, keys in names.items():
        os.makedirs(os.path.join(root, split))
        with open(os.path.join(root, split, "filenames.pickle"), "wb") as f:
            pickle.dump(keys, f)
        with open(os.path.join(root, split, "class_info.pickle"), "wb") as f:
            pickle.dump([1 + i % 3 for i in range(len(keys))], f)
        for key in keys:
            w, h = rng.randint(280, 330, 2)
            arr = (rng.rand(h // 8, w // 8, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).resize((w, h), Image.BILINEAR).save(os.path.join(image_dir, f"{key}.jpg"))
            rows.append((f"{key}.jpg", rng.randint(0, w // 3), rng.randint(0, h // 3), w // 2, h // 2))
            with open(os.path.join(root, "text", f"{key}.txt"), "w") as f:
                f.write("\n".join(" ".join(rng.choice(WORDS, rng.randint(2, 10))) + "." for _ in range(2)) + "\n")
    if birds:
        with open(os.path.join(root, "CUB_200_2011", "images.txt"), "w") as f:
            f.write("".join(f"{i + 1} {r[0]}\n" for i, r in enumerate(rows)))
        with open(os.path.join(root, "CUB_200_2011", "bounding_boxes.txt"), "w") as f:
            f.write("".join(f"{i + 1} {r[1]}.0 {r[2]}.0 {r[3]}.0 {r[4]}.0\n" for i, r in enumerate(rows)))
    return root


@pytest.mark.parametrize("augment,workers", [(False, 3), (True, 1)])
@pytest.mark.parametrize("kind", ["flat", "birds"])
def test_batches_match_jax(tmp_path, kind, augment, workers):
    """The port's batches equal the JAX dataset's: the uint8 images (JAX's
    x / 127.5 - 1 brought back), captions, lengths and class ids of every
    batch, and the vocabulary the first one builds from the text files and
    caches (the port reads JAX's cache).  Augmentation draws from the shared
    rng inside the decode threads, so it is compared with one worker."""
    root = write_layout(str(tmp_path / kind), 12, 2, seed=len(kind), birds=kind == "birds")
    kw = dict(base_size=64, branch_num=3, words_num=6, captions_per_image=2, seed=5, augment=augment)
    jds = jdatasets.TextImageDataset(root, "train", **kw)
    tds = datasets.TextImageDataset(root, "train", **kw)
    assert (tds.ixtoword, tds.wordtoix, tds.captions) == (jds.ixtoword, jds.wordtoix, jds.captions)
    assert (tds.bbox is not None) == (kind == "birds") and tds.bbox == jds.bbox
    jb, tb = list(jds.batches(4, num_workers=workers)), list(tds.batches(4, num_workers=workers))
    assert len(jb) == len(tb) == 3
    for j, b in zip(jb, tb):
        for ji, ti in zip(j.images, b.images):
            assert ti.dtype == np.uint8
            np.testing.assert_array_equal(ti, np.round((ji + 1.0) * 127.5).astype(np.uint8))
        for name in ("captions", "cap_lens", "class_ids"):
            np.testing.assert_array_equal(getattr(b, name), getattr(j, name), err_msg=name)
    assert max(int(b.cap_lens.max()) for b in tb) == 6  # an overlong caption was subsampled


def test_mis_captions_match_jax(tmp_path):
    """The 99 mismatched captions of train-time R-precision."""
    root = write_layout(str(tmp_path / "flat"), 12, 2, seed=9)
    jds = jdatasets.TextImageDataset(root, "train", words_num=6, captions_per_image=2, seed=2)
    tds = datasets.TextImageDataset(root, "train", words_num=6, captions_per_image=2, seed=2)
    for cls in (1, 2):
        for a, b in zip(tds.get_mis_captions(cls), jds.get_mis_captions(cls)):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``models.main --device cpu`` over 4 training images at batch 4 with
    one residual block a stage: two epochs with a snapshot each, then a
    resume for a third."""
    root = tmp_path_factory.mktemp("train")
    data = write_layout(str(root / "data"), 4, 3, seed=1)
    datasets.TextImageDataset(data, "train", words_num=6, captions_per_image=2)  # writes captions.pickle
    ntoken = len(pickle.load(open(os.path.join(data, "captions.pickle"), "rb"))[2])
    text, image = str(root / "text_encoder.pth"), str(root / "image_encoder.pth")
    torch.save({k: torch.from_numpy(v) for k, v in damsm.random_rnn_state_dict(0, ntoken, nhidden=8).items()}, text)
    torch.save({k: torch.from_numpy(v) for k, v in damsm.random_cnn_state_dict(0, nef=16).items()}, image)
    out = str(root / "out")
    argv = ["--data_dir", data, "--output_dir", out, "--net_e", text, "--image_encoder", image,
            "--snapshot_interval", "1", "--num_residual", "1", "--device", "cpu", *TINY]
    train_main.main(argv + ["--max_epoch", "2"])
    after_two = sorted(os.listdir(os.path.join(out, "checkpoints")))
    state2 = torch.load(os.path.join(out, "checkpoints", "epoch_2.pt"), weights_only=False)
    train_main.main(argv + ["--max_epoch", "3"])
    return {"data": data, "out": out, "text": text, "image": image, "after_two": after_two, "state2": state2,
            "ntoken": ntoken}


def test_main_trains_snapshots_and_resumes(trained):
    """One snapshot kept (the newest, .pt and .npz); the resume starts from
    epoch 2 with its step count and Adam state, and the third epoch moves
    G; the log says so."""
    ckpt = os.path.join(trained["out"], "checkpoints")
    assert trained["after_two"] == ["epoch_2.npz", "epoch_2.pt"]
    assert sorted(os.listdir(ckpt)) == ["epoch_3.npz", "epoch_3.pt"]
    s2, s3 = trained["state2"], torch.load(os.path.join(ckpt, "epoch_3.pt"), weights_only=False)
    assert (s2["step"], s3["step"]) == (2, 3)
    assert s3["g_opt"]["state"][0]["step"] == 3 and s3["d_opt"][64]["state"][0]["step"] == 3
    assert not torch.equal(s2["g"]["h_net1.fc.weight"], s3["g"]["h_net1.fc.weight"])
    with open(os.path.join(trained["out"], "train_history.log")) as f:
        log = f.read()
    assert "resumed from epoch 2" in log and log.count("saved snapshot") == 3


def test_snapshot_npz_is_the_ema_generator(trained):
    """The .npz holds the EMA parameters and G's running statistics; the
    port's generate CLI reads it (strict load, R_NUM 1 read from the .npz,
    with no flag for it) and writes images."""
    npz = os.path.join(trained["out"], "checkpoints", "epoch_3.npz")
    s3 = torch.load(os.path.join(trained["out"], "checkpoints", "epoch_3.pt"), weights_only=False)
    gan = GanConfig(gf_dim=8, z_dim=8, condition_dim=8, embedding_dim=16, words_num=6, r_num=1)
    g_state, _ = generate.load_generator_from_checkpoint(npz, trained["text"], gan, trained["ntoken"], "attngan_pp")
    for k, v in s3["g_ema"].items():
        np.testing.assert_array_equal(g_state[k], v.numpy(), err_msg=k)
    for k in ("h_net1.fc_bn.running_var", "h_net3.up.bn.running_mean"):
        np.testing.assert_array_equal(g_state[k], s3["g"][k].numpy(), err_msg=k)
    tweights.load_generator(g_state, gan, device="cpu")
    assert generate.checkpoint_gan(dataclasses.replace(gan, r_num=2), g_state) == gan
    caps = os.path.join(trained["out"], "caps.pkl")
    with open(caps, "wb") as f:
        pickle.dump([{"caption_id": i, "caption": "a bird with red wings"} for i in range(3)], f)
    gen_dir = os.path.join(trained["out"], "gen")
    generate.main(["--caption_file", caps, "--output_dir", gen_dir, "--checkpoint", npz, "--text_encoder",
                   trained["text"], "--captions_pickle", os.path.join(trained["data"], "captions.pickle"),
                   "--gf_dim", "8", "--z_dim", "8", "--condition_dim", "8", "--embedding_dim", "16",
                   "--words_num", "6", "--batch_size", "2", "--device", "cpu"])
    assert sorted(os.listdir(gen_dir)) == ["0.png", "1.png", "2.png"]


def test_sampling_helpers(trained):
    """sample_test_split writes one image a test item from the snapshot's
    generator; train_time_r_precision ranks them with the DAMSM encoders
    (a value in [0, 1])."""
    npz = os.path.join(trained["out"], "checkpoints", "epoch_3.npz")
    gan = GanConfig(gf_dim=8, z_dim=8, condition_dim=8, embedding_dim=16, words_num=6, r_num=1)
    g_state, text_state = generate.load_generator_from_checkpoint(npz, trained["text"], gan, trained["ntoken"],
                                                                  "attngan_pp")
    gen = generate.CaptionGenerator(g_state, text_state, gan=gan, device="cpu")
    test = datasets.TextImageDataset(trained["data"], "test", words_num=6, captions_per_image=2, seed=1)
    out = os.path.join(trained["out"], "samples")
    assert sampling.sample_test_split(test, gen, out, batch_size=2) == 3
    assert sorted(os.listdir(out)) == ["0.png", "1.png", "2.png"]
    scorer = DamsmScorer(damsm.load_rnn_state_dict(trained["text"]), damsm.load_cnn_state_dict(trained["image"]),
                         device="cpu")
    rp = sampling.train_time_r_precision(test, out, scorer, batch_size=2)
    assert 0.0 <= rp <= 1.0


def test_train_loop_logs_the_jax_keys(tmp_path):
    """``train`` with log_every 1 writes a scalars.jsonl line a step with
    the JAX loop's keys and a train_history.log line with its losses; one
    branch (64 px), so the DAMSM term reads the 64 px fakes."""
    data = write_layout(str(tmp_path / "data"), 4, 0, seed=4)
    ds = datasets.TextImageDataset(data, "train", branch_num=1, words_num=6, captions_per_image=2, seed=0)
    cfg = trainer.TrainConfig(gan=GanConfig(gf_dim=8, df_dim=8, z_dim=8, condition_dim=8, embedding_dim=16,
                                            words_num=6, branch_num=1),
                              batch_size=4, ntoken=ds.n_words, max_epoch=1, snapshot_interval=5)
    state, records = train_loop.train(cfg, ds, str(tmp_path / "out"), device="cpu", log_every=1, num_workers=1)
    assert state.step == 1 and [r["steps"] for r in records] == [1]
    with open(tmp_path / "out" / "scalars.jsonl") as f:
        line = json.loads(f.readline())
    assert set(line) == {"step", "g_loss", "d_loss", "w_loss", "s_loss", "kl_loss", "d64_loss"}
    assert all(np.isfinite(v) for v in line.values())
    with open(tmp_path / "out" / "train_history.log") as f:
        assert "epoch 1 iter 1 D_loss:" in f.read()
    assert sorted(os.listdir(tmp_path / "out" / "checkpoints")) == ["epoch_1.npz", "epoch_1.pt"]


def test_main_refuses(tmp_path):
    """``--train false`` says where generation lives; without a card,
    ``models.main`` raises unless ``--device cpu`` is given."""
    argv = ["--data_dir", str(tmp_path), "--net_e", "x.pth", "--image_encoder", "y.pth"]
    with pytest.raises(SystemExit, match="models.generate"):
        train_main.main(argv + ["--train", "false", "--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("shows what happens without a CUDA device; one is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_main.main(argv)
