"""The port's image-generation CLIs (tise_tpu_torch.models.{generate,
gen_example}) against the JAX package's on the CPU, at tiny widths (gf_dim
8, embedding 32, z and condition 16, 8 words; R_NUM 2, the only value the
CLIs express).

Both packages read one shared world: a generator ``.npz`` in the JAX
trainer's layout (``g_ema``, ``g_batch_stats``; seeded weights with
perturbed BatchNorm, written by ``save_generator_npz``), a DAMSM text encoder ``.npz`` and a captions pickle.  The
port's ``generate.draw_noise`` is replaced by JAX's own draws (``z`` and
CA's ``eps`` from ``split(fold_in(PRNGKey(seed), step))``), so the two
CLIs can be held image for image: the same file names, and pixels at most
1 level apart in under 0.1% of the values (the uint8 cast truncates, so an
ulp at a boundary is one level).  Each JAX CLI runs once, in a module
fixture.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from tise_tpu.backbones import damsm as jdamsm
from tise_tpu.core import weights as jweights
from tise_tpu.models import gen_example as jgen_example
from tise_tpu.models import generate as jgenerate
from tise_tpu_torch.backbones import damsm as tdamsm
from tise_tpu_torch.models import gen_example as tgen_example
from tise_tpu_torch.models import generate as tgenerate
from tise_tpu_torch.models import weights as tweights
from tise_tpu_torch.models.attngan_pp.generator import GanConfig

DIMS = {"gf_dim": 8, "z_dim": 16, "condition_dim": 16, "embedding_dim": 32, "words_num": 8}
NTOKEN = 40
CFG = GanConfig(**DIMS)
WORDS = ["<end>"] + [f"w{i}" for i in range(1, NTOKEN)]


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


def perturbed_state(state, seed):
    """BatchNorm scale 1 + N(0, 0.1), shift and mean N(0, 0.1), var x U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)
    bns = {k.rsplit(".", 1)[0] for k in state if k.endswith(".running_mean")}
    out = dict(state)
    for key, v in state.items():
        prefix, leaf = key.rsplit(".", 1)
        if prefix in bns and leaf != "num_batches_tracked":
            noise = rng.uniform(0.5, 1.5, v.shape) * v if leaf == "running_var" else v + rng.normal(0, 0.1, v.shape)
            out[key] = noise.astype(np.float32)
    return out


def jax_draws(seed, step, batch, z_dim, condition_dim, device):
    """The JAX CLIs' noise (generate.py:55-61, gen_example.py:78-84)."""
    r_z, r_ca = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), step))
    z, eps = jax.random.normal(r_z, (batch, z_dim)), jax.random.normal(r_ca, (batch, condition_dim))
    return torch.from_numpy(np.array(z)).to(device), torch.from_numpy(np.array(eps)).to(device)


def _caption(rng, n):
    return " ".join(WORDS[i] for i in rng.randint(1, NTOKEN, n))


def _items(rng, prefix, n):
    out = [{"caption_id": f"{prefix}{i}", "caption": _caption(rng, rng.randint(3, 12))} for i in range(n)]
    out[-1]["caption"] = "nothing known here"  # no word of the vocabulary: token 0, length 1
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen")
    rng = np.random.RandomState(0)
    paths = {}
    for model in ("attngan_pp", "counter_model"):
        paths[model] = str(root / f"{model}.npz")
        tweights.save_generator_npz(paths[model], perturbed_state(tweights.random_g_state_dict(3, CFG, model), 5))
    text = str(root / "text_encoder.npz")
    jweights.save_pytree_npz(text, jdamsm.rnn_params_from_torch(
        tdamsm.random_rnn_state_dict(0, NTOKEN, nhidden=DIMS["embedding_dim"] // 2)))
    vocab = str(root / "captions.pickle")
    with open(vocab, "wb") as f:
        pickle.dump([[], [], dict(enumerate(WORDS)), {w: i for i, w in enumerate(WORDS)}], f)
    captions = {"flat": _items(rng, "c", 5),
                "soa": {"label_00_00": _items(rng, "s", 3), "label_07_07": _items(rng, "t", 2)},
                "pa": {"left": _items(rng, "l", 3), "right": _items(rng, "r", 2)}}
    for mode, data in captions.items():
        with open(root / f"{mode}.pkl", "wb") as f:
            pickle.dump(data, f)
    examples = root / "examples"
    examples.mkdir()
    (examples / "example_filenames.txt").write_text("one\nsub/two\n")
    (examples / "one.txt").write_text("\n".join(_caption(rng, n) for n in (4, 9, 2)) + "\n")
    os.makedirs(examples / "sub")
    (examples / "sub" / "two.txt").write_text(_caption(rng, 12) + "\n\nzzz qqq\n" + _caption(rng, 6) + "\n")
    common = ["--text_encoder", text, "--captions_pickle", vocab] + sum(
        ([f"--{k}", str(v)] for k, v in DIMS.items()), [])
    return {"root": root, "checkpoints": paths, "common": common}


def generate_argv(world, mode, out, model="attngan_pp"):
    return ["--caption_file", str(world["root"] / f"{mode}.pkl"), "--output_dir", str(out), "--mode", mode,
            "--model", model, "--checkpoint", world["checkpoints"][model], "--batch_size", "2",
            "--images_per_caption", "2"] + world["common"]


def example_argv(world, out):
    return ["--data_dir", str(world["root"] / "examples"), "--output_dir", str(out),
            "--checkpoint", world["checkpoints"]["attngan_pp"]] + world["common"]


CASES = [("flat", "attngan_pp"), ("flat", "counter_model"), ("soa", "attngan_pp"), ("pa", "attngan_pp"),
         ("example", "attngan_pp")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def jax_run(request, world):
    """One JAX CLI run a case."""
    mode, model = request.param
    out = world["root"] / f"jax_{mode}_{model}"
    if mode == "example":
        jgen_example.main(example_argv(world, out))
    else:
        jgenerate.main(generate_argv(world, mode, out, model))
    return {"mode": mode, "model": model, "out": out}


def read_tree(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            with Image.open(os.path.join(dirpath, name)) as im:
                out[os.path.relpath(os.path.join(dirpath, name), root)] = np.asarray(im)
    return out


def run_port(world, mode, model, out, monkeypatch=None, seed=None):
    if monkeypatch is not None:
        monkeypatch.setattr(tgenerate, "draw_noise", jax_draws)
    extra = ["--device", "cpu"] + (["--seed", str(seed)] if seed is not None else [])
    if mode == "example":
        tgen_example.main(example_argv(world, out) + extra)
    else:
        tgenerate.main(generate_argv(world, mode, out, model) + extra)
    return read_tree(out)


def test_cli_matches_jax(jax_run, world, tmp_path, monkeypatch, capsys):
    """The same files (names by mode: generate.py:1-13, gen_example.py:1-20)
    and pixels within 1 level in under 0.1% of the values."""
    got = run_port(world, jax_run["mode"], jax_run["model"], tmp_path / "port", monkeypatch)
    want = read_tree(jax_run["out"])
    assert sorted(got) == sorted(want)
    expected = {"flat": {f"c{i}.png" for i in range(5)},
                "soa": {f"label_00_00/s{i}_{k}.png" for i in range(3) for k in range(2)}
                | {f"label_07_07/t{i}_{k}.png" for i in range(2) for k in range(2)},
                "pa": {f"left/l{i}.png" for i in range(3)} | {f"right/r{i}.png" for i in range(2)},
                "example": {f"{key}/0_s_{i}_{s}.png" for key, n in (("one", 3), ("two", 2)) for i in range(n)
                            for s in ("g0", "g1", "g2", "attn")}}[jax_run["mode"]]
    assert set(got) == expected
    off = total = 0
    for name in want:
        assert got[name].shape == want[name].shape and got[name].dtype == np.uint8, name
        diff = np.abs(got[name].astype(np.int16) - want[name].astype(np.int16))
        assert diff.max() <= 1, name
        off, total = off + int((diff > 0).sum()), total + diff.size
    assert off < 1e-3 * total, (off, total)
    sizes = {a.shape[0] for n, a in got.items() if "attn" not in n}
    assert sizes == ({64, 128, 256} if jax_run["mode"] == "example" else {256})
    n = len(got) - (len(got) // 4 if jax_run["mode"] == "example" else 0)
    assert f"wrote {n} images to" in capsys.readouterr().out


def test_own_draws_repeat_under_a_seed_and_change_with_it(world, tmp_path):
    a = run_port(world, "flat", "attngan_pp", tmp_path / "a", seed=7)
    b = run_port(world, "flat", "attngan_pp", tmp_path / "b", seed=7)
    c = run_port(world, "flat", "attngan_pp", tmp_path / "c", seed=8)
    assert sorted(a) == sorted(b) == sorted(c)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert all(not np.array_equal(a[k], c[k]) for k in a)


def test_draw_noise_rows_do_not_depend_on_the_batch():
    """The full static batch is drawn a step; a step's draws repeat."""
    z, eps = tgenerate.draw_noise(3, 5, 4, 16, 8, "cpu")
    z2, eps2 = tgenerate.draw_noise(3, 5, 4, 16, 8, "cpu")
    z3, _ = tgenerate.draw_noise(3, 6, 4, 16, 8, "cpu")
    assert z.shape == (4, 16) and eps.shape == (4, 8)
    assert torch.equal(z, z2) and torch.equal(eps, eps2) and not torch.equal(z, z3)


def test_orbax_checkpoint_raises(world, tmp_path):
    orbax_dir = tmp_path / "checkpoint_100"
    orbax_dir.mkdir()
    argv = generate_argv(world, "flat", tmp_path / "out") + ["--device", "cpu"]
    argv[argv.index("--checkpoint") + 1] = str(orbax_dir)
    with pytest.raises(ValueError, match=r"\.npz.*Orbax"):
        tgenerate.main(argv)


def test_text_encoder_of_another_vocabulary_raises(world, tmp_path):
    text = str(tmp_path / "text.pth")
    torch.save({k: torch.from_numpy(v) for k, v in tdamsm.random_rnn_state_dict(0, NTOKEN + 1, nhidden=16).items()},
               text)
    argv = generate_argv(world, "flat", tmp_path / "out") + ["--device", "cpu"]
    argv[argv.index("--text_encoder") + 1] = text
    with pytest.raises(ValueError, match="41 words"):
        tgenerate.main(argv)


def test_cli_without_device_raises_where_there_is_no_card(world, tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="--device cpu"):
        tgenerate.main(generate_argv(world, "flat", tmp_path / "out"))
