"""The port's DAMSM pretraining (tise_tpu_torch.models.damsm_pretrain and the
encoders' trainable routes) against the JAX package's on the CPU, at the
JAX tests' sizes (tests/test_train_infra.py:87-105): embedding 16 (LSTM 8
a direction), 6 words, a vocabulary of 60, 96 px images, batch 3.

Two steps from one state carried across (the port's seeded encoders through
the JAX package's own converters, so no JAX init is compiled), with the
schedule of one step an epoch, so the second step runs at 0.98 lr0: the
losses, the clipped text-encoder gradients (the JAX ones are recovered from
Adam's first moment: 2 mu after one step, 2 mu2 - mu1 after two, b1 = 0.5),
the heads' gradients, the updated parameters and the frozen trunk.  The
first step's text gradient lies under the clip and the second's over it
(|g| > 0.25: the clip bites); f32 differences are refereed by the same
port steps in float64.  Then the
learning-rate schedule, the validation step, the best encoders' ``.npz``
through both packages' loaders, and the CLI: ``--smoke``, a run over a
written layout with its resume, and what it refuses.  The JAX step runs
jitted, once a module.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from tise_tpu.backbones import damsm as jdamsm
from tise_tpu.core import weights as jweights
from tise_tpu.models import damsm_pretrain as jpretrain
from tise_tpu_torch.backbones import damsm
from tise_tpu_torch.models import damsm_pretrain as pretrain
from tise_tpu_torch.models import datasets
from tise_tpu_torch.models import weights as tweights
from tise_tpu_torch.models.attngan_pp.trainer import Batch
from tise_tpu_torch.ops.preprocess import normalize_plain

from test_torch_train import assert_within_rounding
from test_torch_train_loop import write_layout

B, T, NTOKEN, EMB, SIZE = 3, 6, 60, 16, 96
CLIP = 0.25


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def make_batches():
    """Two seeded batches; the second repeats a class (a same-class pair
    masked)."""
    rng = np.random.RandomState(4)
    out = []
    for cls in ([0, 1, 2], [5, 5, 7]):
        images = rng.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8)
        caps = rng.randint(1, NTOKEN, (B, T)).astype(np.int32)
        lens = np.array([6, 4, 2], np.int32)
        caps[np.arange(T)[None, :] >= lens[:, None]] = 0
        out.append((images, caps, lens, np.array(cls, np.int32)))
    return out


@pytest.fixture(scope="module")
def states():
    return {"text": damsm.random_rnn_state_dict(0, NTOKEN, nhidden=EMB // 2),
            "image": damsm.random_cnn_state_dict(0, nef=EMB)}


def _jax_moments(opt_state):
    """(text encoder, heads) first moments of the JAX optimiser's state."""
    rnn_mu = opt_state.inner_states["rnn"].inner_state[1][0].mu["rnn"]
    cnn_mu = opt_state.inner_states["cnn"].inner_state[0].mu["cnn"]
    return jax.device_get(rnn_mu), jax.device_get({k: cnn_mu[k] for k in ("emb_features", "emb_cnn_code")})


def _port_view(rnn_tree, heads_tree):
    """JAX text-encoder and heads trees -> the port's state-dict names."""
    out = damsm.rnn_state_dict_from_jax_params(rnn_tree)
    out["emb_features.weight"] = np.transpose(np.asarray(heads_tree["emb_features"]["kernel"]), (3, 2, 0, 1))
    out["emb_cnn_code.weight"] = np.asarray(heads_tree["emb_cnn_code"]["kernel"]).T
    out["emb_cnn_code.bias"] = np.asarray(heads_tree["emb_cnn_code"]["bias"])
    return out


def _port_params(state: pretrain.DamsmTrainState, what: str):
    """The text encoder's or the heads' parameters by state-dict name."""
    if what == "text":
        return dict(state.text_encoder.named_parameters())
    return {k: p for k, p in state.image_encoder.named_parameters() if k.startswith("emb_")}


@pytest.fixture(scope="module")
def step_pair(states):
    """Two steps of the JAX package and of the port (f32 and float64) from
    the same state and batches, one step an epoch: each step's metrics,
    gradients and parameters."""
    jcfg = jpretrain.DamsmPretrainConfig(ntoken=NTOKEN, embedding_dim=EMB, words_num=T, batch_size=B)
    cfg = pretrain.DamsmPretrainConfig(ntoken=NTOKEN, embedding_dim=EMB, words_num=T, batch_size=B)
    rnn = jdamsm.RNNEncoder(ntoken=NTOKEN, nhidden=EMB // 2)
    cnn = jdamsm.CNNEncoder(nef=EMB)
    tx = jpretrain.make_optimizer(jcfg, jpretrain.make_lr_schedule(jcfg.lr, 1))
    rnn_params = jdamsm.rnn_params_from_torch(states["text"])["params"]
    cnn_params = jdamsm.cnn_params_from_torch(states["image"])["params"]
    jstate = jpretrain.DamsmTrainState(step=jnp.zeros((), jnp.int32), rnn_params=rnn_params, cnn_params=cnn_params,
                                       opt_state=tx.init({"rnn": rnn_params, "cnn": cnn_params}))
    jstep = jax.jit(jpretrain.make_train_step(jcfg, rnn, cnn, tx))
    batches = make_batches()
    out = {"jax": [], "jax_metrics": [], "batches": batches}
    for images, caps, lens, cls in batches:
        x = normalize_plain(t(images), "half").numpy()
        jstate, m = jstep(jstate, x, caps, lens, cls)
        out["jax"].append(jax.device_get(jstate))
        out["jax_metrics"].append({k: float(v) for k, v in m.items()})
    schedule = pretrain.make_lr_schedule(cfg.lr, 1)
    for name, dtype in (("port", torch.float32), ("port64", torch.float64)):
        state = pretrain.init_state(cfg, states["text"], states["image"], device="cpu")
        state.text_encoder.to(dtype)
        state.image_encoder.to(dtype)
        step = pretrain.make_train_step(cfg, schedule)
        runs = []
        for images, caps, lens, cls in batches:
            before = {k: v.detach().clone() for k, v in state.image_encoder.trunk.state_dict().items()}
            m = step(state, images, caps, lens, cls)
            runs.append({"metrics": {k: float(v) for k, v in m.items()},
                         "grads": {k: p.grad.double().numpy().copy() for w in ("text", "heads")
                                   for k, p in _port_params(state, w).items()},
                         "params": {k: p.detach().double().numpy().copy() for w in ("text", "heads")
                                    for k, p in _port_params(state, w).items()},
                         "trunk_kept": all(torch.equal(v, state.image_encoder.trunk.state_dict()[k])
                                           for k, v in before.items()),
                         "lr": [g["lr"] for o in (state.rnn_opt, state.cnn_opt) for g in o.param_groups]})
        out[name] = runs
        out[f"{name}_state"] = state
    return out


def _jax_grads(step_pair, i: int):
    """The JAX gradients of step i (after the clip), by the port's names."""
    mus = [_port_view(*_jax_moments(s.opt_state)) for s in step_pair["jax"][:i + 1]]
    if i == 0:
        return {k: 2.0 * np.asarray(v, np.float64) for k, v in mus[0].items()}
    return {k: 2.0 * np.asarray(mus[1][k], np.float64) - np.asarray(mus[0][k], np.float64) for k in mus[1]}


def test_step_metrics_match_jax(step_pair):
    """Both steps' w_loss, s_loss and loss within 1e-5 relative of JAX's and
    of the float64 port's."""
    for i in range(2):
        got, ref, ref64 = step_pair["port"][i]["metrics"], step_pair["jax_metrics"][i], step_pair["port64"][i]["metrics"]
        assert set(got) == set(ref) == {"w_loss", "s_loss", "loss"}
        for k in ref:
            assert abs(got[k] - ref[k]) <= 1e-5 * max(abs(ref[k]), 1.0), (i, k, got[k], ref[k])
            assert abs(got[k] - ref64[k]) <= 1e-5 * max(abs(ref64[k]), 1.0), (i, k, got[k], ref64[k])


@pytest.mark.parametrize("i", [0, 1])
def test_step_gradients_match_jax(step_pair, i):
    """Every text-encoder and head gradient of each step (after the clip),
    within f32 rounding; the first step's text gradient is below the clip
    and the second's above it, clipped to a global norm of 0.25."""
    ref = _jax_grads(step_pair, i)
    got, got64 = step_pair["port"][i]["grads"], step_pair["port64"][i]["grads"]
    assert set(got) == set(ref)
    for k in got:
        assert_within_rounding(k, got[k], ref[k], got64[k])
    text_norm = np.sqrt(sum(np.sum(np.square(g)) for k, g in got64.items() if not k.startswith("emb_")))
    if i == 0:
        assert text_norm < CLIP, text_norm
    else:
        assert abs(text_norm - CLIP) < 1e-9, text_norm


def test_clip_is_optax_global_norm():
    """``clip_by_global_norm_`` against optax's ``clip_by_global_norm`` on
    the same gradients, above and below the norm (bit for bit below, 1 ulp
    above); it returns the norm before the clip."""
    import optax

    rng = np.random.RandomState(3)
    for scale in (0.01, 10.0):
        grads = [rng.standard_normal(s).astype(np.float32) * scale for s in ((4, 3), (5,), (2, 2, 2))]
        ref, _ = optax.clip_by_global_norm(CLIP).update([jnp.asarray(g) for g in grads], None)
        params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = t(g).clone()
        norm = pretrain.clip_by_global_norm_(params, CLIP)
        assert abs(float(norm) - np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in grads))) < 1e-5 * float(norm)
        for p, r in zip(params, ref):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=2e-7, atol=0)


def test_step_updated_params_match_jax(step_pair):
    """The text encoder's and the heads' parameters after each step within
    1e-6 absolute (a 200th of lr) of JAX's wherever no step's JAX gradient
    so far is within 10x its f32 rounding (or 1e-6) of 0 without being 0 in
    both packages (the embedding rows of absent words), where Adam's step
    may take either sign; most elements are kept.  The trunk is unchanged, and
    the second step ran at 0.98 lr."""
    kept = total = 0
    keep = {}
    for i in range(2):
        js = step_pair["jax"][i]
        ref = _port_view(js.rnn_params, js.cnn_params)
        jg, g, g64 = _jax_grads(step_pair, i), step_pair["port"][i]["grads"], step_pair["port64"][i]["grads"]
        for k, got in step_pair["port"][i]["params"].items():
            rounding = np.maximum(np.abs(g[k] - g64[k]), np.abs(jg[k] - g64[k]))
            near_zero = (np.abs(jg[k]) <= np.maximum(10 * rounding, 1e-6)) & ~((jg[k] == 0) & (g[k] == 0))
            keep[k] = ~near_zero & keep.get(k, True)
            np.testing.assert_allclose(got[keep[k]], np.asarray(ref[k], np.float64)[keep[k]], atol=1e-6, rtol=0,
                                       err_msg=k)
            kept, total = kept + keep[k].sum(), total + keep[k].size
        assert step_pair["port"][i]["trunk_kept"] and step_pair["port64"][i]["trunk_kept"]
        np.testing.assert_array_equal(np.asarray(js.cnn_params["trunk"]["Conv2d_1a_3x3"]["conv"]["kernel"]),
                                      np.asarray(step_pair["jax"][0].cnn_params["trunk"]["Conv2d_1a_3x3"]["conv"]
                                                 ["kernel"]))
        assert step_pair["port"][i]["lr"] == [2e-4 * 0.98 ** i] * 2
    assert kept > 0.9 * total, (kept, total)
    assert step_pair["port_state"].step == int(step_pair["jax"][-1].step) == 2


def test_trunk_holds_no_graph(states):
    """``encode_heads``: the heads' outputs carry a graph, the trunk's
    parameters no gradient and the input none; the values are those of the
    no-grad ``forward``.  ``RNNEncoder.encode`` carries autograd to the
    embedding and leaves the LSTM's mode as it found it."""
    cnn = damsm.CNNEncoder.from_state_dict(states["image"], device="cpu")
    cnn.trunk.requires_grad_(False)
    x = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)).requires_grad_()
    region, code = cnn.encode_heads(x)
    (region.sum() + code.sum()).backward()
    assert x.grad is None and cnn.emb_cnn_code.weight.grad is not None
    assert all(p.grad is None for p in cnn.trunk.parameters())
    with torch.no_grad():
        f_region, f_code = cnn(x)
    assert torch.equal(f_region, region.detach()) and torch.equal(f_code, code.detach())
    rnn = damsm.RNNEncoder.from_state_dict(states["text"], device="cpu")
    words, sent = rnn.encode(torch.tensor([[3, 4, 0]]), [2])
    sent.sum().backward()
    assert rnn.encoder.weight.grad is not None and not rnn.rnn.training


@pytest.mark.parametrize("step", [0, 5, 10, 1139, 5000])
def test_lr_schedule_matches_jax(step):
    """lr at step 0, one epoch (10 steps), past the floor (114 epochs) and
    far past it: 0.98^min(epoch, 114) in float64, within 5e-6 relative of
    the JAX schedule, which raises f32's 0.98 (1.9e-8 above it) to the
    114th power in f32 (2.2e-6 relative at the floor)."""
    ref = float(jpretrain.make_lr_schedule(2e-4, 10)(step))
    got = pretrain.make_lr_schedule(2e-4, 10)(step)
    assert abs(got - ref) <= 5e-6 * ref, (got, ref)
    assert got == pytest.approx(2e-4 * 0.98 ** min(step // 10, 114), rel=1e-12)


def test_eval_step_is_the_train_steps_losses(states):
    """The validation step gives the losses a train step reports for the
    same state and batch (no update between them)."""
    cfg = pretrain.DamsmPretrainConfig(ntoken=NTOKEN, embedding_dim=EMB, words_num=T, batch_size=B)
    state = pretrain.init_state(cfg, states["text"], states["image"], device="cpu")
    batch = make_batches()[1]
    w, s = pretrain.make_eval_step(cfg)(state, *batch)
    m = pretrain.make_train_step(cfg)(state, *batch)
    assert abs(float(w) - float(m["w_loss"])) <= 1e-5 * float(m["w_loss"])
    assert abs(float(s) - float(m["s_loss"])) <= 1e-5 * float(m["s_loss"])


class StubDataset:
    """``len`` and ``batches`` of seeded uint8 batches (the JAX test's stub)."""

    def __init__(self, n: int, seed: int):
        self.n, self.seed = n, seed

    def __len__(self):
        return self.n

    def batches(self, batch_size, shuffle=True, **kw):
        r = np.random.RandomState(self.seed)
        for _ in range(self.n // batch_size):
            yield Batch(images=(r.randint(0, 256, (batch_size, SIZE, SIZE, 3)).astype(np.uint8),),
                        captions=r.randint(1, NTOKEN, (batch_size, T)).astype(np.int32),
                        cap_lens=r.randint(2, T + 1, (batch_size,)).astype(np.int32),
                        class_ids=np.arange(batch_size, dtype=np.int32))


def test_train_writes_best_encoders_both_loaders_read(tmp_path, states):
    """``train`` over a stub dataset, 2 epochs of one step, validation each
    epoch: the best encoders' ``.npz`` hold the trained state in the JAX
    package's layout (the JAX loader gives ``rnn_params_from_torch`` and
    ``cnn_params_from_torch`` of the port's state, with the JAX init's tree
    shapes), the port's loaders give the state back, and only the newest
    snapshot is kept."""
    cfg = pretrain.DamsmPretrainConfig(ntoken=NTOKEN, embedding_dim=EMB, words_num=T, batch_size=2, max_epoch=2,
                                       snapshot_interval=1)
    out = str(tmp_path / "damsm")
    state, records = pretrain.train(cfg, StubDataset(2, 1), out, val_dataset=StubDataset(2, 2), device="cpu",
                                    log_every=1, num_workers=1)
    assert state.step == 2 and [r["steps"] for r in records] == [1, 1]
    assert all(r["valid"]["batches"] == 1 and np.isfinite(r["valid"]["damsm_loss"]) for r in records)
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["epoch_2.pt"]
    text, image = state.encoder_state_dicts()
    # each epoch trains on the same batch, so the second's validation loss is the lower: its encoders are the best
    assert records[1]["valid"]["damsm_loss"] < records[0]["valid"]["damsm_loss"]
    jtext = jweights.load_pytree_npz(os.path.join(out, "best_text_encoder.npz"))
    jimage = jweights.load_pytree_npz(os.path.join(out, "best_image_encoder.npz"))
    for got, ref in ((jtext, jdamsm.rnn_params_from_torch(text)), (jimage, jdamsm.cnn_params_from_torch(image))):
        flat_got, flat_ref = jweights.flatten_pytree(got), jweights.flatten_pytree(ref)
        assert set(flat_got) == set(flat_ref)
        for k in flat_ref:
            np.testing.assert_array_equal(flat_got[k], flat_ref[k], err_msg=k)
    shapes = jax.eval_shape(lambda k: jdamsm.RNNEncoder(ntoken=NTOKEN, nhidden=EMB // 2).init(
        k, jnp.zeros((2, T), jnp.int32), jnp.ones((2,), jnp.int32)), jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: a.shape, shapes) == jax.tree.map(np.shape, jtext)
    for got, ref in ((damsm.load_rnn_state_dict(os.path.join(out, "best_text_encoder.npz")), text),
                     (damsm.load_cnn_state_dict(os.path.join(out, "best_image_encoder.npz")), image)):
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    with open(os.path.join(out, "train_history.log")) as f:
        log = f.read()
    assert log.count("| end epoch") == 2 and "Save best image encoder and text encoder!" in log


def test_damsm_state_dicts_from_jax(step_pair):
    """``weights.damsm_state_dicts_from_jax`` carries the JAX state after two
    steps into the port's encoders; their parameters are the JAX ones."""
    text, image = tweights.damsm_state_dicts_from_jax(step_pair["jax"][-1])
    state = pretrain.init_state(pretrain.DamsmPretrainConfig(ntoken=NTOKEN, embedding_dim=EMB), text, image, "cpu")
    ref = _port_view(step_pair["jax"][-1].rnn_params, step_pair["jax"][-1].cnn_params)
    for w in ("text", "heads"):
        for k, p in _port_params(state, w).items():
            np.testing.assert_array_equal(p.detach().numpy(), ref[k], err_msg=k)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """``damsm_pretrain.main --device cpu`` over a written layout of 2
    training and 2 test images (64 px, batch 2): one epoch with a snapshot,
    then a resume for a second."""
    root = tmp_path_factory.mktemp("pretrain")
    data = write_layout(str(root / "data"), 2, 2, seed=3)
    out = str(root / "out")
    argv = ["--data_dir", data, "--output_dir", out, "--batch_size", "2", "--embedding_dim", str(EMB),
            "--words_num", str(T), "--caps_per_img", "2", "--num_branch", "1", "--snapshot_interval", "1",
            "--device", "cpu"]
    first = pretrain.main(argv + ["--max_epoch", "1"])
    second = pretrain.main(argv + ["--max_epoch", "2"])
    return {"data": data, "out": out, "first": first, "second": second}


def test_cli_pretrains_validates_and_resumes(cli_run):
    """One step an epoch and one validation batch over the test split; the
    resume trains epoch 2 alone from the snapshot's step; the best encoders
    are written and drive ``models.main``'s loaders."""
    first, second = cli_run["first"], cli_run["second"]
    assert [r["epoch"] for r in first] == [1] and [r["epoch"] for r in second] == [2]
    assert all(r["steps"] == 1 and r["valid"]["batches"] == 1 for r in first + second)
    assert all(np.isfinite(v) for r in first + second for v in r["metrics"].values())
    ckpt = os.path.join(cli_run["out"], "checkpoints")
    assert sorted(os.listdir(ckpt)) == ["epoch_2.pt"]
    assert torch.load(os.path.join(ckpt, "epoch_2.pt"), weights_only=False)["step"] == 2
    with open(os.path.join(cli_run["out"], "train_history.log")) as f:
        assert "resumed from epoch 1" in f.read()
    text = damsm.load_rnn_state_dict(os.path.join(cli_run["out"], "best_text_encoder.npz"))
    assert text["encoder.weight"].shape == (datasets.TextImageDataset(cli_run["data"], "train").n_words, 300)


def test_test_split_batches_match_jax(tmp_path):
    """The validation batches: the test split without augmentation in file
    order (shuffle=False) equal the JAX dataset's."""
    from tise_tpu.models import datasets as jdatasets

    root = write_layout(str(tmp_path / "data"), 4, 6, seed=8)
    kw = dict(base_size=64, branch_num=1, words_num=T, captions_per_image=2, seed=5, augment=False)
    jb = list(jdatasets.TextImageDataset(root, "test", **kw).batches(3, shuffle=False))
    tb = list(datasets.TextImageDataset(root, "test", **kw).batches(3, shuffle=False, num_workers=2))
    assert len(jb) == len(tb) == 2
    for j, b in zip(jb, tb):
        np.testing.assert_array_equal(b.images[-1], np.round((j.images[-1] + 1.0) * 127.5).astype(np.uint8))
        for name in ("captions", "cap_lens", "class_ids"):
            np.testing.assert_array_equal(getattr(b, name), getattr(j, name), err_msg=name)


def test_smoke_cli_and_refusals(capsys):
    """``--smoke --device cpu`` prints finite losses; without ``--device cpu``
    and with no card the CLI raises, the smoke too."""
    pretrain.main(["--smoke", "--device", "cpu"])
    printed = eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == {"w_loss", "s_loss", "loss"} and all(np.isfinite(v) for v in printed.values())
    if torch.cuda.is_available():
        pytest.skip("shows what happens without a CUDA device; one is present")
    for argv in (["--smoke"], ["--data_dir", "nowhere"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            pretrain.main(argv)
