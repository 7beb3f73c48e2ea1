"""The port's CounterModel training (tise_tpu_torch.models.counter_model.
{discriminator,trainer}, through models.main and the training loop) against
the JAX package's on the CPU, at the JAX tests' ``tiny_cfg``: gf 8, df 8,
z 8, condition 8, embedding 16, 6 words, vocabulary 50, lambda 5, batch 3
in the step.

Modules: ``minibatch_stddev``, ``multiscale_reals`` and ``MSGDNet`` (the
port's seeded weights through the JAX module by the inverse converter:
features, logits and the u the trunk stores) on images whose three channels
differ, so a wrong channel order in a concatenation or a kernel shows.
Then one whole step against the JAX step from one ``CounterTrainState``
carried across by ``weights.train_state_dicts_from_jax(state,
"counter_model")``, with JAX's z and eps: the metrics, G's and D's
gradients (2 x Adam's first moment after one step, b1 = 0.5), the stored
u, G's running statistics, the EMA's change and the updated parameters;
f32 differences refereed by the port's step in float64.  Then the CLIs on
the CPU: ``models.main --model counter_model`` on a written layout with its
resume, the generate CLI on the EMA snapshot, the trainer's ``--smoke``,
and what they refuse without a card.  The JAX step runs jitted, once a
module.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

from tise_tpu.backbones import damsm as jdamsm
from tise_tpu.models.attngan_pp.generator import GanConfig as JGanConfig
from tise_tpu.models.attngan_pp import trainer as jgan_trainer
from tise_tpu.models.counter_model import discriminator as jdisc
from tise_tpu.models.counter_model import trainer as jtrainer
from tise_tpu_torch.backbones import damsm
from tise_tpu_torch.models import datasets, generate, main as train_main
from tise_tpu_torch.models import weights as tweights
from tise_tpu_torch.models.attngan_pp.generator import GanConfig
from tise_tpu_torch.models.attngan_pp.layers import SpectralConv
from tise_tpu_torch.models.attngan_pp.trainer import TrainConfig, synthetic_batch
from tise_tpu_torch.models.counter_model import discriminator, trainer
from tise_tpu_torch.ops.preprocess import normalize_plain

from test_torch_train import assert_within_rounding, rel_err
from test_torch_train_loop import TINY, write_layout

B, T, NTOKEN, NDF, NEF = 3, 6, 50, 8, 16
GAN = dict(gf_dim=8, df_dim=NDF, z_dim=8, condition_dim=8, embedding_dim=NEF, words_num=T)


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


def nchw(a) -> torch.Tensor:
    return t(np.transpose(np.asarray(a), (0, 3, 1, 2)))


def distinct_channel_images(rng: np.random.RandomState, b: int = 2):
    """Seven NHWC images 4 .. 256 px in [-1, 1] whose channels differ in
    scale and offset (R about +0.5, G about 0, B about -0.5)."""
    shift = np.array([0.5, 0.0, -0.5], np.float32)
    scale = np.array([0.3, 0.6, 0.2], np.float32)
    return [(rng.standard_normal((b, s, s, 3)) * scale + shift).astype(np.float32) for s in trainer.SCALES]


def test_minibatch_stddev_matches_jax():
    """The appended channel within 1e-6 of JAX's: last, equal everywhere."""
    x = np.random.RandomState(0).standard_normal((4, 8, 8, 3)).astype(np.float32)
    ref = np.asarray(jdisc.minibatch_stddev(jnp.asarray(x)))
    got = discriminator.minibatch_stddev(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (4, 8, 8, 4)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[..., :3], x)


def test_multiscale_reals_matches_jax():
    """Seven scales, coarsest first, within 1e-6 of the JAX chain."""
    x = np.random.RandomState(1).uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
    ref = jtrainer.multiscale_reals(jnp.asarray(x))
    got = trainer.multiscale_reals(nchw(x))
    assert [g.shape[2] for g in got] == list(trainer.SCALES)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r), atol=1e-6, rtol=0)


def test_msg_dnet_matches_jax():
    """The port's seeded MSG D through the JAX ``MSGDNet`` (the inverse
    converter, and back bit for bit; the JAX init's tree shapes): features,
    cond and uncond logits within 1e-4 relative on images of distinct
    channels, and the u every trunk conv stores within 1e-5 (the heads'
    unchanged).  The same D with its images' channels reversed gives other
    features: the order is seen."""
    rng = np.random.RandomState(2)
    images = distinct_channel_images(rng)
    c = rng.standard_normal((2, NEF)).astype(np.float32)
    jd = jdisc.MSGDNet(ndf=NDF, nef=NEF)
    state = tweights.random_msg_d_state_dict(7, NDF, NEF)
    jparams, jspectral = tweights.jax_params_from_d_state_dict(state)
    v = {"params": jparams, "spectral": jspectral}

    @jax.jit
    def run(v):
        h, mut = jd.apply(v, images, method=jd.features, mutable=["spectral"])
        cond = jd.apply(v, h, c, method=jd.cond_logits, mutable=["spectral"])[0]
        return h, mut, cond, jd.apply(v, h, method=jd.uncond_logits, mutable=["spectral"])[0]

    h, mut, cond, uncond = run(v)
    back = tweights.d_state_dict_from_jax_params(jparams, jspectral)
    assert set(back) == set(state) and all(np.array_equal(back[k], state[k]) for k in state)
    shapes = jax.eval_shape(lambda k: jd.init(k, images, c), jax.random.PRNGKey(0))
    for name, tree in (("params", jparams), ("spectral", jspectral)):
        assert jax.tree.map(lambda a: a.shape, shapes[name]) == jax.tree.map(np.shape, tree), name
    d = discriminator.MSGDNet(NDF, NEF)
    d.load_state_dict({k: t(a) for k, a in state.items()}, strict=True)
    with torch.no_grad():
        th = d.features([nchw(x) for x in images], update_stats=True)
        tc, tu = d.cond_logits(th, t(c)), d.uncond_logits(th)
        flipped = d.features([nchw(x[..., ::-1]) for x in images])
    assert rel_err(th.permute(0, 2, 3, 1), h) < 1e-4
    assert rel_err(tc, cond) < 1e-4 and rel_err(tu, uncond) < 1e-4
    assert rel_err(flipped.permute(0, 2, 3, 1), h) > 1e-2
    d.commit_spectral()
    stored = tweights.d_state_dict_from_jax_params(v["params"], mut["spectral"])
    for k, a in d.state_dict().items():
        if k.endswith(".u"):
            ref = state[k] if k.startswith(("cond_head", "uncond_head")) else stored[k]
            assert rel_err(a, ref) < 1e-5, k


# ---------------------------------------------------------------------------
# one whole train step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def encoder_states():
    return {"text": damsm.random_rnn_state_dict(0, NTOKEN, nhidden=NEF // 2),
            "image": damsm.random_cnn_state_dict(0, nef=NEF)}


def to_dtype(models: trainer.CounterModels, dtype: torch.dtype) -> trainer.CounterModels:
    return trainer.CounterModels(*(m.to(dtype) for m in models))


#: a tensor of fewer elements takes the spread of its gradient's sum as the
#: floor of its rounding: one or a few elements say little of how far f32 moves them
FEW_ELEMENTS = 16


def record_term_squares(module: torch.nn.Module) -> dict:
    """For each parameter of ``module`` with fewer than ``FEW_ELEMENTS``
    elements (the biases of its dense, convolution and spectral-convolution
    layers, and the weights of its dense layers), the sum of the squares of
    the terms that its gradient sums, filled in as the step's backward runs:
    a bias's gradient sums the upstream gradient over every batch row and
    pixel, a dense weight's the products of upstream gradient and input over
    the rows.  Calls whose parameters take no gradient (the D inside the G
    update) add nothing."""
    squares = {}

    def add(name: str, value: torch.Tensor) -> None:
        squares[name] = squares.get(name, 0.0) + value.detach()

    def few(p) -> bool:
        return p is not None and p.requires_grad and p.numel() < FEW_ELEMENTS

    def hook(prefix: str, mod: torch.nn.Module, inputs, output) -> None:
        if not output.requires_grad or not (few(mod.bias) or few(mod.weight)):
            return
        x = inputs[0].detach()

        def on_grad(g: torch.Tensor) -> None:
            g2 = g.detach() ** 2
            if isinstance(mod, torch.nn.Linear):
                rows = g2.reshape(-1, g2.shape[-1])
                if few(mod.bias):
                    add(f"{prefix}bias", rows.sum(dim=0))
                if few(mod.weight):
                    add(f"{prefix}weight", rows.t() @ (x ** 2).reshape(-1, x.shape[-1]))
            elif few(mod.bias):
                add(f"{prefix}bias", g2.sum(dim=(0, 2, 3)))

        output.register_hook(on_grad)

    for name, mod in module.named_modules():
        if isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d, SpectralConv)):
            mod.register_forward_hook(lambda m, i, o, prefix=f"{name}.": hook(prefix, m, i, o))
    return squares


@pytest.fixture(scope="module")
def step_pair(encoder_states):
    """One step of the JAX trainer and of the port from the same state,
    batch and noise (JAX's z and eps), and the port's step in float64 with
    ``record_term_squares`` on its G and D.  The
    JAX state is the port's seeded weights carried across by the inverse
    converters (Adam at zero, the EMA a copy of G), so no JAX init is
    compiled; the port's state comes back from it through
    ``train_state_dicts_from_jax``."""
    jcfg = jgan_trainer.TrainConfig(gan=JGanConfig(**GAN), batch_size=B, ntoken=NTOKEN,
                                    damsm=jtrainer.default_config().damsm)
    cfg = TrainConfig(gan=GanConfig(**GAN), batch_size=B, ntoken=NTOKEN, damsm=trainer.default_config().damsm)
    assert cfg.damsm.lam == jcfg.damsm.lam == 5.0
    g_params, g_stats = tweights.jax_params_from_g_state_dict(
        tweights.random_g_state_dict(0, cfg.gan, "counter_model"))
    d_params, d_spectral = tweights.jax_params_from_d_state_dict(tweights.random_msg_d_state_dict(1, NDF, NEF))
    adam = optax.adam(jcfg.g_lr, b1=jcfg.beta1, b2=jcfg.beta2)
    jstate = jtrainer.CounterTrainState(
        step=jnp.zeros((), jnp.int32), g_params=g_params, g_batch_stats=g_stats, g_opt=adam.init(g_params),
        g_ema=jax.tree.map(np.copy, g_params), d_params=d_params, d_spectral=d_spectral, d_opt=adam.init(d_params))
    enc = {"text": jdamsm.rnn_params_from_torch(encoder_states["text"]),
           "image": jdamsm.cnn_params_from_torch(encoder_states["image"])}
    batch = synthetic_batch(cfg, np.random.RandomState(0), B)
    batch = batch._replace(class_ids=np.array([3, 7, 3], np.int32))  # one same-class pair
    jbatch = jgan_trainer.Batch(images=tuple(normalize_plain(t(im), "half").numpy() for im in batch.images),
                                captions=batch.captions, cap_lens=batch.cap_lens, class_ids=batch.class_ids)
    rng = jax.random.PRNGKey(1)
    step = jax.jit(jtrainer.make_train_step(jcfg, jtrainer.build_models(jcfg)))
    jnew, jmetrics = step(jstate, jbatch, enc, rng)
    rng_ca, rng_z = jax.random.split(jax.random.fold_in(rng, 0))
    z = np.asarray(jax.random.normal(rng_z, (B, GAN["z_dim"])))
    eps = np.asarray(jax.random.normal(rng_ca, (B, GAN["condition_dim"])))

    dicts = tweights.train_state_dicts_from_jax(jax.device_get(jstate), "counter_model")
    out = {"jax": jax.device_get(jnew), "jax_metrics": {k: float(v) for k, v in jmetrics.items()}, "dicts": dicts}
    for name, dtype in (("state", torch.float32), ("state64", torch.float64)):
        models = to_dtype(trainer.build_models(cfg, encoder_states["text"], encoder_states["image"], "cpu"), dtype)
        state = trainer.init_state(cfg, models, dicts=dicts)
        if dtype == torch.float64:
            out["terms64"] = {"g": record_term_squares(models.gnet), "d": record_term_squares(models.dnet)}
        metrics = trainer.make_train_step(cfg, models)(state, batch, t(z).to(dtype), t(eps).to(dtype))
        out[name], out[name.replace("state", "metrics")] = state, {k: float(v) for k, v in metrics.items()}
    return out


def test_step_metrics_match_jax(step_pair):
    """Every loss of the step within 1e-4 relative of JAX's and of the
    float64 port's (the DAMSM terms, at lambda 5, go through InceptionV3)."""
    got, ref, ref64 = step_pair["metrics"], step_pair["jax_metrics"], step_pair["metrics64"]
    assert set(got) == set(ref) == set(ref64) == {"d_loss", "g_loss", "w_loss", "s_loss", "kl_loss"}
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-4 * max(abs(ref[k]), 1.0), (k, got[k], ref[k])
        assert abs(got[k] - ref64[k]) <= 1e-4 * max(abs(ref64[k]), 1.0), (k, got[k], ref64[k])


def _grads(step_pair, which: str):
    """(port, JAX, port float64) gradients of G or D by state-dict name; the
    JAX ones 2 x Adam's first moment after its first step."""
    jax_state = step_pair["jax"]
    if which == "g":
        mu = jax_state.g_opt[0].mu
        ref = tweights.g_state_dict_from_jax_params(jax.tree.map(lambda m: 2.0 * np.asarray(m), mu), {},
                                                    "counter_model")
        mods = (step_pair["state"].gnet, step_pair["state64"].gnet)
    else:
        mu = jax_state.d_opt[0].mu
        ref = tweights.d_state_dict_from_jax_params(jax.tree.map(lambda m: 2.0 * np.asarray(m), mu), {})
        mods = (step_pair["state"].dnet, step_pair["state64"].dnet)
    # the 4 px image's head reaches no loss (the D reads 8 .. 256 px): no gradient, JAX's is 0
    got, got64 = ({k: np.zeros(p.shape) if p.grad is None else p.grad.numpy() for k, p in m.named_parameters()}
                  for m in mods)
    return got, ref, got64


def flat(d: dict, keys) -> np.ndarray:
    return np.concatenate([np.ravel(d[k]) for k in keys]).astype(np.float64)


def module_rounding(got: dict, got64: dict) -> float:
    """The port's f32 rounding of a module's gradient as a whole: the L2
    distance of all its f32 gradients to the float64 ones, over their norm."""
    keys = sorted(got64)
    return float(np.linalg.norm(flat(got, keys) - flat(got64, keys)) / np.linalg.norm(flat(got64, keys)))


@pytest.mark.parametrize("which", ["g", "d"])
def test_step_gradients_match_jax(step_pair, which):
    """Every G and D parameter's gradient within f32 rounding as
    ``assert_within_rounding`` measures it (the D losses see the detached
    fakes; G's reach it through the updated D and InceptionV3), and the
    module's gradient as a whole the same way.

    Where G's f32 rounding comes from: the DAMSM terms' gradient through the
    random-weight InceptionV3 (the adversarial and KL terms move G's by
    2.5e-5 and 2e-7 under f32, the DAMSM terms by 1.9%).  f32 rounding
    switches a few ReLUs and max-pool winners against float64, and each
    switch moves the input gradient by about one part in the square root of
    the layer's size; in both packages alike: over six random inputs the
    encoder's f32 input gradient was 1.07-1.36% (port) and 0.89-1.35% (JAX)
    from float64.  Which package lands nearer in one step is chance: here
    1.9% (port) against 0.86% (JAX) with torch on one thread, 1.0% against
    0.86% on two.  So a tensor's own distance to float64 is its spread.

    A tensor of fewer than ``FEW_ELEMENTS`` elements takes a floor that
    covers how its sum rounds: each of the terms its gradient sums moves by
    about the module's rounding r under f32, so the sum moves by about r
    times the root of the terms' sum of squares (the port's float64 terms,
    ``record_term_squares``), and by no less than r times its value.  A
    response gate's one-element bias sums 3 x 128 x 128 terms of both signs
    whose magnitudes add to some 6,000 times the sum: f32 moves it by 10-30%
    in either package (by 18% in the port against 13% in JAX on one host, by
    28% in JAX on another).  The module's own rounding is printed."""
    got, ref, got64 = _grads(step_pair, which)
    assert set(got) == set(got64) and set(got) <= set(ref)
    rounding = module_rounding(got, got64)
    print(f"{which}: the port's f32 gradient is {rounding:.2e} (L2) from float64")
    squares = step_pair["terms64"][which]
    for k in got:
        if got[k].size < FEW_ELEMENTS:
            terms = np.sqrt(squares[k].numpy())  # a few-element tensor without recorded terms raises here
            floor = rounding * max(float(np.linalg.norm(terms)), float(np.linalg.norm(got64[k])))
            print(f"{k}: port {got[k].ravel()[:2]}, JAX {ref[k].ravel()[:2]}, float64 {got64[k].ravel()[:2]}, "
                  f"floor {floor:.3e}")
            assert_within_rounding(k, got[k], ref[k], got64[k], abs_floor=floor)
        else:
            assert_within_rounding(k, got[k], ref[k], got64[k])
    keys = sorted(got64)
    assert_within_rounding(which, flat(got, keys), flat(ref, keys), flat(got64, keys))


def test_step_stored_u_matches_jax(step_pair):
    """D's u after the step within 1e-5: the trunk's from the real pass,
    the heads' unchanged."""
    ref = tweights.d_state_dict_from_jax_params({}, step_pair["jax"].d_spectral)
    before = step_pair["dicts"].d
    for k, a in step_pair["state"].dnet.state_dict().items():
        if k.endswith(".u"):
            np.testing.assert_allclose(a.numpy(), ref[k], atol=1e-5, rtol=0, err_msg=k)
            moved = not np.allclose(before[k], ref[k], atol=1e-5)
            assert moved != k.startswith(("cond_head", "uncond_head")), k


def test_step_g_batch_stats_match_jax(step_pair):
    """G's running statistics after the step within 1e-4 of each tensor's
    largest element (Flax's biased variance)."""
    ref = tweights.g_state_dict_from_jax_params({}, step_pair["jax"].g_batch_stats, "counter_model")
    got = step_pair["state"].gnet.state_dict()
    keys = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert keys and all(k in got for k in keys)
    for k in keys:
        assert rel_err(got[k], ref[k]) < 1e-4, k


def _kept(got_g, ref_g, got64_g) -> np.ndarray:
    """The elements whose JAX gradient jg is more than 5x its f32 rounding r
    (the larger of its port and JAX gradients' distances to float64) and
    2e-6 from 0.  Then the port's g has jg's sign, |g - jg| <= 2r < 0.4
    |jg| and |g| > 0.6 |jg|, so a first Adam step (lr g / (|g| + 1e-8))
    moves the two packages apart by at most lr 1e-8 |g - jg| / (|g| |jg|)
    < 0.67 lr 1e-8 / 2e-6 = 6.7e-7; nearer 0 the step may take either sign
    or move with its rounding."""
    rounding = np.maximum(np.abs(got_g - got64_g), np.abs(ref_g - got64_g))
    return np.abs(ref_g) > np.maximum(5 * rounding, 2e-6)


def test_step_ema_matches_jax(step_pair):
    """The EMA's change over the step (0.001 x lr x sign(g), about 2e-7: its
    value alone cannot tell an updated EMA from one left as it was) against
    JAX's change, within 2% of it plus two f32 spacings of the EMA's value,
    on the elements whose JAX gradient is not near 0; most move by more than
    20 spacings."""
    ema0, g_grads = step_pair["dicts"].g_ema, _grads(step_pair, "g")
    ref = tweights.g_state_dict_from_jax_params(step_pair["jax"].g_ema, {}, "counter_model")
    kept = strong = moved = 0
    for k, v in step_pair["state"].g_ema.items():
        e0 = np.asarray(ema0[k], np.float64)
        got, want = v.numpy().astype(np.float64) - e0, np.asarray(ref[k], np.float64) - e0
        spacing = np.spacing(np.abs(np.asarray(ema0[k], np.float32))).astype(np.float64)
        keep = _kept(*(g[k] for g in g_grads))
        err = np.abs(got - want)[keep]
        assert np.all(err <= 0.02 * np.abs(want[keep]) + 2 * spacing[keep]), (k, err.max())
        kept += keep.sum()
        strong += (np.abs(want) > 20 * spacing)[keep].sum()
        moved += np.count_nonzero(got[keep])
    assert kept > 0.9 * sum(v.numel() for v in step_pair["state"].g_ema.values())
    assert strong > 0.5 * kept and moved > 0.9 * kept, (strong, moved, kept)


def test_step_updated_params_match_jax(step_pair):
    """G's and D's parameters after Adam within 1e-6 absolute (a 200th of
    lr) wherever the JAX gradient is not near 0; most are kept."""
    pairs = [(step_pair["state"].gnet,
              tweights.g_state_dict_from_jax_params(step_pair["jax"].g_params, {}, "counter_model"),
              _grads(step_pair, "g")),
             (step_pair["state"].dnet, tweights.d_state_dict_from_jax_params(step_pair["jax"].d_params, {}),
              _grads(step_pair, "d"))]
    kept = 0
    for module, ref, (got_g, ref_g, got64_g) in pairs:
        for k, p in module.named_parameters():
            keep = _kept(got_g[k], ref_g[k], got64_g[k])
            np.testing.assert_allclose(p.detach().numpy()[keep], ref[k][keep], atol=1e-6, rtol=0, err_msg=k)
            kept += keep.sum()
    assert kept > 0.9 * sum(p.numel() for m, _, _ in pairs for p in m.parameters())
    assert step_pair["state"].step == int(step_pair["jax"].step) == 1


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``models.main --model counter_model --device cpu`` over 2 training
    images at batch 2: one epoch with a snapshot, then a resume for a
    second."""
    root = tmp_path_factory.mktemp("counter")
    data = write_layout(str(root / "data"), 2, 0, seed=6)
    datasets.TextImageDataset(data, "train", words_num=T, captions_per_image=2)  # writes captions.pickle
    ntoken = len(pickle.load(open(os.path.join(data, "captions.pickle"), "rb"))[2])
    text, image = str(root / "text_encoder.pth"), str(root / "image_encoder.pth")
    torch.save({k: torch.from_numpy(v) for k, v in damsm.random_rnn_state_dict(0, ntoken, nhidden=8).items()}, text)
    torch.save({k: torch.from_numpy(v) for k, v in damsm.random_cnn_state_dict(0, nef=16).items()}, image)
    out = str(root / "out")
    argv = ["--model", "counter_model", "--data_dir", data, "--output_dir", out, "--net_e", text,
            "--image_encoder", image, "--snapshot_interval", "1", "--num_residual", "1", "--smooth_lambda", "0.5",
            "--device", "cpu", *TINY, "--batch_size", "2"]
    first = train_main.main(argv + ["--max_epoch", "1"])
    after_one = sorted(os.listdir(os.path.join(out, "checkpoints")))
    state1 = torch.load(os.path.join(out, "checkpoints", "epoch_1.pt"), weights_only=False)
    second = trainer.main(argv[2:] + ["--max_epoch", "2"])  # the trainer's own entry forwards to models.main
    return {"data": data, "out": out, "text": text, "after_one": after_one, "state1": state1, "ntoken": ntoken,
            "records": first + second}


def test_main_trains_counter_model_snapshots_and_resumes(trained):
    """One step an epoch with the JAX keys; one snapshot kept (.pt and the
    EMA .npz); the resume starts from epoch 1's step and Adam state and
    moves G and the MSG D."""
    ckpt = os.path.join(trained["out"], "checkpoints")
    assert trained["after_one"] == ["epoch_1.npz", "epoch_1.pt"]
    assert sorted(os.listdir(ckpt)) == ["epoch_2.npz", "epoch_2.pt"]
    assert [r["epoch"] for r in trained["records"]] == [1, 2] and all(r["steps"] == 1 for r in trained["records"])
    for r in trained["records"]:
        assert set(r["metrics"]) == {"d_loss", "g_loss", "w_loss", "s_loss", "kl_loss"}
        assert all(np.isfinite(v) for v in r["metrics"].values())
    s1, s2 = trained["state1"], torch.load(os.path.join(ckpt, "epoch_2.pt"), weights_only=False)
    assert (s1["step"], s2["step"]) == (1, 2)
    assert s2["g_opt"]["state"][0]["step"] == 2 and s2["d_opt"]["state"][0]["step"] == 2
    assert not torch.equal(s1["g"]["mem_128_to_256.key.weight"], s2["g"]["mem_128_to_256.key.weight"])
    assert not torch.equal(s1["d"]["block5.conv2.conv0.weight"], s2["d"]["block5.conv2.conv0.weight"])
    with open(os.path.join(trained["out"], "train_history.log")) as f:
        assert "resumed from epoch 1" in f.read()


def test_main_counter_model_takes_lambda_5(monkeypatch, tmp_path, trained):
    """``--model counter_model`` hands the loop lambda 5.0 and the counter
    trainer, ``--smooth_lambda`` notwithstanding."""
    from tise_tpu_torch.models.attngan_pp import train_loop

    seen = {}

    def fake_train(cfg, dataset, output_dir, **kw):
        seen.update(cfg=cfg, module=kw["module"])
        return None, []

    monkeypatch.setattr(train_loop, "train", fake_train)
    train_main.main(["--model", "counter_model", "--data_dir", trained["data"], "--net_e", trained["text"],
                     "--image_encoder", trained["text"].replace("text", "image"), "--smooth_lambda", "0.5",
                     "--output_dir", str(tmp_path), "--device", "cpu", *TINY])
    assert seen["cfg"].damsm.lam == 5.0 and seen["module"] is trainer


def test_generate_reads_the_counter_ema_snapshot(trained):
    """The EMA .npz through the generate CLI with ``--model counter_model``:
    strict load, R_NUM 1 read from the tree, one image a caption."""
    npz = os.path.join(trained["out"], "checkpoints", "epoch_2.npz")
    s2 = torch.load(os.path.join(trained["out"], "checkpoints", "epoch_2.pt"), weights_only=False)
    gan = GanConfig(gf_dim=8, z_dim=8, condition_dim=8, embedding_dim=16, words_num=T, r_num=1)
    g_state, _ = generate.load_generator_from_checkpoint(npz, trained["text"], gan, trained["ntoken"], "counter_model")
    for k, v in s2["g_ema"].items():
        np.testing.assert_array_equal(g_state[k], v.numpy(), err_msg=k)
    caps = os.path.join(trained["out"], "caps.pkl")
    with open(caps, "wb") as f:
        pickle.dump([{"caption_id": i, "caption": "a bird with red wings"} for i in range(2)], f)
    gen_dir = os.path.join(trained["out"], "gen")
    generate.main(["--caption_file", caps, "--output_dir", gen_dir, "--checkpoint", npz, "--text_encoder",
                   trained["text"], "--captions_pickle", os.path.join(trained["data"], "captions.pickle"),
                   "--model", "counter_model", "--gf_dim", "8", "--z_dim", "8", "--condition_dim", "8",
                   "--embedding_dim", "16", "--words_num", str(T), "--batch_size", "2", "--device", "cpu"])
    assert sorted(os.listdir(gen_dir)) == ["0.png", "1.png"]


def test_smoke_cli_and_refusals(capsys, tmp_path):
    """The trainer's ``--smoke --device cpu`` prints finite losses; without
    ``--device cpu`` and with no card the smoke and ``models.main --model
    counter_model`` raise."""
    trainer.main(["--smoke", "--device", "cpu"])
    printed = eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == {"d_loss", "g_loss", "w_loss", "s_loss", "kl_loss"}
    assert all(np.isfinite(v) for v in printed.values())
    if torch.cuda.is_available():
        pytest.skip("shows what happens without a CUDA device; one is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        trainer.main(["--smoke"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_main.main(["--model", "counter_model", "--data_dir", str(tmp_path), "--net_e", "x.pth",
                         "--image_encoder", "y.pth"])
