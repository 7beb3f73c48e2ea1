"""The port's AttnGAN++ training path (tise_tpu_torch.models.attngan_pp) against
the JAX package's on the CPU, at the JAX tests' ``tiny_cfg``: gf 8, df 8,
z 8, condition 8, embedding 16, 6 words, batch 4, vocabulary 50.

Modules: the spectral conv (output, stored u, the gradient through sigma),
each scale's DNet (logits and the u its trunk stores), ``func_attention``,
every loss, train-mode BatchNorm's running statistics, K2's backward twin
(against ``jax.grad`` of the XLA pool, both count modes) and the DAMSM
image encoder's gradient with respect to its input.  Then one whole train
step against the JAX step, from one ``TrainState`` carried across by
``weights.train_state_dicts_from_jax``, with JAX's z and eps: the metrics,
G's and each D's gradients (the JAX gradient is 2 x Adam's first moment
after one step: b1 = 0.5, exact), the stored u, G's running statistics, the
EMA and the updated parameters.

The JAX encoders are built from the port's seeded DAMSM state dicts through
the JAX package's own converters, and the JAX init and step run jitted,
once a module.  Tolerances are stated where they are used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

from tise_tpu.backbones import damsm as jdamsm
from tise_tpu.models.attngan_pp import attention as jattention
from tise_tpu.models.attngan_pp import discriminator as jdisc
from tise_tpu.models.attngan_pp import layers as jlayers
from tise_tpu.models.attngan_pp import losses as jlosses
from tise_tpu.models.attngan_pp import trainer as jtrainer
from tise_tpu.models.attngan_pp.generator import GanConfig as JGanConfig
from tise_tpu.ops import fast_pool as jfast_pool
from tise_tpu_torch.backbones import damsm
from tise_tpu_torch.models import weights as tweights
from tise_tpu_torch.models.attngan_pp import attention, discriminator, layers, losses, trainer
from tise_tpu_torch.models.attngan_pp.generator import GanConfig
from tise_tpu_torch.ops import fast_pool
from tise_tpu_torch.ops.preprocess import normalize_plain

B, T, NTOKEN = 4, 6, 50
GAN = dict(gf_dim=8, df_dim=8, z_dim=8, condition_dim=8, embedding_dim=16, words_num=T)


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


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def test_spectral_conv_matches_jax():
    """Output and the u it would store within 1e-5 relative; the gradient of
    a weighted sum of the output with respect to W (through sigma) within
    1e-4 relative."""
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    r = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    m = jlayers.SpectralConv(features=6, kernel=(3, 3))
    v = jax.jit(lambda k: m.init(k, x, True))(jax.random.PRNGKey(3))
    v = {"params": v["params"], "spectral": {"u": jnp.asarray(rng.standard_normal(6).astype(np.float32))}}
    out, mut = jax.jit(lambda v: m.apply(v, x, True, mutable=["spectral"]))(v)
    gk = jax.jit(jax.grad(lambda p: jnp.sum(m.apply({"params": p, "spectral": v["spectral"]}, x, False) * r)))(
        v["params"])

    conv = layers.SpectralConv(4, 6, 3)
    state = tweights.d_state_dict_from_jax_params({"c": v["params"]}, {"c": v["spectral"]})
    conv.load_state_dict({k[2:]: t(a) for k, a in state.items()})
    got = conv(nchw(x), update_stats=True)
    assert torch.equal(conv.u, t(v["spectral"]["u"])), "a call must not store u"
    assert rel_err(got.detach().permute(0, 2, 3, 1), out) < 1e-5
    assert rel_err(conv.pending_u, mut["spectral"]["u"]) < 1e-5
    (got * nchw(r)).sum().backward()
    assert rel_err(conv.weight.grad.permute(2, 3, 1, 0), gk["kernel"]) < 1e-4
    assert rel_err(conv.bias.grad, gk["bias"]) < 1e-4
    pending = conv.pending_u
    conv.commit_u()
    assert torch.equal(conv.u, pending) and conv.pending_u is None


@pytest.mark.parametrize("scale", [64, 128, 256])
def test_dnet_matches_jax(scale):
    """The port's seeded weights through the JAX DNet (the inverse
    converter, and back): trunk features, cond and uncond logits within
    1e-4 relative, and the u every trunk conv stores within 1e-5."""
    rng = np.random.RandomState(scale)
    x = rng.uniform(-1, 1, (2, scale, scale, 3)).astype(np.float32)
    c = rng.standard_normal((2, 16)).astype(np.float32)
    jd = jdisc.DNet(ndf=8, nef=16, scale=scale)
    state = tweights.random_d_state_dict(scale, 8, 16, scale)
    jparams, jspectral = tweights.jax_params_from_d_state_dict(state)
    v = {"params": jparams, "spectral": jspectral}

    @jax.jit
    def run(v):
        h, mut = jd.apply(v, x, method=jd.features, mutable=["spectral"])
        cond = jd.apply(v, h, c, method=jd.cond_logits, mutable=["spectral"])[0]
        return h, mut, cond, jd.apply(v, h, method=jd.uncond_logits, mutable=["spectral"])[0]

    h, mut, cond, uncond = run(v)

    back = tweights.d_state_dict_from_jax_params(jparams, jspectral)
    assert set(back) == set(state) and all(np.array_equal(back[k], state[k]) for k in state)
    shapes = jax.eval_shape(lambda k: jd.init(k, x, c), jax.random.PRNGKey(0))
    for name, tree in (("params", jparams), ("spectral", jspectral)):
        assert jax.tree.map(lambda a: a.shape, shapes[name]) == jax.tree.map(np.shape, tree), name
    d = discriminator.DNet(8, 16, scale)
    d.load_state_dict({k: t(a) for k, a in state.items()}, strict=True)
    with torch.no_grad():
        th = d.features(nchw(x), update_stats=True)
        tc, tu = d.cond_logits(th, t(c)), d.uncond_logits(th)
    assert rel_err(th.permute(0, 2, 3, 1), h) < 1e-4
    assert rel_err(tc, cond) < 1e-4 and rel_err(tu, uncond) < 1e-4
    d.commit_spectral()
    stored = tweights.d_state_dict_from_jax_params(v["params"], mut["spectral"])
    for k, a in d.state_dict().items():
        if k.endswith(".u"):
            ref = stored[k] if not k.startswith("cond_head") else state[k]  # the heads were not asked to store
            assert rel_err(a, ref) < 1e-5, k


def test_func_attention_matches_jax():
    """Both outputs within 1e-5 absolute, with a masked word and an
    all-padding row."""
    rng = np.random.RandomState(1)
    q = rng.standard_normal((2, 16, T)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, 25)).astype(np.float32)
    valid = np.ones((2, T), bool)
    valid[0, 4:] = False
    valid[1] = False
    ref = jattention.func_attention(jnp.asarray(q), jnp.asarray(ctx), 5.0, jnp.asarray(valid))
    got = attention.func_attention(t(q), t(ctx), 5.0, t(valid))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0)


def _loss_inputs(seed: int = 2):
    rng = np.random.RandomState(seed)
    return {"region": rng.standard_normal((B, 17, 17, 16)).astype(np.float32),
            "code": rng.standard_normal((B, 16)).astype(np.float32),
            "words": rng.standard_normal((B, 16, T)).astype(np.float32),
            "sent": rng.standard_normal((B, 16)).astype(np.float32),
            "lens": np.array([6, 3, 1, 5], np.int32), "cls": np.array([0, 1, 0, 2], np.int32),
            "logits": [rng.standard_normal(n).astype(np.float32) * 3 for n in (B, B, B, B, B - 1)]}


LOSSES = ["sent_loss", "words_loss", "kl_loss", "discriminator_loss", "discriminator_loss_cond_only",
          "generator_adv_loss", "generator_damsm_loss"]


@pytest.mark.parametrize("name", LOSSES)
def test_loss_matches_jax(name):
    """Each loss within 1e-5 relative (words_loss's attention maps within
    1e-5 absolute), with a same-class pair masked; generator_damsm_loss's
    gradients with respect to the region features and the code within 1e-4
    relative."""
    x = _loss_inputs()
    j = {k: jnp.asarray(v) for k, v in x.items() if k != "logits"}
    p = {k: t(v).long() if k in ("lens", "cls") else t(v) for k, v in x.items() if k != "logits"}
    jl, tl = [jnp.asarray(a) for a in x["logits"]], [t(a) for a in x["logits"]]
    if name == "sent_loss":
        ref = jax.jit(jlosses.sent_loss)(j["code"], j["sent"], j["cls"])
        got = losses.sent_loss(p["code"], p["sent"], p["cls"])
    elif name == "words_loss":
        ref = jax.jit(jlosses.words_loss)(j["region"], j["words"], j["lens"], j["cls"])
        got = losses.words_loss(p["region"], p["words"], p["lens"], p["cls"])
        np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-5, rtol=0)
        ref, got = ref[:2], got[:2]
    elif name == "kl_loss":
        ref, got = [jlosses.kl_loss(j["code"], j["sent"] * 0.1)], [losses.kl_loss(p["code"], p["sent"] * 0.1)]
    elif name == "discriminator_loss":
        ref, got = jlosses.discriminator_loss(*jl), losses.discriminator_loss(*tl)
    elif name == "discriminator_loss_cond_only":
        ref = jlosses.discriminator_loss(jl[0], None, jl[2], None, jl[4])
        got = losses.discriminator_loss(tl[0], None, tl[2], None, tl[4])
    elif name == "generator_adv_loss":
        ref = [jlosses.generator_adv_loss(jl[0], jl[1]), jlosses.generator_adv_loss(jl[0], None)]
        got = [losses.generator_adv_loss(tl[0], tl[1]), losses.generator_adv_loss(tl[0], None)]
    else:
        def jf(region, code):
            w, s = jlosses.generator_damsm_loss(region, code, j["words"], j["sent"], j["lens"], j["cls"])
            return w + s, (w, s)

        (_, ref), jgrads = jax.jit(jax.value_and_grad(jf, argnums=(0, 1), has_aux=True))(j["region"], j["code"])
        region, code = p["region"].requires_grad_(), p["code"].requires_grad_()
        got = losses.generator_damsm_loss(region, code, p["words"], p["sent"], p["lens"], p["cls"])
        (got[0] + got[1]).backward()
        assert rel_err(region.grad, jgrads[0]) < 1e-4 and rel_err(code.grad, jgrads[1]) < 1e-4
    for g, r in zip(got, ref):
        assert abs(float(g) - float(r)) <= 1e-5 * max(abs(float(r)), 1.0), (name, float(g), float(r))


@pytest.mark.parametrize("dims", [1, 2])
def test_train_batch_norm_keeps_flax_running_statistics(dims):
    """Train mode over a batch of 4: the output and both running statistics
    within 1e-6 of Flax's ``BatchNorm(momentum=0.9)``, which moves the
    running variance towards the biased batch variance (torch's own
    BatchNorm moves it towards the unbiased one, 4/3 as large)."""
    import flax.linen as fnn

    rng = np.random.RandomState(dims)
    shape = (B, 12) if dims == 1 else (B, 5, 5, 6)
    x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
    c = shape[-1]
    mean0, var0 = rng.standard_normal(c).astype(np.float32), rng.uniform(0.5, 1.5, c).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.standard_normal(c).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}
    ref, mut = bn.apply(v, x, mutable=["batch_stats"])
    m = layers.batch_norm(c, dims)
    m.load_state_dict({"weight": t(scale), "bias": t(bias), "running_mean": t(mean0), "running_var": t(var0),
                       "num_batches_tracked": torch.tensor(0)})
    xt = t(x) if dims == 1 else nchw(x)
    got = m.train()(xt)
    got = got if dims == 1 else got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]), atol=1e-6, rtol=1e-6)
    torch_var = torch.nn.BatchNorm1d(c, momentum=0.1)
    torch_var.running_var.copy_(t(var0))
    torch_var.train()(t(x.reshape(-1, c)))
    assert not np.allclose(torch_var.running_var.numpy(), m.running_var.numpy(), rtol=1e-3)


@pytest.mark.parametrize("include_pad", [True, False])
@pytest.mark.parametrize("shape", [(2, 17, 17, 8), (2, 5, 7, 3), (1, 1, 5, 4), (1, 6, 1, 2)])
def test_pool_backward_twin_matches_jax_grad(shape, include_pad):
    """K2's backward twin (autograd through avg_pool_plain, which CPU
    tensors take) against the VJP of the JAX package's XLA pool, within
    1e-6 of the gradient's scale (sums taken in another order); and the
    CPU route's autograd gives the same as the twin."""
    rng = np.random.RandomState(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jfast_pool.avg_pool_3x3_s1_p1(a, include_pad), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    got = fast_pool.avg_pool_backward_plain(t(g), include_pad).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(g).max(), rtol=0)
    xt = t(x).requires_grad_()
    fast_pool.avg_pool_3x3_s1_p1(xt, include_pad).backward(t(g))
    assert torch.equal(xt.grad, t(got))


@pytest.fixture(scope="module")
def encoder_states():
    """The port's seeded DAMSM state dicts at tiny_cfg's widths."""
    return {"text": damsm.random_rnn_state_dict(0, NTOKEN, nhidden=8), "image": damsm.random_cnn_state_dict(0, nef=16)}


def test_damsm_encoder_input_gradient_matches_jax(encoder_states):
    """CNNEncoder.encode: the gradient of a weighted sum of the region
    features and the code with respect to the 64 px input (resized to 299
    inside) against jax.grad through the JAX encoder, within 2e-2 in L2
    norm and 1e-3 of the largest element on 90% of the elements.  Not
    tighter: the trunk's max pools and ReLUs switch under f32 rounding, and
    each package's f32 gradient is 0.5-1.3% (L2) from the same port run in
    float64.  The no-grad ``forward`` gives encode's values, and the frozen
    encoder holds no parameter gradient."""
    rng = np.random.RandomState(5)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    r1 = rng.standard_normal((1, 17, 17, 16)).astype(np.float32)
    r2 = rng.standard_normal((1, 16)).astype(np.float32)
    jenc = jdamsm.CNNEncoder(nef=16)
    params = jdamsm.cnn_params_from_torch(encoder_states["image"])
    ref = jax.jit(jax.grad(lambda a: jnp.sum(jenc.apply(params, a)[0] * r1) + jnp.sum(jenc.apply(params, a)[1] * r2)))(
        jnp.asarray(x))
    enc = damsm.CNNEncoder.from_state_dict(encoder_states["image"], device="cpu").requires_grad_(False)
    xt = t(x).requires_grad_()
    region, code = enc.encode(xt)
    ((region * t(r1)).sum() + (code * t(r2)).sum()).backward()
    got, ref = xt.grad.numpy().astype(np.float64), np.asarray(ref, np.float64)
    assert np.linalg.norm(got - ref) <= 2e-2 * np.linalg.norm(ref)
    assert np.mean(np.abs(got - ref) <= 1e-3 * np.abs(ref).max()) >= 0.9
    with torch.no_grad():
        f_region, f_code = enc(t(x))
    assert torch.equal(f_region, region.detach()) and torch.equal(f_code, code.detach())
    assert all(p.grad is None for p in enc.parameters())


def test_damsm_bf16_encoder_matches_jax(encoder_states):
    """``bf16_copy().encode`` (``--encoder_precision fast``) against the JAX
    package's ``CNNEncoder(dtype=bfloat16)`` at the same seeded weights and
    inputs as the f32 test: the input gradient and both outputs.  bf16
    rounding moves a random-weight InceptionV3 gradient far: JAX's bf16
    gradient is 62% (L2) from the f32 one (cosine 0.81), and the port's no
    closer.  So each is held within bf16's own spread, JAX's bf16 distance
    to the port's f32 result (which the f32 test holds to JAX): the port's
    bf16 gradient within 1.25x of it, both from JAX's bf16 gradient and
    from the port's f32 one, and the outputs within 2x of it from JAX's bf16
    outputs (measured 0.96x and 1.03x; 1.18x and 0.91x).  The copy computes
    in bf16 with f32 BatchNorm statistics, and gives bf16 outputs."""
    rng = np.random.RandomState(5)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    r1 = rng.standard_normal((1, 17, 17, 16)).astype(np.float32)
    r2 = rng.standard_normal((1, 16)).astype(np.float32)
    jenc = jdamsm.CNNEncoder(nef=16, dtype=jnp.bfloat16)
    params = jdamsm.cnn_params_from_torch(encoder_states["image"])

    def jf(a):
        region, code = (o.astype(jnp.float32) for o in jenc.apply(params, a))
        return jnp.sum(region * r1) + jnp.sum(code * r2), (region, code)

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jf, has_aux=True))(jnp.asarray(x))
    ref = [np.asarray(a, np.float64) for a in (jgrad, *jout)]

    def run(enc):
        xt = t(x).requires_grad_()
        region, code = enc.encode(xt)
        ((region.float() * t(r1)).sum() + (code.float() * t(r2)).sum()).backward()
        return [a.detach().double().numpy() for a in (xt.grad, region, code)], region.dtype

    enc = damsm.CNNEncoder.from_state_dict(encoder_states["image"], device="cpu").requires_grad_(False)
    f32, _ = run(enc)
    fast = enc.bf16_copy()
    got, out_dtype = run(fast)
    assert out_dtype == torch.bfloat16 and fast.trunk.Conv2d_1a_3x3.conv.weight.dtype == torch.bfloat16
    assert fast.trunk.Conv2d_1a_3x3.bn.running_var.dtype == torch.float32

    def dist(a, b):
        return float(np.linalg.norm(a - b))

    spread = [dist(r, f) for r, f in zip(ref, f32)]
    assert dist(got[0], ref[0]) <= 1.25 * spread[0], (dist(got[0], ref[0]), spread[0])
    assert dist(got[0], f32[0]) <= 1.25 * spread[0], (dist(got[0], f32[0]), spread[0])
    for name, g, r, s in zip(("region", "code"), got[1:], ref[1:], spread[1:]):
        assert dist(g, r) <= 2 * s, (name, dist(g, r), s)


# ---------------------------------------------------------------------------
# one whole train step
# ---------------------------------------------------------------------------


def to_dtype(models: trainer.Models, dtype: torch.dtype) -> trainer.Models:
    return trainer.Models(models.gnet.to(dtype), {k: d.to(dtype) for k, d in models.dnets.items()},
                          models.text_encoder.to(dtype), models.image_encoder.to(dtype))


@pytest.fixture(scope="module")
def step_pair(encoder_states):
    """One step of the JAX trainer and of the port from the same state,
    batch and noise (JAX's z and eps), and the same port step in float64,
    the referee of f32 rounding.  The JAX state is the port's seeded
    weights carried across by the inverse converters (Adam at zero, the EMA
    a copy of G), so no JAX init is compiled; the port's state comes back
    from it through ``train_state_dicts_from_jax``."""
    jcfg = jtrainer.TrainConfig(gan=JGanConfig(**GAN), batch_size=B, ntoken=NTOKEN)
    cfg = trainer.TrainConfig(gan=GanConfig(**GAN), batch_size=B, ntoken=NTOKEN)
    g_params, g_stats = tweights.jax_params_from_g_state_dict(tweights.random_g_state_dict(0, cfg.gan))
    d_trees = {str(s): tweights.jax_params_from_d_state_dict(tweights.random_d_state_dict(s, 8, 16, s))
               for s in discriminator.SCALES}
    adam = optax.adam(jcfg.g_lr, b1=jcfg.beta1, b2=jcfg.beta2)
    jstate = jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), g_params=g_params, g_batch_stats=g_stats, g_opt=adam.init(g_params),
        g_ema=jax.tree.map(np.copy, g_params), d_params={k: p for k, (p, _) in d_trees.items()},
        d_spectral={k: u for k, (_, u) in d_trees.items()}, d_opt={k: adam.init(p) for k, (p, _) in d_trees.items()})
    enc = {"text": jdamsm.rnn_params_from_torch(encoder_states["text"]),
           "image": jdamsm.cnn_params_from_torch(encoder_states["image"])}
    batch = trainer.synthetic_batch(cfg, np.random.RandomState(0), B)
    batch = batch._replace(class_ids=np.array([3, 7, 3, 1], np.int32))  # one same-class pair
    jbatch = jtrainer.Batch(images=tuple(normalize_plain(t(im), "half").numpy() for im in batch.images),
                            captions=batch.captions, cap_lens=batch.cap_lens, class_ids=batch.class_ids)
    rng = jax.random.PRNGKey(1)
    jnew, jmetrics = jax.jit(jtrainer.make_train_step(jcfg, jtrainer.build_models(jcfg)))(jstate, jbatch, enc, rng)
    rng_ca, rng_z = jax.random.split(jax.random.fold_in(rng, 0))
    z = np.asarray(jax.random.normal(rng_z, (B, GAN["z_dim"])))
    eps = np.asarray(jax.random.normal(rng_ca, (B, GAN["condition_dim"])))

    dicts = tweights.train_state_dicts_from_jax(jax.device_get(jstate))
    out = {"jax": jax.device_get(jnew), "jax_metrics": {k: float(v) for k, v in jmetrics.items()}, "dicts": dicts}
    for name, dtype in (("state", torch.float32), ("state64", torch.float64)):
        models = to_dtype(trainer.build_models(cfg, encoder_states["text"], encoder_states["image"], "cpu"), dtype)
        state = trainer.init_state(cfg, models, dicts=dicts)
        metrics = trainer.make_train_step(cfg, models)(state, batch, t(z).to(dtype), t(eps).to(dtype))
        out[name], out[name.replace("state", "metrics")] = state, {k: float(v) for k, v in metrics.items()}
    return out


def test_step_metrics_match_jax(step_pair):
    """Every loss of the step within 1e-4 relative of JAX's (the DAMSM terms
    go through InceptionV3), and the f32 step within 1e-4 of the float64
    one."""
    got, ref, ref64 = step_pair["metrics"], step_pair["jax_metrics"], step_pair["metrics64"]
    assert set(got) == set(ref) == set(ref64)
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-4 * max(abs(ref[k]), 1.0), (k, got[k], ref[k])
        assert abs(got[k] - ref64[k]) <= 1e-4 * max(abs(ref64[k]), 1.0), (k, got[k], ref64[k])


def assert_within_rounding(name: str, got: np.ndarray, ref: np.ndarray, ref64: np.ndarray,
                           floor: float = 1e-5, abs_floor: float = 0.0) -> None:
    """The port's f32 ``got`` against JAX's f32 ``ref``, refereed by the
    port's float64 ``ref64``: JAX's result is within 3x the port's own f32
    rounding (L2 distance to ``ref64``) of ``ref64``, and the port's within
    4x that of JAX's.  A floor of ``floor`` (at least 1e-5) of ``ref64``'s
    norm covers tensors whose f32 rounding is near nothing; ``abs_floor``
    is added to it (a caller's estimate of how a sum of many terms rounds).
    A semantic difference moves
    ``ref64`` away from JAX's by far more than f32 rounding: random-weight
    D256 and InceptionV3 gradients carry 0.4-1.3% of it, D64 and D128 1e-6."""
    got, ref, ref64 = (np.asarray(a, np.float64) for a in (got, ref, ref64))
    spread = np.linalg.norm(got - ref64) + max(floor, 1e-5) * np.linalg.norm(ref64) + abs_floor
    assert np.linalg.norm(ref - ref64) <= 3 * spread, (name, np.linalg.norm(ref - ref64), spread)
    assert np.linalg.norm(got - ref) <= 4 * spread, (name, np.linalg.norm(got - ref), spread)


def _g_grads(step_pair):
    """(port, JAX, port float64) gradients of G by state-dict name; JAX's
    are 2 x Adam's first moment after its first step (b1 = 0.5: exact)."""
    mu = step_pair["jax"].g_opt[0].mu
    ref = tweights.g_state_dict_from_jax_params(jax.tree.map(lambda m: 2.0 * np.asarray(m), mu), {})
    got = {k: p.grad.numpy() for k, p in step_pair["state"].gnet.named_parameters()}
    got64 = {k: p.grad.numpy() for k, p in step_pair["state64"].gnet.named_parameters()}
    return got, ref, got64


def _d_grads(step_pair, scale: int):
    mu = step_pair["jax"].d_opt[str(scale)][0].mu
    ref = tweights.d_state_dict_from_jax_params(jax.tree.map(lambda m: 2.0 * np.asarray(m), mu), {})
    got = {k: p.grad.numpy() for k, p in step_pair["state"].dnets[scale].named_parameters()}
    got64 = {k: p.grad.numpy() for k, p in step_pair["state64"].dnets[scale].named_parameters()}
    return got, ref, got64


def test_step_g_gradients_match_jax(step_pair):
    """Every G parameter's gradient, within f32 rounding as
    ``assert_within_rounding`` measures it (the adversarial and DAMSM terms
    reach G through three Ds and InceptionV3)."""
    got, ref, got64 = _g_grads(step_pair)
    assert set(got) == set(got64) and set(got) <= set(ref)
    for k in got:
        assert_within_rounding(k, got[k], ref[k], got64[k])


@pytest.mark.parametrize("scale", [64, 128, 256])
def test_step_d_gradients_match_jax(step_pair, scale):
    """Every D parameter's gradient (the D losses see the detached fakes),
    within f32 rounding."""
    got, ref, got64 = _d_grads(step_pair, scale)
    for k in got:
        assert_within_rounding(k, got[k], ref[k], got64[k])


def test_step_stored_u_matches_jax(step_pair):
    """Each D's u after the step within 1e-5: the trunk's from the real
    pass, the heads' unchanged."""
    for s, d in step_pair["state"].dnets.items():
        ref = tweights.d_state_dict_from_jax_params({}, step_pair["jax"].d_spectral[str(s)])
        before = step_pair["dicts"].d[s]
        for k, a in d.state_dict().items():
            if k.endswith(".u"):
                np.testing.assert_allclose(a.numpy(), ref[k], atol=1e-5, rtol=0, err_msg=k)
                moved = not np.allclose(before[k], ref[k], atol=1e-5)
                assert moved != k.startswith("cond_head"), k


def test_step_g_batch_stats_match_jax(step_pair):
    """G's running statistics after the step within 1e-4 of each tensor's
    largest element: Flax's biased variance (torch's unbiased one would be
    off by 4/3 at the fc)."""
    ref = tweights.g_state_dict_from_jax_params({}, step_pair["jax"].g_batch_stats)
    got = step_pair["state"].gnet.state_dict()
    keys = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert keys and all(k in got for k in keys)
    for k in keys:
        assert rel_err(got[k], ref[k]) < 1e-4, k


def _kept(got_g: np.ndarray, ref_g: np.ndarray, got64_g: np.ndarray) -> np.ndarray:
    """The elements whose JAX gradient is not near 0 (see
    ``test_step_updated_params_match_jax``)."""
    rounding = np.maximum(np.abs(got_g - got64_g), np.abs(ref_g - got64_g))
    return np.abs(ref_g) > np.maximum(10 * rounding, 1e-6)


def test_step_ema_matches_jax(step_pair):
    """The EMA's change over the step against JAX's, on the elements whose
    JAX gradient is not near 0.  ``g_ema`` starts as a copy of G, so after a
    first Adam step it moves by 0.001 x lr x sign(g), about 2e-7: its value
    alone cannot tell an EMA that was updated from one that was not.  So the
    port's change ``g_ema - ema0`` is held to JAX's within 2% of JAX's
    change plus two f32 spacings of the EMA's value (each package rounds
    0.999 e + 0.001 p to f32 once).  An EMA left as it was, taken from G
    before its update or with another decay fails here.  Most of these
    elements move by more than 20 spacings of their value."""
    ema0, g_grads = step_pair["dicts"].g_ema, _g_grads(step_pair)
    ref = tweights.g_state_dict_from_jax_params(step_pair["jax"].g_ema, {})
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
    """G's and the Ds' parameters after Adam within 1e-6 absolute (a 200th
    of lr 2e-4) wherever the JAX gradient is not near 0.  A first Adam step
    is lr x sign(g), so a gradient within f32 rounding of 0 may have either
    sign in the two packages and move its parameter by 2 lr; near 0 means
    within 10x the element's f32 rounding, the larger of its port and JAX
    gradients' distances to the port's float64 one, or within 100x Adam's
    eps 1e-8, where the step lr g / (|g| + eps) still moves with g's
    rounding.  Most elements are not near 0."""
    new = {"g": tweights.g_state_dict_from_jax_params(step_pair["jax"].g_params, {})}
    pairs = [(step_pair["state"].gnet, new["g"], _g_grads(step_pair))]
    for s, d in step_pair["state"].dnets.items():
        pairs.append((d, tweights.d_state_dict_from_jax_params(step_pair["jax"].d_params[str(s)], {}),
                      _d_grads(step_pair, s)))
    kept = 0
    for module, ref, (got_g, ref_g, got64_g) in pairs:
        for k, p in module.named_parameters():
            keep = _kept(got_g[k], ref_g[k], got64_g[k])
            np.testing.assert_allclose(p.detach().numpy()[keep], ref[k][keep], atol=1e-6, rtol=0, err_msg=k)
            kept += keep.sum()
    assert kept > 0.9 * sum(p.numel() for m, _, _ in pairs for p in m.parameters())
    assert step_pair["state"].step == int(step_pair["jax"].step) == 1
