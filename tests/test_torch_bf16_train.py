"""One bf16 train step of each of the port's trainers against the JAX
package's bf16 step on the CPU, the remat step against the remat-off step,
and the AttnGAN++ trainer's ``--smoke`` CLI.

The steps run at the widths of tests/test_torch_train.py (AttnGAN++: gf 8,
df 8, z 8, condition 8, embedding 16, 6 words, batch 4, vocabulary 50) and
tests/test_torch_counter_train.py (the CounterModel: the same widths, batch
3, lambda 5), from the same seeded state, batch and noise on both sides.
The JAX models are ``build_models(cfg, bfloat16)`` with one change: JAX's
bf16 text encoder raises in its scan (tests/test_torch_bf16.py), so its
place is taken by the f32 encoder on the embedding table rounded to bf16,
which is what its type promotion computes and what the port's bf16 encoder
computes.  CA's eps is JAX's bf16 draw.

A whole bf16 step is chaotic: a rounding that differs anywhere (XLA keeps
some products unrounded where the next op promotes them, such as a
convolution's output into BatchNorm's f32 moments) switches ReLUs and
max-pool winners of the random-weight InceptionV3 that G's gradient runs
back through, and grows through every layer after it.  Measured: G's bf16
gradient lands 24-56% (L2) from f32 in either package, and the port's
bf16 step lands as far from JAX's as each lands from f32.  So each result
(the metrics, G's gradient and each D's, G's running statistics) is held
to two things: its distance to JAX's bf16 step is at most ``STEP_SHARE``
times the distance from JAX's bf16 step to the f32 step (the port's f32
step, equal to JAX's f32 step to f32 rounding in the files above), as two
draws of the same rounding noise are; and, for the gradients and the
statistics, the port's own bf16-to-f32 distance is within a factor
``OWN_FACTOR`` of JAX's, so the port's step neither skips the bf16
rounding nor rounds more than JAX does.  The modules one by one are held
far tighter in tests/test_torch_bf16.py.
"""

import ast
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

from tise_tpu.backbones import damsm as jdamsm
from tise_tpu.models.attngan_pp import trainer as jtrainer
from tise_tpu.models.attngan_pp.generator import GanConfig as JGanConfig
from tise_tpu.models.counter_model import trainer as jctrainer
from tise_tpu_torch.backbones import damsm
from tise_tpu_torch.models import weights as tweights
from tise_tpu_torch.models.attngan_pp import discriminator, generator, trainer
from tise_tpu_torch.models.attngan_pp.generator import GanConfig
from tise_tpu_torch.models.counter_model import trainer as ctrainer
from tise_tpu_torch.ops.preprocess import normalize_plain

T, NTOKEN, NDF, NEF = 6, 50, 8, 16
GAN = dict(gf_dim=8, df_dim=NDF, z_dim=8, condition_dim=8, embedding_dim=NEF, words_num=T)
BF16 = jnp.bfloat16
STEP_SHARE = 2.0  # the port's bf16 step to JAX's, over JAX's bf16 step to f32
OWN_FACTOR = 2.0  # the port's bf16-to-f32 distance within [1/2, 2] of JAX's


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


def flat(d: dict, keys) -> np.ndarray:
    return np.concatenate([np.ravel(np.asarray(d[k], np.float64)) for k in keys])


def assert_bf16_step(name: str, got, ref_bf16, ref_f32, own: bool = True) -> None:
    """``got`` (the port's bf16 step) within ``STEP_SHARE`` times JAX's
    bf16-to-f32 distance (L2) of JAX's bf16 ``ref_bf16``; with ``own``, the
    port's own distance to ``ref_f32`` within ``OWN_FACTOR`` of JAX's."""
    got, ref_bf16, ref_f32 = (np.asarray(a, np.float64) for a in (got, ref_bf16, ref_f32))
    assert np.isfinite(got).all(), name
    spread = np.linalg.norm(ref_bf16 - ref_f32)
    assert spread > 1e-4 * np.linalg.norm(ref_f32), (name, "bf16 equals f32")
    r, mine = np.linalg.norm(got - ref_bf16) / spread, np.linalg.norm(got - ref_f32) / spread
    print(f"{name}: port to JAX bf16 {r:.3f}, port bf16 to f32 {mine:.3f} of JAX's bf16-to-f32 distance {spread:.3e} "
          f"({spread / np.linalg.norm(ref_f32):.2%} of the f32 result)")
    assert r <= STEP_SHARE, (name, r)
    assert not own or 1 / OWN_FACTOR <= mine <= OWN_FACTOR, (name, mine)


@pytest.fixture(scope="module")
def encoder_states():
    return {"text": damsm.random_rnn_state_dict(0, NTOKEN, nhidden=NEF // 2),
            "image": damsm.random_cnn_state_dict(0, nef=NEF)}


def jax_encoders(encoder_states):
    """The JAX encoder params, the text encoder's embedding rounded to bf16."""
    text = jax.tree_util.tree_map(np.asarray, jdamsm.rnn_params_from_torch(encoder_states["text"]))
    text["params"]["embedding"] = np.asarray(jnp.asarray(text["params"]["embedding"], BF16).astype(jnp.float32))
    return {"text": text, "image": jdamsm.cnn_params_from_torch(encoder_states["image"])}


def jax_bf16_models(models):
    """``build_models(cfg, bfloat16)`` with the f32 text encoder (see the module docstring)."""
    te = models.text_encoder
    return models._replace(text_encoder=jdamsm.RNNEncoder(ntoken=te.ntoken, nhidden=te.nhidden))


def jax_noise(b: int):
    rng = jax.random.PRNGKey(1)
    rng_ca, rng_z = jax.random.split(jax.random.fold_in(rng, 0))
    z = np.asarray(jax.random.normal(rng_z, (b, GAN["z_dim"])))
    eps = np.asarray(jax.random.normal(rng_ca, (b, GAN["condition_dim"]), dtype=BF16).astype(jnp.float32))
    return rng, z, eps


def run_port(module, cfg, encoder_states, dicts, batch, z, eps, dtype):
    models = module.build_models(cfg, encoder_states["text"], encoder_states["image"], "cpu", dtype=dtype)
    state = module.init_state(cfg, models, dicts=dicts)
    metrics = module.make_train_step(cfg, models)(state, batch, t(z), t(eps))
    return state, {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def attngan_steps(encoder_states):
    """JAX's bf16 AttnGAN++ step, the port's bf16 step and the port's f32
    step from one state (tests/test_torch_train.py's seeded weights)."""
    b = 4
    jcfg = jtrainer.TrainConfig(gan=JGanConfig(**GAN), batch_size=b, ntoken=NTOKEN)
    cfg = trainer.TrainConfig(gan=GanConfig(**GAN), batch_size=b, ntoken=NTOKEN)
    g_params, g_stats = tweights.jax_params_from_g_state_dict(tweights.random_g_state_dict(0, cfg.gan))
    d_trees = {str(s): tweights.jax_params_from_d_state_dict(tweights.random_d_state_dict(s, NDF, NEF, s))
               for s in discriminator.SCALES}
    adam = optax.adam(jcfg.g_lr, b1=jcfg.beta1, b2=jcfg.beta2)
    jstate = jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), g_params=g_params, g_batch_stats=g_stats, g_opt=adam.init(g_params),
        g_ema=jax.tree.map(np.copy, g_params), d_params={k: p for k, (p, _) in d_trees.items()},
        d_spectral={k: u for k, (_, u) in d_trees.items()}, d_opt={k: adam.init(p) for k, (p, _) in d_trees.items()})
    batch = trainer.synthetic_batch(cfg, np.random.RandomState(0), b)
    batch = batch._replace(class_ids=np.array([3, 7, 3, 1], np.int32))
    jbatch = jtrainer.Batch(images=tuple(normalize_plain(t(im), "half").numpy() for im in batch.images),
                            captions=batch.captions, cap_lens=batch.cap_lens, class_ids=batch.class_ids)
    rng, z, eps = jax_noise(b)
    models = jax_bf16_models(jtrainer.build_models(jcfg, BF16))
    jnew, jmetrics = jax.jit(jtrainer.make_train_step(jcfg, models))(jstate, jbatch, jax_encoders(encoder_states), rng)
    dicts = tweights.train_state_dicts_from_jax(jax.device_get(jstate))
    out = {"jax": jax.device_get(jnew), "jax_metrics": {k: float(v) for k, v in jmetrics.items()}}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        out[name] = run_port(trainer, cfg, encoder_states, dicts, batch, z, eps, dtype)
    return out


@pytest.fixture(scope="module")
def counter_steps(encoder_states):
    """JAX's bf16 CounterModel step, the port's bf16 and f32 steps
    (tests/test_torch_counter_train.py's seeded weights)."""
    b = 3
    jcfg = jtrainer.TrainConfig(gan=JGanConfig(**GAN), batch_size=b, ntoken=NTOKEN,
                                damsm=jctrainer.default_config().damsm)
    cfg = trainer.TrainConfig(gan=GanConfig(**GAN), batch_size=b, ntoken=NTOKEN, damsm=ctrainer.default_config().damsm)
    g_params, g_stats = tweights.jax_params_from_g_state_dict(
        tweights.random_g_state_dict(0, cfg.gan, "counter_model"))
    d_params, d_spectral = tweights.jax_params_from_d_state_dict(tweights.random_msg_d_state_dict(1, NDF, NEF))
    adam = optax.adam(jcfg.g_lr, b1=jcfg.beta1, b2=jcfg.beta2)
    jstate = jctrainer.CounterTrainState(
        step=jnp.zeros((), jnp.int32), g_params=g_params, g_batch_stats=g_stats, g_opt=adam.init(g_params),
        g_ema=jax.tree.map(np.copy, g_params), d_params=d_params, d_spectral=d_spectral, d_opt=adam.init(d_params))
    batch = trainer.synthetic_batch(cfg, np.random.RandomState(0), b)
    batch = batch._replace(class_ids=np.array([3, 7, 3], np.int32))
    jbatch = jtrainer.Batch(images=tuple(normalize_plain(t(im), "half").numpy() for im in batch.images),
                            captions=batch.captions, cap_lens=batch.cap_lens, class_ids=batch.class_ids)
    rng, z, eps = jax_noise(b)
    models = jax_bf16_models(jctrainer.build_models(jcfg, BF16))
    jnew, jmetrics = jax.jit(jctrainer.make_train_step(jcfg, models))(jstate, jbatch, jax_encoders(encoder_states),
                                                                      rng)
    dicts = tweights.train_state_dicts_from_jax(jax.device_get(jstate), "counter_model")
    out = {"jax": jax.device_get(jnew), "jax_metrics": {k: float(v) for k, v in jmetrics.items()}}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        out[name] = run_port(ctrainer, cfg, encoder_states, dicts, batch, z, eps, dtype)
    return out


def grads(module: torch.nn.Module) -> dict:
    return {k: np.zeros(p.shape) if p.grad is None else p.grad.numpy() for k, p in module.named_parameters()}


def test_attngan_bf16_step_matches_jax(attngan_steps):
    """The AttnGAN++ step: metrics, G's and the three Ds' gradients (JAX's:
    2 x Adam's first moment), G's running statistics; G, the Ds and the
    text encoder compute in bf16, the image encoder is the bf16 copy, and
    the parameters stay f32."""
    s = attngan_steps
    state = s["bf16"][0]
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in state.gnet.parameters())
    assert state.gnet.h_net1.fc.compute_dtype == torch.bfloat16
    (st16, m16), (st32, m32) = s["bf16"], s["f32"]
    keys = sorted(s["jax_metrics"])
    assert set(m16) == set(keys)
    assert_bf16_step("metrics", [m16[k] for k in keys], [s["jax_metrics"][k] for k in keys],
                     [m32[k] for k in keys], own=False)
    ref = tweights.g_state_dict_from_jax_params(jax.tree.map(lambda m: 2.0 * np.asarray(m), s["jax"].g_opt[0].mu), {})
    g16, g32 = grads(st16.gnet), grads(st32.gnet)
    gk = sorted(g16)
    assert_bf16_step("G gradient", flat(g16, gk), flat(ref, gk), flat(g32, gk))
    for scale in discriminator.SCALES:
        dref = tweights.d_state_dict_from_jax_params(
            jax.tree.map(lambda m: 2.0 * np.asarray(m), s["jax"].d_opt[str(scale)][0].mu), {})
        d16, d32 = grads(st16.dnets[scale]), grads(st32.dnets[scale])
        dk = sorted(d16)
        assert_bf16_step(f"D{scale} gradient", flat(d16, dk), flat(dref, dk), flat(d32, dk))
    stats = tweights.g_state_dict_from_jax_params({}, s["jax"].g_batch_stats)
    sk = sorted(k for k in stats if k.endswith(("running_mean", "running_var")))
    assert_bf16_step("G running statistics", flat({k: v.numpy() for k, v in st16.gnet.state_dict().items()}, sk),
          flat(stats, sk), flat({k: v.numpy() for k, v in st32.gnet.state_dict().items()}, sk))


def test_counter_bf16_step_matches_jax(counter_steps):
    """The CounterModel step, as the AttnGAN++ one (one MSG D)."""
    s = counter_steps
    (st16, m16), (st32, m32) = s["bf16"], s["f32"]
    keys = sorted(s["jax_metrics"])
    assert set(m16) == set(keys)
    assert_bf16_step("metrics", [m16[k] for k in keys], [s["jax_metrics"][k] for k in keys],
                     [m32[k] for k in keys], own=False)
    ref = tweights.g_state_dict_from_jax_params(jax.tree.map(lambda m: 2.0 * np.asarray(m), s["jax"].g_opt[0].mu), {},
                                                "counter_model")
    g16, g32 = grads(st16.gnet), grads(st32.gnet)
    gk = sorted(g16)
    assert_bf16_step("G gradient", flat(g16, gk), flat(ref, gk), flat(g32, gk))
    dref = tweights.d_state_dict_from_jax_params(jax.tree.map(lambda m: 2.0 * np.asarray(m), s["jax"].d_opt[0].mu), {})
    d16, d32 = grads(st16.dnet), grads(st32.dnet)
    dk = sorted(d16)
    assert_bf16_step("D gradient", flat(d16, dk), flat(dref, dk), flat(d32, dk))
    stats = tweights.g_state_dict_from_jax_params({}, s["jax"].g_batch_stats, "counter_model")
    sk = sorted(k for k in stats if k.endswith(("running_mean", "running_var")))
    assert_bf16_step("G running statistics", flat({k: v.numpy() for k, v in st16.gnet.state_dict().items()}, sk),
          flat(stats, sk), flat({k: v.numpy() for k, v in st32.gnet.state_dict().items()}, sk))


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


def test_remat_step_equals_the_remat_off_step(encoder_states, monkeypatch):
    """``GanConfig(remat=True)``: one f32 step from the same seeded state,
    batch and noise as the step without it.  G's running statistics and
    BatchNorm counters are bit-equal (the recompute does not move them a
    second time), the metrics and every gradient of G and the Ds within
    f32 rounding (1e-6 of the norm; on the CPU the recompute gives the
    same values); the checkpointed stages run twice (the forward and the
    recompute) and the image heads once; in eval mode the generator's
    output is the same with remat on or off."""
    b = 4
    out = {}
    calls = {}
    for cls in (generator.InitStage, generator.NextStage, generator.GetImage):
        def counted(self, *args, _forward=cls.forward, _name=cls.__name__):
            calls[_name] = calls.get(_name, 0) + 1
            return _forward(self, *args)
        monkeypatch.setattr(cls, "forward", counted)
    for remat in (False, True):
        cfg = trainer.TrainConfig(gan=GanConfig(**GAN, remat=remat), batch_size=b, ntoken=NTOKEN)
        models = trainer.build_models(cfg, encoder_states["text"], encoder_states["image"], "cpu")
        state = trainer.init_state(cfg, models, seed=3)
        calls.clear()
        z, eps = (torch.from_numpy(np.random.RandomState(i).standard_normal((b, 8)).astype(np.float32)) for i in (1, 2))
        metrics = trainer.make_train_step(cfg, models)(state, trainer.synthetic_batch(cfg, np.random.RandomState(0), b),
                                                      z, eps)
        out[remat] = state, metrics, dict(calls)
    (off, m_off, c_off), (on, m_on, c_on) = out[False], out[True]
    assert c_off == {"InitStage": 1, "NextStage": 2, "GetImage": 3}
    assert c_on == {"InitStage": 2, "NextStage": 4, "GetImage": 3}
    buffers = {k: v for k, v in off.gnet.state_dict().items() if "running" in k or "num_batches" in k}
    assert buffers and all(torch.equal(on.gnet.state_dict()[k], v) for k, v in buffers.items())
    for k in m_off:
        assert abs(float(m_on[k]) - float(m_off[k])) <= 1e-6 * max(abs(float(m_off[k])), 1.0), k
    for a, b_ in [(off.gnet, on.gnet)] + [(off.dnets[s], on.dnets[s]) for s in off.dnets]:
        ga, gb = grads(a), grads(b_)
        keys = sorted(ga)
        assert np.linalg.norm(flat(ga, keys) - flat(gb, keys)) <= 1e-6 * np.linalg.norm(flat(ga, keys))
    cfg = trainer.TrainConfig(gan=GanConfig(**GAN, remat=True), batch_size=b, ntoken=NTOKEN)
    g_on = on.gnet.eval()
    g_off = trainer.build_models(trainer.TrainConfig(gan=GanConfig(**GAN), batch_size=b, ntoken=NTOKEN),
                                 encoder_states["text"], encoder_states["image"], "cpu").gnet.eval()
    g_off.load_state_dict(g_on.state_dict())
    words = torch.randn(b, NEF, T, generator=torch.Generator().manual_seed(4))
    sent, z, eps = torch.randn(b, NEF), torch.randn(b, 8), torch.randn(b, 8)
    with torch.no_grad():
        assert all(torch.equal(x, y) for x, y in zip(g_on(z, sent, words, None, eps)[0], g_off(z, sent, words, None, eps)[0]))
    assert cfg.gan.remat


# ---------------------------------------------------------------------------
# the AttnGAN++ trainer's --smoke CLI
# ---------------------------------------------------------------------------


def test_smoke_cli(attngan_steps, capsys):
    """``python -m tise_tpu_torch.models.attngan_pp.trainer --smoke --device
    cpu`` runs the JAX smoke's two tiny steps and prints the JAX step's
    metric keys, finite; without ``--device cpu`` it raises here (no card);
    without ``--smoke`` it refuses, as the JAX CLI does."""
    trainer.main(["--smoke", "--device", "cpu"])
    printed = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == set(attngan_steps["jax_metrics"])
    assert all(np.isfinite(v) for v in printed.values())
    with pytest.raises(RuntimeError, match="--device cpu"):
        trainer.main(["--smoke"])
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        trainer.main([])
