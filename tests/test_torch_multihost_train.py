"""The port's sharded AttnGAN++ train step
(``trainer.make_sharded_train_step``) on a real two-rank CPU gloo cluster,
against the port's one-process step on the whole batch and against the JAX
package's step.

The world is the width of tests/multihost_train_common.py::make_world (gf 8,
df 8, z 16, condition 16, embedding 32, 8 words, vocabulary 64, global batch
4, so 2 a rank), with the port's seeded weights (``make_world`` itself builds
its JAX state by an init that takes about a minute op by op here), a batch
of uint8 images with one same-class pair across the ranks, and JAX's z and
eps.  Two worker processes (tests/torch_multihost_train_worker.py) each run
one step on their shard in f32 and in float64, and in f32 once more under
each of three local forms (BatchNorm moments, DAMSM losses or gradients of
the local batch), while this process runs the one-process step in f32 and
float64 and the JAX step (jitted, once).

Held: the float64 sharded step equals the float64 one-process step to
float64 rounding; the f32 sharded step is within 4x the one-process f32
step's own rounding (its distance to float64) of it, with
tests/test_torch_train.py's bound and floor; both ranks end with the same
state; the sharded step is within tests/test_multihost.py's tolerances of
JAX's; and each local form fails the f32 check.
"""

import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

from tests.test_torch_multihost import finish_cluster, start_cluster
from tests.torch_multihost_train_worker import LOCAL_FORMS, step_results
from tise_tpu.backbones import damsm as jdamsm
from tise_tpu.models.attngan_pp import trainer as jtrainer
from tise_tpu.models.attngan_pp.generator import GanConfig as JGanConfig
from tise_tpu_torch.backbones import damsm
from tise_tpu_torch.models import weights as tweights
from tise_tpu_torch.models.attngan_pp import trainer
from tise_tpu_torch.models.attngan_pp.generator import GanConfig
from tise_tpu_torch.ops.preprocess import normalize_plain

# tests/multihost_train_common.py::make_world's widths
GAN = dict(gf_dim=8, df_dim=8, z_dim=16, condition_dim=16, embedding_dim=32, words_num=8)
B, NTOKEN = 4, 64
WORLD = 2
D_SCALES = (64, 128, 256)
QUANTITIES = ("g_grad", "g_stats", "ema", "g_params", *(f"d{s}_{q}" for s in D_SCALES for q in ("grad", "u", "params")))
F32_CHECKED = ("g_grad", "g_stats", *(f"d{s}_{q}" for s in D_SCALES for q in ("grad", "u")))


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


def _jax_step(world: dict) -> dict:
    """JAX's step at make_world's widths from the same state, batch and key."""
    jcfg = jtrainer.TrainConfig(gan=JGanConfig(**GAN), batch_size=B, ntoken=NTOKEN)
    dicts = world["dicts"]
    g_params, g_stats = tweights.jax_params_from_g_state_dict(dicts.g)
    d_trees = {str(s): tweights.jax_params_from_d_state_dict(dicts.d[s]) for s in D_SCALES}
    adam = optax.adam(jcfg.g_lr, b1=jcfg.beta1, b2=jcfg.beta2)
    jstate = jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), g_params=g_params, g_batch_stats=g_stats, g_opt=adam.init(g_params),
        g_ema=jax.tree.map(np.copy, g_params), d_params={k: p for k, (p, _) in d_trees.items()},
        d_spectral={k: u for k, (_, u) in d_trees.items()}, d_opt={k: adam.init(p) for k, (p, _) in d_trees.items()})
    enc = {"text": jdamsm.rnn_params_from_torch(world["text"]), "image": jdamsm.cnn_params_from_torch(world["image"])}
    batch = world["batch"]
    jbatch = jtrainer.Batch(images=tuple(normalize_plain(torch.from_numpy(im), "half").numpy() for im in batch.images),
                            captions=batch.captions, cap_lens=batch.cap_lens, class_ids=batch.class_ids)
    new, metrics = jax.jit(jtrainer.make_train_step(jcfg, jtrainer.build_models(jcfg)))(
        jstate, jbatch, enc, jax.random.PRNGKey(1))
    new = jax.device_get(new)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "g_params": tweights.g_state_dict_from_jax_params(new.g_params, {}),
            "ema": tweights.g_state_dict_from_jax_params(new.g_ema, {})}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(rank, run): worker results}, the one-process f32 and float64 steps
    and JAX's step."""
    folder = tmp_path_factory.mktemp("multihost_train")
    gan = GanConfig(**GAN)
    rng_ca, rng_z = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(1), 0))  # the JAX step's draws
    batch = trainer.synthetic_batch(trainer.TrainConfig(gan=gan, batch_size=B, ntoken=NTOKEN),
                                    np.random.RandomState(0), B)
    world = {
        "gan": GAN, "batch_size": B, "ntoken": NTOKEN,
        "dicts": tweights.TrainStateDicts(0, tweights.random_g_state_dict(0, gan), {}, {
            s: tweights.random_d_state_dict(s, GAN["df_dim"], GAN["embedding_dim"], s) for s in D_SCALES}),
        "batch": batch._replace(class_ids=np.array([3, 7, 3, 1], np.int32)),  # a same-class pair across the ranks
        "text": damsm.random_rnn_state_dict(0, NTOKEN, nhidden=GAN["embedding_dim"] // 2),
        "image": damsm.random_cnn_state_dict(0, nef=GAN["embedding_dim"]),
        "z": np.asarray(jax.random.normal(rng_z, (B, GAN["z_dim"]))),
        "eps": np.asarray(jax.random.normal(rng_ca, (B, GAN["condition_dim"]))),
    }
    with open(folder / "world.pkl", "wb") as f:
        pickle.dump(world, f)
    procs = start_cluster("torch_multihost_train_worker.py", str(folder))
    try:
        with ThreadPoolExecutor(1) as pool:  # the JAX compile beside the port's steps
            jax_run = pool.submit(_jax_step, world)
            one = {name: step_results(world, None, dtype) for name, dtype in (("f32", torch.float32),
                                                                              ("f64", torch.float64))}
            one["jax"] = jax_run.result()
    finally:
        finish_cluster(procs, str(folder))
    for rank in range(WORLD):
        for name in ("f32", "f64", *LOCAL_FORMS):
            with open(folder / f"rank{rank}_{name}.pkl", "rb") as f:
                one[rank, name] = pickle.load(f)
    return one


def rounding_failures(got: dict, one: dict, one64: dict) -> list:
    """The metrics and tensors where ``got`` (an f32 step) is not within f32
    rounding of the one-process f32 step ``one``: a tensor within 4x that
    step's own f32 rounding, its L2 distance to the one-process float64
    step ``one64``, with tests/test_torch_train.py's floor of 1e-5 of the
    float64 norm (4x is that file's bound of the port against JAX; the
    random-weight D256 and InceptionV3 gradients carry 0.4-1.3% of f32
    rounding); a metric within 1e-4 of float64."""
    failures = [k for k, v in one64["metrics"].items() if abs(got["metrics"][k] - v) > 1e-4 * max(abs(v), 1.0)]
    for q in F32_CHECKED:
        for k, ref64 in one64[q].items():
            spread = np.linalg.norm(one[q][k] - ref64) + 1e-5 * np.linalg.norm(ref64)
            if np.linalg.norm(got[q][k] - one[q][k]) > 4 * spread:
                failures.append(f"{q}.{k}")
    return failures


@pytest.mark.parametrize("quantity", ("metrics", *QUANTITIES))
def test_float64_sharded_step_equals_one_process(runs, quantity):
    """Each rank's float64 step against the one-process float64 step: each
    tensor within 1e-9 of its own norm plus 1e-12 of its quantity's (a
    conv bias under BatchNorm has a gradient of float64 noise), every
    metric within 1e-12 relative."""
    ref = runs["f64"][quantity]
    for rank in range(WORLD):
        got = runs[rank, "f64"][quantity]
        if quantity == "metrics":
            for k, v in ref.items():
                assert abs(got[k] - v) <= 1e-12 * max(abs(v), 1.0), (k, got[k], v)
            continue
        scale = np.sqrt(sum(float(np.sum(v ** 2)) for v in ref.values()))
        assert scale > 0 and set(got) == set(ref)
        for k, v in ref.items():
            assert np.linalg.norm(got[k] - v) <= 1e-9 * np.linalg.norm(v) + 1e-12 * scale, (rank, k)


@pytest.mark.parametrize("run", ("f32", "f64"))
def test_ranks_end_with_the_same_state(runs, run):
    """The gradients each rank applied and everything a step leaves are
    the same bits on both ranks."""
    for quantity in ("metrics", *QUANTITIES):
        a, b = runs[0, run][quantity], runs[1, run][quantity]
        assert set(a) == set(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), (run, quantity, k)


def test_f32_sharded_step_within_rounding_of_one_process(runs):
    """Both ranks' f32 metrics, G and D gradients, G's running statistics
    and the stored u, within f32 rounding of the one-process f32 step."""
    for rank in range(WORLD):
        assert rounding_failures(runs[rank, "f32"], runs["f32"], runs["f64"]) == [], rank


@pytest.mark.parametrize("form", LOCAL_FORMS)
def test_a_local_form_fails_the_f32_check(runs, form):
    """BatchNorm moments of the local batch, the DAMSM losses of the local
    batch, or gradients that are not averaged: each moves some metric or
    tensor far outside f32 rounding."""
    failures = rounding_failures(runs[0, form], runs["f32"], runs["f64"])
    assert failures, form
    assert any(f.startswith("g_grad.") for f in failures), failures


def test_sharded_step_matches_jax(runs):
    """The f32 sharded step against JAX's one-process step within the
    tolerances tests/test_multihost.py gives its own sharded step: metrics
    1e-4 relative (g_loss 2e-2, through the Adam-updated Ds), G's parameters
    1e-3 (a first Adam step is lr x sign(g)) and the EMA 1e-5 absolute."""
    ref = runs["jax"]
    for rank in range(WORLD):
        got = runs[rank, "f32"]
        assert set(got["metrics"]) == set(ref["metrics"])
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=2e-2 if k == "g_loss" else 1e-4, atol=1e-5,
                                       err_msg=k)
        for key, atol in (("g_params", 1e-3), ("ema", 1e-5)):
            assert set(got[key]) <= set(ref[key])
            for k, v in got[key].items():
                np.testing.assert_allclose(v, ref[key][k], atol=atol, rtol=0, err_msg=f"{key}.{k}")
