"""The port's generators (tise_tpu_torch.models) against the JAX package's on
the CPU, at tiny widths: gf_dim 8, embedding 32, z and condition 16, 8 words,
batch 2, r_num 1 and 2.

Weights are the JAX modules' own init, with every BatchNorm scale, shift and
running moment perturbed, carried across by ``g_state_dict_from_jax_params``
and loaded strictly; ``z`` and CA's ``eps`` are the same arrays on both
sides (``eps`` is what the JAX CANet draws from its key).  Every output is
held within 1e-5 absolute (images in [-1, 1], attention in [0, 1]), mu and
logvar within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from tise_tpu.models.attngan_pp import attention as jattention
from tise_tpu.models.attngan_pp import generator as jgenerator
from tise_tpu.models.attngan_pp import layers as jlayers
from tise_tpu.models.counter_model import generator as jcounter
from tise_tpu_torch.models import gen_bench
from tise_tpu_torch.models import weights as tweights
from tise_tpu_torch.models.attngan_pp import attention as tattention
from tise_tpu_torch.models.attngan_pp import layers as tlayers
from tise_tpu_torch.models.attngan_pp.generator import GanConfig

B, T = 2, 8
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


def tiny(r_num: int) -> GanConfig:
    return GanConfig(gf_dim=8, embedding_dim=32, z_dim=16, condition_dim=16, words_num=T, r_num=r_num)


def jax_cfg(cfg: GanConfig):
    return jgenerator.GanConfig(gf_dim=cfg.gf_dim, embedding_dim=cfg.embedding_dim, z_dim=cfg.z_dim,
                                condition_dim=cfg.condition_dim, words_num=cfg.words_num, r_num=cfg.r_num)


def perturbed(variables, seed):
    """Numpy leaves; BatchNorm scale 1 + N(0, 0.1), shift N(0, 0.1), mean
    N(0, 0.1), var U(0.5, 1.5), so that the running statistics matter."""
    rng = np.random.RandomState(seed)

    def visit(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        leaf = np.asarray(leaf)
        if "bn" in names[:-1]:
            if names[-1] == "var":
                return (leaf * rng.uniform(0.5, 1.5, leaf.shape)).astype(np.float32)
            return (leaf + rng.normal(0, 0.1, leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(visit, jax.tree_util.tree_map(np.asarray, variables))


def inputs(cfg: GanConfig, seed: int = 0, pad_all: bool = False):
    """z, sent_emb, word_embs [B, nef, T], mask (row 0: 5 words, row 1: all
    padding when ``pad_all``) and the key CA draws ``eps`` from."""
    rng = np.random.RandomState(seed)
    mask = np.zeros((B, T), bool)
    mask[0, 5:] = True
    if pad_all:
        mask[1] = True
    key = jax.random.PRNGKey(seed)
    return {"z": rng.standard_normal((B, cfg.z_dim)).astype(np.float32),
            "sent": rng.standard_normal((B, cfg.embedding_dim)).astype(np.float32),
            "words": rng.standard_normal((B, cfg.embedding_dim, T)).astype(np.float32),
            "mask": mask, "key": key,
            "eps": np.array(jax.random.normal(key, (B, cfg.condition_dim)))}


def port_forward(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(x["z"]), torch.from_numpy(x["sent"]), torch.from_numpy(x["words"]),
                   torch.from_numpy(x["mask"]), torch.from_numpy(x["eps"]))


JAX_NETS = {"attngan_pp": jgenerator.GNet, "counter_model": jcounter.CounterGNet}


@pytest.fixture(scope="module", params=[("attngan_pp", 1), ("attngan_pp", 2), ("counter_model", 1),
                                        ("counter_model", 2)], ids=lambda p: f"{p[0]}-r{p[1]}")
def pair(request):
    """The JAX generator's init, perturbed, its forward, and the port's."""
    model, r_num = request.param
    cfg = tiny(r_num)
    x = inputs(cfg, seed=r_num, pad_all=True)
    jnet = JAX_NETS[model](cfg=jax_cfg(cfg))
    args = (jnp.asarray(x["z"]), jnp.asarray(x["sent"]), jnp.asarray(x["words"]), jnp.asarray(x["mask"]), x["key"])
    variables = perturbed(jax.jit(lambda k, *a: jnet.init(k, *a, train=False))(jax.random.PRNGKey(7), *args),
                          seed=r_num)
    ref = jax.jit(lambda v, *a: jnet.apply(v, *a, train=False))(variables, *args)
    state = tweights.g_state_dict_from_jax_params(variables["params"], variables["batch_stats"], model)
    net = tweights.load_generator(state, cfg, model, device="cpu")
    return {"model": model, "cfg": cfg, "x": x, "variables": variables, "ref": ref, "got": port_forward(net, x)}


def test_generator_matches_jax(pair):
    """GNet: 3 images (64, 128, 256 px) and 2 maps; CounterGNet: 7 images (4
    to 256 px) and 2 maps; an all-padding caption among the inputs."""
    (jimgs, jattn, jmu, jlogvar), (imgs, attn, mu, logvar) = pair["ref"], pair["got"]
    sides = [64, 128, 256] if pair["model"] == "attngan_pp" else [4, 8, 16, 32, 64, 128, 256]
    assert [i.shape[-1] for i in imgs] == sides and len(attn) == len(jattn) == 2
    for got, ref in zip(imgs, jimgs):
        ref = np.asarray(ref)
        assert got.shape == (B, 3, ref.shape[1], ref.shape[2])
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=ATOL)
        assert float(np.abs(ref).std()) > 1e-3  # the images are not flat
    for got, ref in zip(attn, jattn):
        assert got.shape == ref.shape and got.shape[-1] == T
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    np.testing.assert_allclose(attn[0][1].numpy(), 1.0 / T, rtol=1e-6)  # all padding: uniform, not NaN
    for got, ref in ((mu, jmu), (logvar, jlogvar)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)


def test_weights_round_trip(pair):
    """JAX tree -> state dict -> JAX tree gives back every leaf."""
    params, stats = tweights.jax_params_from_g_state_dict(
        tweights.g_state_dict_from_jax_params(pair["variables"]["params"], pair["variables"]["batch_stats"],
                                              pair["model"]))
    for mine, ref in ((params, pair["variables"]["params"]), (stats, pair["variables"]["batch_stats"])):
        got_leaves, got_tree = jax.tree_util.tree_flatten(mine)
        ref_leaves, ref_tree = jax.tree_util.tree_flatten(jax.tree_util.tree_map(np.asarray, ref))
        assert got_tree == ref_tree
        assert all(np.array_equal(a, b) for a, b in zip(got_leaves, ref_leaves))


def test_random_state_dict_has_the_modules_keys(pair):
    sd = tweights.random_g_state_dict(0, pair["cfg"], pair["model"])
    net = tweights.load_generator(sd, pair["cfg"], pair["model"], device="cpu")
    imgs = port_forward(net, pair["x"])[0]
    assert all(torch.isfinite(i).all() for i in imgs)
    again = tweights.random_g_state_dict(0, pair["cfg"], pair["model"])
    assert all(np.array_equal(sd[k], again[k]) for k in sd)


# ---------------------------------------------------------------------------
# the blocks one by one
# ---------------------------------------------------------------------------


def _block_pair(jmod, tmod, x_nhwc, seed):
    variables = perturbed(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x_nhwc), False), seed)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x_nhwc), False))
    tmod.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in tweights.g_state_dict_from_jax_params(
        variables["params"], variables["batch_stats"]).items()}, strict=True)
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    return got, ref


def test_glu_and_upsample_match_jax():
    x = np.random.RandomState(0).standard_normal((B, 5, 6, 8)).astype(np.float32)
    np.testing.assert_allclose(tlayers.glu(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy(),
                               np.asarray(jlayers.glu(jnp.asarray(x))), rtol=0, atol=ATOL)
    flat = x.reshape(B, -1)
    np.testing.assert_allclose(tlayers.glu(torch.from_numpy(flat)).numpy(), np.asarray(jlayers.glu(flat)),
                               rtol=0, atol=ATOL)
    up = tlayers.nearest_upsample(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert np.array_equal(up, np.asarray(jlayers.nearest_upsample(jnp.asarray(x))))


@pytest.mark.parametrize("block", ["up", "res"])
def test_blocks_match_jax(block):
    x = np.random.RandomState(1).standard_normal((B, 6, 5, 8)).astype(np.float32)
    if block == "up":
        jmod, tmod = jlayers.UpBlock(features=4), tlayers.UpBlock(8, 4)
    else:
        jmod, tmod = jlayers.ResBlockG(channels=8), tlayers.ResBlockG(8)
    got, ref = _block_pair(jmod, tmod, x, seed=3)
    assert got.shape == ref.shape == ((B, 12, 10, 4) if block == "up" else x.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_spatial_attention_matches_jax():
    """Output and map within 1e-5, one caption all padding (a uniform map)."""
    rng = np.random.RandomState(2)
    h = rng.standard_normal((B, 4, 6, 8)).astype(np.float32)
    words = rng.standard_normal((B, 32, T)).astype(np.float32)
    mask = np.zeros((B, T), bool)
    mask[0, 3:] = True
    mask[1] = True
    jmod = jattention.SpatialAttention(idf=8)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(words), jnp.asarray(mask))
    jout, jattn = jmod.apply(params, jnp.asarray(h), jnp.asarray(words), jnp.asarray(mask))
    tmod = tattention.SpatialAttention(32, 8)
    tmod.load_state_dict({k: torch.from_numpy(v) for k, v in tweights.g_state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params["params"]), {}).items()}, strict=True)
    with torch.no_grad():
        out, attn = tmod(torch.from_numpy(h).permute(0, 3, 1, 2), torch.from_numpy(words), torch.from_numpy(mask))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(jout), rtol=0, atol=ATOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(jattn), rtol=0, atol=ATOL)
    assert np.isfinite(attn.numpy()).all() and np.allclose(attn[1].numpy(), 1.0 / T)
    assert float(attn[0, ..., 3:].max()) < 1e-30  # padding gets no weight


# ---------------------------------------------------------------------------
# the JAX CLIs' r_num fault, and the port's refusal
# ---------------------------------------------------------------------------


def test_r_num_3_tree_under_r_num_2():
    """The JAX ``GNet(r_num=2)`` applies an ``r_num=3`` tree without a word
    (``h_net2`` holds res0-res2; res2 is dropped) and returns 256 px
    images; the port's strict load refuses it and names the res2 keys."""
    cfg3, cfg2 = tiny(3), tiny(2)
    x = inputs(cfg3)
    args = (jnp.asarray(x["z"]), jnp.asarray(x["sent"]), jnp.asarray(x["words"]), jnp.asarray(x["mask"]), x["key"])
    variables = jax.jit(lambda k, *a: jgenerator.GNet(cfg=jax_cfg(cfg3)).init(k, *a, train=False))(
        jax.random.PRNGKey(0), *args)
    assert set(variables["params"]["h_net2"]) == {"attn", "res0", "res1", "res2", "up"}
    imgs = jax.jit(lambda v, *a: jgenerator.GNet(cfg=jax_cfg(cfg2)).apply(v, *a, train=False))(variables, *args)[0]
    assert imgs[-1].shape == (B, 256, 256, 3)
    state = tweights.g_state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, variables["params"]),
                                                  jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    with pytest.raises(RuntimeError, match=r"Unexpected key\(s\).*h_net2\.res2\.conv0\.weight"):
        tweights.load_generator(state, cfg2, device="cpu")
    assert tweights.load_generator(state, cfg3, device="cpu") is not None


def test_loader_refuses_a_missing_key_and_an_unknown_model():
    state = tweights.random_g_state_dict(0, tiny(1))
    del state["img_net3.img.weight"]
    with pytest.raises(RuntimeError, match=r"Missing key\(s\).*img_net3\.img\.weight"):
        tweights.load_generator(state, tiny(1), device="cpu")
    with pytest.raises(ValueError, match="unknown generator"):
        tweights.make_generator("stackgan", tiny(1))


def test_generator_without_device_raises_where_there_is_no_card():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="--device cpu"):
        tweights.load_generator(tweights.random_g_state_dict(0, tiny(1)), tiny(1))


def test_gen_bench_chain_runs_at_tiny_dims():
    """The bench's chain (text encoder, noise, G) at tiny dims on the CPU:
    a finite sum, and a changed seed changes it."""
    tiny_bench = GanConfig(gf_dim=8, df_dim=32, r_num=1, words_num=20, embedding_dim=32)  # the JAX bench's CPU dims
    bench = gen_bench.build(device="cpu", gan=tiny_bench, ntoken=64, batch=2, chain=2)
    a, b = float(bench.chain_fn(0)), float(bench.chain_fn(1))
    assert np.isfinite(a) and np.isfinite(b) and a != b
    assert bench.batch == 2 and bench.chain == 2
