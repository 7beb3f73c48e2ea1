"""The port's GAN stack under a bf16 compute dtype (``dtype=torch.bfloat16``)
against the JAX package's bf16 modules (``dtype=jnp.bfloat16``) on the CPU,
at tiny widths: gf 8, df 8, embedding 32, z and condition 16, 8 words,
batch 2.

Both packages take the same numpy-seeded weights (f32 parameters: the JAX
init perturbed, or the port's seeded state dicts carried across) and the
same inputs.  Each output is held to JAX's bf16 output within a share of
JAX's own bf16-to-f32 distance (``BF16_SHARE``): the port rounds where JAX
rounds, so it lands far nearer JAX's bf16 than bf16 lands from f32, while
a cast left out or added (BatchNorm moments taken in bf16, the attention's
scores without f32 accumulation) moves it by about that distance.  With
f32 left as it is, the modules are those of tests/test_torch_generator.py
and tests/test_torch_train.py.

The bf16 text encoder: the JAX ``RNNEncoder(dtype=bfloat16)`` raises in its
``lax.scan`` (the bf16 initial carry against the f32 state its cell gives
back: its f32 weights promote the bf16 words), so the port is held to what
that promotion computes, JAX's f32 encoder on the embedding table rounded
to bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from tise_tpu.backbones import damsm as jdamsm
from tise_tpu.models.attngan_pp import discriminator as jdisc
from tise_tpu.models.attngan_pp import generator as jgenerator
from tise_tpu.models.counter_model import discriminator as jcdisc
from tise_tpu.models.counter_model import generator as jcounter
from tise_tpu_torch.backbones import damsm
from tise_tpu_torch.models import weights as tweights
from tise_tpu_torch.models.attngan_pp.discriminator import DNet
from tise_tpu_torch.models.attngan_pp.generator import GanConfig
from tise_tpu_torch.models.counter_model.discriminator import MSGDNet

B, T = 2, 8
NDF, NEF = 8, 32
BF16 = jnp.bfloat16
#: the port's distance to JAX's bf16 output, as a share of JAX's bf16 output's distance to its f32 one
BF16_SHARE = 0.25


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.float().permute(0, 2, 3, 1).numpy()


def f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def assert_bf16(name: str, got, ref_bf16, ref_f32, share: float = BF16_SHARE) -> float:
    """The port's bf16 ``got`` within ``share`` of JAX's bf16-to-f32
    distance (L2) of JAX's bf16 ``ref_bf16``; that distance is not 0 (bf16
    was computed).  Returns the ratio."""
    got, ref_bf16, ref_f32 = (np.asarray(a, np.float64) for a in (got, ref_bf16, ref_f32))
    assert got.shape == ref_bf16.shape == ref_f32.shape, (name, got.shape, ref_bf16.shape)
    spread = np.linalg.norm(ref_bf16 - ref_f32)
    assert spread > 1e-4 * np.linalg.norm(ref_f32), (name, "bf16 equals f32")
    err = np.linalg.norm(got - ref_bf16)
    print(f"{name}: port to JAX bf16 {err:.3e}, JAX bf16 to f32 {spread:.3e} ({err / spread:.3f})")
    assert err <= share * spread, (name, err, spread)
    return err / spread


def tiny(r_num: int) -> GanConfig:
    return GanConfig(gf_dim=8, embedding_dim=NEF, z_dim=16, condition_dim=16, words_num=T, r_num=r_num)


def jax_cfg(cfg: GanConfig):
    return jgenerator.GanConfig(gf_dim=cfg.gf_dim, embedding_dim=cfg.embedding_dim, z_dim=cfg.z_dim,
                                condition_dim=cfg.condition_dim, words_num=cfg.words_num, r_num=cfg.r_num)


def perturbed(variables, seed):
    """Numpy leaves; BatchNorm scale 1 + N(0, 0.1), shift N(0, 0.1), mean
    N(0, 0.1), var U(0.5, 1.5) (tests/test_torch_generator.py)."""
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


JAX_NETS = {"attngan_pp": jgenerator.GNet, "counter_model": jcounter.CounterGNet}


@pytest.fixture(scope="module", params=[("attngan_pp", 2, True), ("attngan_pp", 2, False), ("counter_model", 1, True)],
                ids=lambda p: f"{p[0]}-r{p[1]}-{'train' if p[2] else 'eval'}")
def gen_triple(request):
    """One JAX init of the generator, perturbed; its JAX forward in f32 and
    in bf16 (train mode: the batch's moments, the running statistics
    moved), and the port's in bf16.  CA's eps is what each JAX module
    draws from its key (in bf16 under bf16)."""
    model, r_num, train = request.param
    cfg = tiny(r_num)
    rng = np.random.RandomState(r_num)
    mask = np.zeros((B, T), bool)
    mask[0, 5:] = True
    mask[1] = True  # all padding
    x = {"z": rng.standard_normal((B, cfg.z_dim)).astype(np.float32),
         "sent": rng.standard_normal((B, NEF)).astype(np.float32),
         "words": rng.standard_normal((B, NEF, T)).astype(np.float32), "mask": mask}
    key = jax.random.PRNGKey(r_num)
    args = (jnp.asarray(x["z"]), jnp.asarray(x["sent"]), jnp.asarray(x["words"]), jnp.asarray(x["mask"]), key)
    init_net = JAX_NETS[model](cfg=jax_cfg(cfg))
    variables = perturbed(jax.jit(lambda k, *a: init_net.init(k, *a, train=False))(jax.random.PRNGKey(7), *args),
                          seed=r_num)
    ref = {}
    for name, dtype in (("f32", jnp.float32), ("bf16", BF16)):
        jnet = JAX_NETS[model](cfg=jax_cfg(cfg), dtype=dtype)
        out, mut = jax.jit(lambda v, *a: jnet.apply(v, *a, train=train, mutable=["batch_stats"]))(variables, *args)
        ref[name] = (jax.device_get(out), jax.device_get(mut["batch_stats"]))
    state = tweights.g_state_dict_from_jax_params(variables["params"], variables["batch_stats"], model)
    net = tweights.load_generator(state, cfg, model, device="cpu", dtype=torch.bfloat16).train(train)
    eps = np.asarray(jax.random.normal(key, (B, cfg.condition_dim), dtype=BF16), np.float32)
    with torch.no_grad():
        got = net(t(x["z"]), t(x["sent"]), t(x["words"]), torch.from_numpy(mask), t(eps))
    return {"model": model, "train": train, "ref": ref, "got": got, "net": net}


def test_generator_bf16_matches_jax(gen_triple):
    """Every image and attention map, mu and logvar within ``BF16_SHARE``
    of JAX's bf16-to-f32 distance of JAX's bf16 output; the images, mu and
    logvar come out bf16 and the maps f32, as in JAX."""
    (jimgs, jattn, jmu, jlogvar), _ = gen_triple["ref"]["bf16"]
    (fimgs, fattn, fmu, flogvar), _ = gen_triple["ref"]["f32"]
    imgs, attn, mu, logvar = gen_triple["got"]
    assert all(i.dtype == torch.bfloat16 for i in imgs) and mu.dtype == logvar.dtype == torch.bfloat16
    assert all(a.dtype == torch.float32 for a in attn)
    assert [np.asarray(j).dtype for j in jimgs] == [BF16] * len(imgs)
    for i, (g, r, f) in enumerate(zip(imgs, jimgs, fimgs)):
        assert_bf16(f"image {g.shape[-1]} px", nhwc(g), f32(r), f32(f))
    for i, (g, r, f) in enumerate(zip(attn, jattn, fattn)):
        assert_bf16(f"attention {i}", g.numpy(), f32(r), f32(f))
    assert_bf16("mu", mu.float().numpy(), f32(jmu), f32(fmu))
    assert_bf16("logvar", logvar.float().numpy(), f32(jlogvar), f32(flogvar))


def test_generator_bf16_running_statistics(gen_triple):
    """In train mode the running statistics (f32 buffers) move as JAX's
    bf16 module moves them: within ``BF16_SHARE`` of JAX's bf16-to-f32
    distance; in eval mode they are left as they were."""
    model, net = gen_triple["model"], gen_triple["net"]
    ref = tweights.g_state_dict_from_jax_params({}, gen_triple["ref"]["bf16"][1], model)
    ref32 = tweights.g_state_dict_from_jax_params({}, gen_triple["ref"]["f32"][1], model)
    got = net.state_dict()
    keys = sorted(k for k in ref if k.endswith(("running_mean", "running_var")))
    assert keys and all(got[k].dtype == torch.float32 for k in keys)
    flat = lambda d: np.concatenate([np.ravel(np.asarray(d[k], np.float64)) for k in keys])  # noqa: E731
    if gen_triple["train"]:
        assert_bf16("running statistics", flat({k: got[k].numpy() for k in keys}), flat(ref), flat(ref32))
    else:
        assert np.array_equal(flat({k: got[k].numpy() for k in keys}), flat(ref))


def test_bf16_parameters_stay_f32():
    """Every parameter and buffer of a bf16 G, D and MSG D is f32, and the
    weight converters load them as they are."""
    cfg = tiny(1)
    g = tweights.load_generator(tweights.random_g_state_dict(0, cfg), cfg, device="cpu", dtype=torch.bfloat16)
    d = DNet(NDF, NEF, 64, dtype=torch.bfloat16)
    d.load_state_dict({k: t(v) for k, v in tweights.random_d_state_dict(0, NDF, NEF, 64).items()}, strict=True)
    m = MSGDNet(NDF, NEF, dtype=torch.bfloat16)
    m.load_state_dict({k: t(v) for k, v in tweights.random_msg_d_state_dict(0, NDF, NEF).items()}, strict=True)
    for module in (g, d, m):
        assert all(v.dtype in (torch.float32, torch.int64) for v in module.state_dict().values())


# ---------------------------------------------------------------------------
# discriminators
# ---------------------------------------------------------------------------


def d_images(rng: np.random.RandomState, sides) -> list:
    shift = np.array([0.5, 0.0, -0.5], np.float32)
    return [(rng.standard_normal((B, s, s, 3)) * 0.4 + shift).astype(np.float32) for s in sides]


def d_case(which: str):
    """(JAX module factory, the port's bf16 module with the same seeded
    weights, the JAX params and u, the images (NHWC), the trunk's block
    names in order)."""
    if which == "msg":
        state = tweights.random_msg_d_state_dict(5, NDF, NEF)
        net = MSGDNet(NDF, NEF, dtype=torch.bfloat16)
        make = lambda dtype: jcdisc.MSGDNet(ndf=NDF, nef=NEF, dtype=dtype)  # noqa: E731
        sides, blocks = (4, 8, 16, 32, 64, 128, 256), ["fRGB_0"] + [f"block{i}" for i in range(6)]
    else:
        scale = int(which[1:])
        state = tweights.random_d_state_dict(5, NDF, NEF, scale)
        net = DNet(NDF, NEF, scale, dtype=torch.bfloat16)
        make = lambda dtype: jdisc.DNet(ndf=NDF, nef=NEF, scale=scale, dtype=dtype)  # noqa: E731
        sides, blocks = (scale,), [n for n in ("s16", "s32", "s32_1", "s64", "s64_1", "s64_2") if hasattr(net, n)]
    net.load_state_dict({k: t(a) for k, a in state.items()}, strict=True)
    params, spectral = tweights.jax_params_from_d_state_dict(state)
    images = d_images(np.random.RandomState({"d64": 1, "d256": 2, "msg": 3}[which]), sides)
    return make, net, {"params": params, "spectral": spectral}, images, blocks


def jax_block(make, dtype, name: str):
    """One trunk block of the JAX D (MSG blocks by index), jitted:
    (variables, input NHWC) -> output."""
    def call(m, h):
        if name.startswith("block"):
            return m.blocks[int(name[5:])](h, True)
        return getattr(m, name)(h) if name == "fRGB_0" else getattr(m, name)(h, True)

    jd = make(dtype)
    return jax.jit(lambda v, h: jd.apply(v, h, method=call, mutable=["spectral"])[0])


def block_input(name: str, prev, images):
    """A block's input: the finest image for the first, the previous
    block's output (with the next smaller image before it, MSG blocks 1-5)."""
    if prev is None:
        return images[-1]
    if name.startswith("block") and name != "block0":
        return np.concatenate([images[-1 - int(name[5:])], prev], axis=-1)
    return prev


@pytest.mark.parametrize("which", ["d64", "d256", "msg"])
def test_discriminator_bf16_matches_jax(which):
    """Block by block, each block of the port's bf16 trunk fed JAX's bf16
    input to it: its output within ``BF16_SHARE`` of the distance from
    JAX's bf16 block to JAX's f32 block on that input; then both heads on
    JAX's bf16 features the same way, the logits bf16.  A difference of one
    rounding grows through a trunk (the D256 trunk's five blocks run by
    themselves come to 0.05, 0.11, 0.22, 0.38 and 0.51 of the distance), so
    the whole trunk run by itself is held only within that distance.  The u
    the trunk stores (f32, from the f32 weights) equals JAX's within 1e-6."""
    make, net, v, images, blocks = d_case(which)
    c = np.random.RandomState(9).standard_normal((B, NEF)).astype(np.float32)
    prev = None
    for name in blocks:
        x = block_input(name, prev, images)
        ref, ref32 = (np.asarray(jax_block(make, d, name)(v, x).astype(jnp.float32)) for d in (BF16, jnp.float32))
        xin = torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy())
        with torch.no_grad():
            got = getattr(net, name)(xin if name == "fRGB_0" or prev is None else xin.to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        assert_bf16(f"{which} {name}", nhwc(got), ref, ref32)
        prev = ref
    heads = {}
    for d in (BF16, jnp.float32):
        jd = make(d)
        heads[d] = jax.device_get(jax.jit(lambda v, h: (
            jd.apply(v, h, c, method=jd.cond_logits, mutable=["spectral"])[0],
            jd.apply(v, h, method=jd.uncond_logits, mutable=["spectral"])[0]))(v, prev.astype(BF16)))
    h = torch.from_numpy(np.transpose(prev, (0, 3, 1, 2)).copy()).to(torch.bfloat16)
    with torch.no_grad():
        cond, uncond = net.cond_logits(h, t(c)), net.uncond_logits(h)
    assert cond.dtype == uncond.dtype == torch.bfloat16
    assert_bf16(f"{which} cond logits", cond.float().numpy(), f32(heads[BF16][0]), f32(heads[jnp.float32][0]))
    assert_bf16(f"{which} uncond logits", uncond.float().numpy(), f32(heads[BF16][1]), f32(heads[jnp.float32][1]))

    trunk = {}
    for d in (BF16, jnp.float32):
        jd = make(d)
        trunk[d] = jax.device_get(jax.jit(lambda v: jd.apply(
            v, images if which == "msg" else images[0], method=jd.features, mutable=["spectral"]))(v))
    tin = [t(np.transpose(x, (0, 3, 1, 2))) for x in images]
    with torch.no_grad():
        feats = net.features(tin if which == "msg" else tin[0], update_stats=True)
    assert_bf16(f"{which} trunk", nhwc(feats), f32(trunk[BF16][0]), f32(trunk[jnp.float32][0]), share=1.0)
    net.commit_spectral()
    stored = tweights.d_state_dict_from_jax_params(v["params"], trunk[BF16][1]["spectral"])
    for k, a in net.state_dict().items():
        if k.endswith(".u") and not k.startswith(("cond_head", "uncond_head")):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), stored[k], rtol=0, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the DAMSM text encoder
# ---------------------------------------------------------------------------


def test_rnn_encoder_bf16():
    """JAX's bf16 ``RNNEncoder`` raises in its scan (the carry's dtype); the
    port's bf16 encoder equals, within 1e-5 of the scale, JAX's f32 encoder
    on the embedding table rounded to bf16 (what JAX's promotion computes:
    the rounded words through the f32 cell), gives f32, and differs from
    the port's f32 encoder by that rounding."""
    ntoken, nhidden = 40, 16
    state = damsm.random_rnn_state_dict(3, ntoken, nhidden=nhidden)
    rng = np.random.RandomState(4)
    lens = np.array([T, 3, 5], np.int32)
    caps = np.zeros((3, T), np.int32)
    for i, n in enumerate(lens):
        caps[i, :n] = rng.randint(1, ntoken, n)
    params = jdamsm.rnn_params_from_torch(state)
    with pytest.raises(TypeError, match="scan body function carry input and carry output must have equal types"):
        jdamsm.RNNEncoder(ntoken=ntoken, nhidden=nhidden, dtype=BF16).apply(params, caps, lens)
    rounded = jax.tree_util.tree_map(np.asarray, params)
    rounded["params"]["embedding"] = f32(rounded["params"]["embedding"].astype(BF16)).astype(np.float32)
    jwords, jsent = jax.jit(jdamsm.RNNEncoder(ntoken=ntoken, nhidden=nhidden).apply)(rounded, caps, lens)
    enc16 = damsm.RNNEncoder.from_state_dict(state, device="cpu", dtype=torch.bfloat16)
    enc32 = damsm.RNNEncoder.from_state_dict(state, device="cpu")
    words, sent = enc16(torch.from_numpy(caps), lens)
    words32, _ = enc32(torch.from_numpy(caps), lens)
    assert words.dtype == sent.dtype == torch.float32
    scale = float(np.abs(np.asarray(jwords)).max())
    np.testing.assert_allclose(words.numpy(), np.asarray(jwords), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(sent.numpy(), np.asarray(jsent), rtol=0, atol=1e-5 * scale)
    assert float((words - words32).abs().max()) > 1e-4 * scale
