"""The port's DAMSM encoders (tise_tpu_torch.backbones.damsm) against the JAX
package's on the CPU, at full width: embedding 300, 2 x 128 LSTM units,
nef 256, a vocabulary of 5,450 words (the CUB ``ntoken``) and the whole
InceptionV3 trunk at 299.

Seeded numpy weights in the reference's ``.pth`` layout go to the JAX package
through its own converters (``rnn_params_from_torch``, ``cnn_params_from_torch``)
and come back to the port through ``*_state_dict_from_jax_params``, so each
comparison also carries the JAX weights across.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from tise_tpu.backbones import damsm as jdamsm
from tise_tpu.core import weights as jweights
from tise_tpu.ops.preprocess import normalize as jnormalize
from tise_tpu_torch.backbones import damsm as tdamsm
from tise_tpu_torch.ops.preprocess import normalize

NTOKEN = 5450


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def rnn_weights():
    sd = tdamsm.random_rnn_state_dict(seed=0, ntoken=NTOKEN)
    params = jdamsm.rnn_params_from_torch(sd)
    return {"reference": sd, "jax": params, "port": tdamsm.rnn_state_dict_from_jax_params(params)}


@pytest.fixture(scope="module")
def cnn_weights():
    sd = tdamsm.random_cnn_state_dict(seed=0)
    params = jax.tree_util.tree_map(np.asarray, jdamsm.cnn_params_from_torch(sd))
    return {"reference": sd, "jax": params, "port": tdamsm.cnn_state_dict_from_jax_params(params)}


def _captions(lengths, t, seed):
    rng = np.random.RandomState(seed)
    caps = np.zeros((len(lengths), t), np.int32)
    for i, n in enumerate(lengths):
        caps[i, :n] = rng.randint(1, NTOKEN, n)
    return caps


@pytest.mark.parametrize("lengths,t", [([1, 12, 5, 3, 12, 7], 12), ([25, 1, 32, 17], 32), ([1], 4)])
def test_rnn_encoder_matches_jax(rnn_weights, lengths, t):
    """words_emb [B, 256, T] (zero past each length) and sent_emb [B, 256]
    within 1e-5 of the output's scale, over lengths that include 1 and T."""
    caps, lens = _captions(lengths, t, seed=len(lengths)), np.asarray(lengths, np.int32)
    jwords, jsent = jdamsm.RNNEncoder(ntoken=NTOKEN).apply(rnn_weights["jax"], jnp.asarray(caps), jnp.asarray(lens))
    model = tdamsm.RNNEncoder.from_state_dict(rnn_weights["port"], device="cpu")
    words, sent = model(torch.from_numpy(caps), lens)
    assert words.shape == (len(lengths), 256, t) and sent.shape == (len(lengths), 256)
    for got, ref in ((words.numpy(), np.asarray(jwords)), (sent.numpy(), np.asarray(jsent))):
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)
    for i, n in enumerate(lengths):
        assert not words[i, :, n:].any() and words[i, :, n - 1].abs().max() > 0


def test_cnn_encoder_matches_jax(cnn_weights):
    """Region features [2, 17, 17, 256] and cnn_code [2, 256] of two 256 px
    images, normalized under "half", within rtol 1e-4 and atol 1e-4 * max|ref|
    (tests/test_torch_inception.py's tolerance)."""
    u8 = np.random.RandomState(0).randint(0, 256, (2, 256, 256, 3)).astype(np.uint8)
    jfeat, jcode = jax.jit(lambda p, x: jdamsm.CNNEncoder().apply(p, jnormalize(x, "half")))(
        cnn_weights["jax"], jnp.asarray(u8))
    model = tdamsm.CNNEncoder.from_state_dict(cnn_weights["port"], device="cpu")
    feat, code = model(normalize(torch.from_numpy(u8), "half"))
    assert feat.shape == (2, 17, 17, 256) and code.shape == (2, 256)
    for got, ref in ((feat.numpy(), np.asarray(jfeat)), (code.numpy(), np.asarray(jcode))):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


def test_weights_round_trip(tmp_path, rnn_weights, cnn_weights):
    """JAX params -> the port's state dicts -> reference-layout .pth ->
    ``rnn_params_from_torch``/``cnn_params_from_torch`` -> the same arrays;
    and the port's loaders read the .pth and the JAX .npz alike."""
    for name, w, to_jax, load in (("text", rnn_weights, jdamsm.rnn_params_from_torch, tdamsm.load_rnn_state_dict),
                                  ("image", cnn_weights, jdamsm.cnn_params_from_torch, tdamsm.load_cnn_state_dict)):
        assert sorted(w["port"]) == sorted(w["reference"])
        pth, npz = str(tmp_path / f"{name}.pth"), str(tmp_path / f"{name}.npz")
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in w["port"].items()}, pth)
        jweights.save_pytree_npz(npz, w["jax"])
        again = jax.tree_util.tree_map(np.asarray, to_jax(jweights.load_torch_state_dict(pth)))
        ref_leaves, ref_tree = jax.tree_util.tree_flatten(jax.tree_util.tree_map(np.asarray, w["jax"]))
        got_leaves, got_tree = jax.tree_util.tree_flatten(again)
        assert got_tree == ref_tree
        assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(got_leaves, ref_leaves))
        for path in (pth, npz):
            loaded = load(path)
            assert sorted(loaded) == sorted(w["reference"])
            assert all(np.array_equal(loaded[k], w["reference"][k]) for k in loaded)


def test_loaders_refuse_other_layouts(cnn_weights):
    """A trunk key the port does not know, or a missing head, is an error."""
    sd = dict(cnn_weights["reference"])
    with pytest.raises(KeyError):
        tdamsm.CNNEncoder.from_state_dict({k: v for k, v in sd.items() if k != "emb_cnn_code.bias"}, device="cpu")
    with pytest.raises(KeyError, match="unexpected"):
        tdamsm.CNNEncoder.from_state_dict({**sd, "Mixed_8a.conv.weight": sd["Conv2d_1a_3x3.conv.weight"]},
                                          device="cpu")


@pytest.mark.parametrize("build", [tdamsm.RNNEncoder.from_state_dict, tdamsm.CNNEncoder.from_state_dict])
def test_encoders_without_device_raise_where_there_is_no_card(build):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="--device cpu"):
        build({})
