"""The port's InceptionV3 (tise_tpu_torch.backbones.inception_v3) against the
JAX package's on the CPU.

One numpy-made, well-conditioned torchvision-layout state_dict goes into
both packages (the JAX side through params_from_torch_state_dict).  At a
75 px input Mixed_7b and 7c pool over 1x1 maps, which drives the n == 1 edge
of the pool's _edge_inv weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from tise_tpu.backbones import inception_v3 as jinception
from tise_tpu_torch.backbones import inception_v3 as tinception
from tise_tpu_torch.core.weights import state_dict_from_jax_params

NUM_CLASSES = 10


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def state_dict():
    return tinception.random_state_dict(seed=3, num_classes=NUM_CLASSES)


@pytest.fixture(scope="module")
def jax_params(state_dict):
    return jinception.params_from_torch_state_dict(state_dict, num_classes=NUM_CLASSES)


@pytest.mark.parametrize("pool_variant", ["torch", "tf", "tf2015"])
def test_all_endpoints_match_jax(state_dict, jax_params, pool_variant):
    """Every endpoint within rtol 1e-4, atol 1e-4 * max|ref| (the tolerance
    of tests/test_inception.py's torch oracle)."""
    x = np.random.RandomState(0).randn(2, 75, 75, 3).astype(np.float32) * 0.5
    jmodel = jinception.InceptionV3(num_classes=NUM_CLASSES, pool_variant=pool_variant)
    jout = jax.jit(lambda p, v: jmodel.apply(p, v, endpoints=jinception.ENDPOINTS))(jax_params, jnp.asarray(x))
    tmodel = tinception.InceptionV3.from_state_dict(state_dict, pool_variant=pool_variant, device="cpu")
    tout = tmodel(torch.from_numpy(x), endpoints=tinception.ENDPOINTS)
    assert set(tout) == set(tinception.ENDPOINTS)
    for name in tinception.ENDPOINTS:
        ref = np.asarray(jout[name], np.float32)
        got = tout[name].numpy()
        assert got.shape == ref.shape, name
        scale = max(np.abs(ref).max(), 1e-3)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale, err_msg=f"endpoint {name}")


def test_weights_round_trip_through_jax_layout(state_dict):
    """state_dict_from_jax_params inverts params_from_torch_state_dict exactly."""
    back = state_dict_from_jax_params(jinception.params_from_torch_state_dict(state_dict, NUM_CLASSES))
    assert set(back) == set(state_dict)
    for k, v in state_dict.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_endpoint_shapes_and_pool3_scale(state_dict):
    """The well-conditioned init keeps pool3 from collapsing at 299 px."""
    model = tinception.InceptionV3.from_state_dict(state_dict, device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 299, 299, 3).astype(np.float32) * 0.5)
    out = model(x, endpoints=("maxpool1", "maxpool2", "mixed6e", "pool3"))
    assert out["maxpool1"].shape == (1, 73, 73, 64)
    assert out["maxpool2"].shape == (1, 35, 35, 192)
    assert out["mixed6e"].shape == (1, 17, 17, 768)
    assert out["pool3"].shape == (1, 2048)
    assert float(out["pool3"].std()) > 1e-2


def test_from_state_dict_ignores_aux_and_counters(state_dict):
    sd = dict(state_dict)
    sd["AuxLogits.fc.weight"] = np.zeros((3, 768), np.float32)
    sd["Mixed_5b.branch1x1.bn.num_batches_tracked"] = np.zeros((), np.int64)
    model = tinception.InceptionV3.from_state_dict(sd, device="cpu")
    assert model.fc.out_features == NUM_CLASSES


def test_from_state_dict_rejects_missing_keys(state_dict):
    sd = {k: v for k, v in state_dict.items() if not k.startswith("Mixed_7c.branch_pool")}
    with pytest.raises(KeyError, match="Mixed_7c.branch_pool"):
        tinception.InceptionV3.from_state_dict(sd, device="cpu")


def test_random_state_dict_is_seeded():
    a = tinception.random_state_dict(seed=5, num_classes=4)
    b = tinception.random_state_dict(seed=5, num_classes=4)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert a["fc.weight"].shape == (4, 2048)


def test_unknown_endpoint_and_variant_raise(state_dict):
    with pytest.raises(ValueError):
        tinception.InceptionV3(pool_variant="slim")
    model = tinception.InceptionV3.from_state_dict(state_dict, device="cpu")
    with pytest.raises(ValueError):
        model(torch.zeros(1, 75, 75, 3), endpoints=("mixed7c",))
