"""The port's bf16 fast trunk and device resize (tise_tpu_torch.backbones.
inception_fast, ops.preprocess.resize_*) against the JAX package's on the CPU.

One numpy-made torchvision-layout state dict goes into both packages (the JAX
side through params_from_torch_state_dict); inputs come from numpy seeds.
The trunk comparisons run at a 75 px input, where Mixed_7b/7c pool 1x1 maps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tise_tpu.backbones import inception_fast as jfast
from tise_tpu.backbones import inception_v3 as jinception
from tise_tpu.core import weights as jweights
from tise_tpu.metrics import fid as jfid
from tise_tpu.ops import preprocess as jpre
from tise_tpu_torch.backbones import inception_fast as tfast
from tise_tpu_torch.backbones import inception_v3 as tinception
from tise_tpu_torch.core import io as result_io
from tise_tpu_torch.metrics import extractor as textractor
from tise_tpu_torch.metrics import fid as tfid
from tise_tpu_torch.ops import preprocess as tpre

NUM_CLASSES = 10


@pytest.fixture(scope="module")
def state_dict():
    return tinception.random_state_dict(seed=3, num_classes=NUM_CLASSES)


@pytest.fixture(scope="module")
def jax_params(state_dict):
    return jinception.params_from_torch_state_dict(state_dict, num_classes=NUM_CLASSES)


@pytest.mark.parametrize("input_recipe", [None, "fid"])
def test_fold_tree_matches_jax(state_dict, jax_params, input_recipe):
    """Every folded kernel (OIHW here, HWIO there) and bias in f32 within
    1e-6 (relative, and of the tensor's scale): the same f32 algebra, with the
    rsqrt and the sums rounded by another library."""
    got = tfast.fold_tree(state_dict, torch.float32, input_recipe)
    ref = jfast.fold_tree(jax_params, jnp.float32, input_recipe)
    assert set(got["w"]) == set(ref["w"])
    for name, (jw, jb) in ref["w"].items():
        w, b = got["w"][name]
        jw, jb = np.transpose(np.asarray(jw), (3, 2, 0, 1)), np.asarray(jb).reshape(-1)
        np.testing.assert_allclose(w.numpy(), jw, rtol=1e-6, atol=1e-6 * np.abs(jw).max(), err_msg=name)
        np.testing.assert_allclose(b.numpy(), jb, rtol=1e-6, atol=1e-6 * np.abs(jb).max(), err_msg=name)
    np.testing.assert_array_equal(got["fc"][0].numpy(), np.asarray(ref["fc"][0]))
    np.testing.assert_array_equal(got["fc"][1].numpy(), np.asarray(ref["fc"][1]))


def test_fold_tree_casts_once_to_bf16(state_dict):
    """The bf16 kernels are the f32 fold rounded once; the biases stay f32."""
    f32 = tfast.fold_tree(state_dict, torch.float32)
    bf16 = tfast.fold_tree(state_dict, torch.bfloat16)
    for name, (w, b) in bf16["w"].items():
        assert w.dtype == torch.bfloat16 and b.dtype == torch.float32
        assert torch.equal(w, f32["w"][name][0].to(torch.bfloat16)), name
        assert torch.equal(b, f32["w"][name][1]), name


def test_fast_f32_all_endpoints_match_jax(state_dict, jax_params):
    """FastInception in f32, every endpoint, within rtol 1e-4 and atol 1e-4 of
    the endpoint's scale (the tolerance of the f32 module's parity test), and
    within the same of the port's own f32 module."""
    x = np.random.RandomState(0).randn(2, 75, 75, 3).astype(np.float32) * 0.5
    jmodel = jfast.FastInception(jax_params, jnp.float32)
    jout = jax.jit(lambda v: jmodel(v, endpoints=jinception.ENDPOINTS))(jnp.asarray(x))
    tout = tfast.FastInception(state_dict, torch.float32)(torch.from_numpy(x), endpoints=tinception.ENDPOINTS)
    mout = tinception.InceptionV3.from_state_dict(state_dict)(torch.from_numpy(x), endpoints=tinception.ENDPOINTS)
    assert set(tout) == set(tinception.ENDPOINTS)
    for name in tinception.ENDPOINTS:
        ref, got = np.asarray(jout[name], np.float32), tout[name].numpy()
        assert got.shape == ref.shape and tout[name].dtype == torch.float32, name
        scale = max(np.abs(ref).max(), 1e-3)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale, err_msg=f"endpoint {name} vs jax")
        np.testing.assert_allclose(got, mout[name].numpy(), rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=f"endpoint {name} vs the f32 module")


def test_fast_bf16_matches_jax_at_bf16_tolerance(state_dict, jax_params):
    """bf16: pool3 and logits within 0.04 of the reference's scale — the
    tolerance tests/test_inception.py holds the JAX fast path to — against
    the JAX bf16 fast path and against the port's f32 module."""
    x = np.random.RandomState(1).randn(2, 75, 75, 3).astype(np.float32) * 0.5
    jmodel = jfast.FastInception(jax_params, jnp.bfloat16)
    jout = jax.jit(lambda v: jmodel(v, endpoints=("pool3", "logits")))(jnp.asarray(x, jnp.bfloat16))
    tout = tfast.FastInception(state_dict, torch.bfloat16)(
        torch.from_numpy(x).to(torch.bfloat16), endpoints=("pool3", "logits"))
    mout = tinception.InceptionV3.from_state_dict(state_dict)(torch.from_numpy(x), endpoints=("pool3", "logits"))
    for name in ("pool3", "logits"):
        assert tout[name].dtype == torch.bfloat16
        got = tout[name].float().numpy()
        for what, ref in (("jax bf16", np.asarray(jout[name], np.float32)), ("f32 module", mout[name].numpy())):
            scale = max(np.abs(ref).max(), 1e-6)
            assert np.abs(got - ref).max() / scale < 0.04, f"{name} vs {what}"


def test_input_recipe_fid_on_raw_uint8(state_dict, jax_params):
    """fold_tree(input_recipe="fid") consumes RAW uint8 and matches the f32
    path normalize(u8) -> forward (exact affine algebra in Conv2d_1a_3x3)
    within rtol 2e-4, atol 2e-4 of scale (tests/test_inception.py's), in the
    port and against the JAX folded trunk."""
    u8 = np.random.RandomState(2).randint(0, 256, (2, 75, 75, 3)).astype(np.uint8)
    jfolded = jfast.FastInception(jax_params, jnp.float32, input_recipe="fid")
    jout = jax.jit(lambda v: jfolded(v, endpoints=("pool3", "logits")))(jnp.asarray(u8))
    folded = tfast.FastInception(state_dict, torch.float32, input_recipe="fid")
    assert folded.input_recipe == "fid"
    got = folded(torch.from_numpy(u8), endpoints=("pool3", "logits"))
    plain = tfast.FastInception(state_dict, torch.float32)(
        tpre.normalize(torch.from_numpy(u8), "fid"), endpoints=("pool3", "logits"))
    for name in ("pool3", "logits"):
        for ref in (plain[name].numpy(), np.asarray(jout[name], np.float32)):
            scale = max(np.abs(ref).max(), 1e-6)
            np.testing.assert_allclose(got[name].numpy(), ref, rtol=2e-4, atol=2e-4 * scale, err_msg=name)


def test_fast_pool_branches_go_through_the_pool_wrapper(state_dict, monkeypatch):
    """The nine pool branches (A x3, C x4, E x2) call ops.fast_pool's wrapper
    (kernel K2 on the card) on the THIN f32 slice, counting the padding."""
    calls = []
    real = tfast.avg_pool_3x3_s1_p1

    def spy(x, count_include_pad=True):
        calls.append((tuple(x.shape), x.dtype, count_include_pad, x.is_contiguous()))
        return real(x, count_include_pad)

    monkeypatch.setattr(tfast, "avg_pool_3x3_s1_p1", spy)
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 75, 75, 3).astype(np.float32))
    tfast.FastInception(state_dict, torch.bfloat16)(x.to(torch.bfloat16))
    assert [c[0][-1] for c in calls] == [32, 64, 64, 192, 192, 192, 192, 192, 192]
    assert all(dtype == torch.float32 and pad and contiguous for _, dtype, pad, contiguous in calls)


def test_unknown_endpoint_raises(state_dict):
    with pytest.raises(ValueError):
        tfast.FastInception(state_dict, torch.float32)(torch.zeros(1, 75, 75, 3), endpoints=("mixed7c",))


@pytest.mark.parametrize("src,recipe", [(64, "fid"), (400, "fid"), (331, "half"), (299, "is_star")])
def test_resize_and_normalize_matches_jax(src, recipe):
    """Normalize, then the antialiased triangle filter to 299: enlarging
    (64), shrinking (400, 331) and the identity (299).  Both libraries build
    the same half-pixel-centre weights in f32; the largest difference found
    is 1.4e-6 (on values within [-1, 1]), held to 1e-5."""
    u8 = np.random.RandomState(src).randint(0, 256, (2, src, src, 3)).astype(np.uint8)
    ref = np.asarray(jpre.resize_and_normalize(jnp.asarray(u8), recipe, 299))
    got = tpre.resize_and_normalize(torch.from_numpy(u8), recipe, 299)
    assert got.shape == (2, 299, 299, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_resize_without_antialias_matches_jax_when_shrinking():
    u8 = np.random.RandomState(9).randint(0, 256, (1, 400, 400, 3)).astype(np.uint8)
    ref = np.asarray(jpre.resize_and_normalize(jnp.asarray(u8), "fid", 299, antialias=False))
    got = tpre.resize_and_normalize(torch.from_numpy(u8), "fid", 299, antialias=False)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("src,dst", [((8, 8), (17, 17)), ((35, 35), (299, 299)), ((20, 12), (7, 9)), ((5, 5), (5, 5))])
def test_resize_bilinear_align_corners_matches_jax(src, dst):
    """F.interpolate(align_corners=True) against the JAX package's explicit
    gather weights, enlarging and shrinking: 1e-5 of the input's scale (two
    f32 lerps against two f32 matmuls)."""
    x = np.random.RandomState(4).randn(2, *src, 3).astype(np.float32)
    ref = np.asarray(jpre.resize_bilinear_align_corners(jnp.asarray(x), dst))
    got = tpre.resize_bilinear_align_corners(torch.from_numpy(x), dst)
    assert got.shape == (2, *dst, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(x).max())


def test_extractor_device_resize_to():
    """With device_resize_to the forward sees 299 x 299 whatever the host sent."""
    seen = []

    def apply_fn(x):
        seen.append(tuple(x.shape))
        return {"pool3": x.mean(dim=(1, 2))}

    ex = textractor.BatchedExtractor(apply_fn, recipe="fid", device="cpu", device_resize_to=299)
    out = ex(np.random.RandomState(5).randint(0, 256, (3, 64, 64, 3)).astype(np.uint8))
    assert seen == [(3, 299, 299, 3)] and out["pool3"].shape == (3, 3)


# -- the FID CLI with the fast trunk and the device resize, against the JAX CLI --


def _write_folder(root, n, seed, block):
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    cells = 64 // block
    for i in range(n):
        arr = np.kron(rng.randint(0, 256, (cells, cells, 3)), np.ones((block, block, 1))).astype(np.uint8)
        Image.fromarray(arr).save(str(root / f"{i:03d}.png"))
    return str(root)


@pytest.fixture(scope="module")
def world(tmp_path_factory, state_dict, jax_params):
    root = tmp_path_factory.mktemp("fast")
    weights = str(root / "planted.npz")
    jweights.save_pytree_npz(weights, jax_params)
    return {"root": root, "weights": weights,
            "a": _write_folder(root / "a", 8, seed=1, block=16),
            "b": _write_folder(root / "b", 8, seed=2, block=4)}


def _both_clis(world, tag, extra):
    out = {}
    before = jax.config.jax_default_matmul_precision
    try:
        for name, main, more in (("jax", jfid.main, []), ("torch", tfid.main, ["--device", "cpu"])):
            saved = str(world["root"] / f"{tag}_{name}.txt")
            main(["--path1", world["a"], "--path2", world["b"], "--weights", world["weights"],
                  "--sqrtm", "eigh", "--batch-size", "4", "--saved_file", saved, *extra, *more])
            out[name] = result_io.read_fid_result(saved)
    finally:
        jax.config.update("jax_default_matmul_precision", before)
    return out


def test_fid_cli_device_resize_matches_jax(world):
    """--device-resize-from 64 in f32: the host sends the native 64 x 64
    images, the device normalizes and resizes.  The two CLIs agree as the
    host-resize CLIs do: |dFID| <= max(1e-3, 1e-4 |FID|)."""
    v = _both_clis(world, "resize", ["--device-resize-from", "64"])
    assert np.isfinite(v["torch"]) and v["torch"] > 0.0
    assert abs(v["torch"] - v["jax"]) <= max(1e-3, 1e-4 * abs(v["jax"])), v


def test_fid_cli_fast_device_resize_matches_jax(world):
    """--precision fast --device-resize-from 64: bf16 trunks round at other
    places in the two frameworks (features agree to about 1e-2 of their
    scale), so the distances are held to 5% of each other."""
    v = _both_clis(world, "fast_resize", ["--precision", "fast", "--device-resize-from", "64"])
    assert np.isfinite(v["torch"]) and v["torch"] > 0.0
    assert abs(v["torch"] - v["jax"]) <= 5e-2 * abs(v["jax"]), v
