"""The port's ops (tise_tpu_torch.ops) against the JAX package on the CPU.

Inputs come from np.random.RandomState and go to both packages as numpy.  On
the CPU the port's wrappers take their kernels' plain PyTorch versions (K1
normalize, K2 avg pool, K3 epilogue matmul); the JAX side runs its Pallas
kernels in interpret mode, as tests/test_ops.py does.  The kernels
themselves run only on the card (chip_smoke.py holds them against these
plain versions there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tise_tpu.ops import fast_pool as jfast_pool
from tise_tpu.ops import pallas_kernels as jpallas
from tise_tpu.ops import preprocess as jpreprocess
from tise_tpu.ops import sqrtm as jsqrtm
from tise_tpu.ops import stats as jstats
from tise_tpu_torch.ops import fast_pool, pallas_kernels, preprocess, sqrtm, stats


def _random_psd(rng, d):
    a = rng.randn(d, d)
    return a @ a.T / d + 0.1 * np.eye(d)


class TestNormalize:
    @pytest.mark.parametrize("recipe", sorted(preprocess.RECIPES))
    def test_plain_matches_jax_within_1ulp(self, recipe):
        """K1's plain version == tise_tpu normalize for every recipe, f32,
        within 1 ulp of the larger operand.  XLA on the CPU fuses the
        multiply-add (one rounding); the port rounds the product and the sum
        separately, as the kernel does.  Where the sum cancels (an output
        near 0) that one rounding of the product is many ulps of the output,
        so the ulp is taken at max(|v * scale|, |shift|)."""
        u8 = np.random.RandomState(0).randint(0, 256, (2, 7, 5, 3)).astype(np.uint8)
        ref = np.asarray(jpreprocess.normalize(jnp.asarray(u8), recipe, jnp.float32))
        got = preprocess.normalize(torch.from_numpy(u8), recipe, torch.float32).numpy()
        assert got.dtype == np.float32
        scale, shift = (np.asarray(v, np.float32) for v in preprocess.RECIPES[recipe])
        product = u8.astype(np.float32) * scale
        np.testing.assert_array_equal(got, product + shift)  # two rounded operations
        one_ulp = np.spacing(np.maximum(np.abs(product), np.abs(shift)))
        assert (np.abs(got - ref) <= one_ulp).all()

    def test_recipes_match_jax_constants(self):
        assert preprocess.RECIPES == jpreprocess.RECIPES

    def test_bf16_plain_matches_jax(self):
        """bf16: both round the product and the sum to bf16; within 1 bf16 ulp."""
        u8 = np.random.RandomState(1).randint(0, 256, (2, 4, 4, 3)).astype(np.uint8)
        ref = np.asarray(jpreprocess.normalize(jnp.asarray(u8), "fid", jnp.bfloat16).astype(jnp.float32))
        got = preprocess.normalize(torch.from_numpy(u8), "fid", torch.bfloat16).float().numpy()
        np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=0)


class TestAvgPool:
    SHAPES = [(2, 17, 17, 8), (3, 35, 35, 5), (2, 1, 5, 4), (2, 5, 1, 4), (1, 1, 1, 3)]

    @pytest.mark.parametrize("include_pad", [True, False])
    @pytest.mark.parametrize("shape", SHAPES)
    def test_plain_matches_jax_reduce_window(self, shape, include_pad):
        """K2's plain version == fast_pool._xla_pool (flax avg_pool) at 1e-6."""
        x = np.random.RandomState(0).randn(*shape).astype(np.float32)
        ref = np.asarray(jfast_pool._xla_pool(jnp.asarray(x), include_pad))
        got = fast_pool.avg_pool_3x3_s1_p1(torch.from_numpy(x), include_pad).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("include_pad", [True, False])
    @pytest.mark.parametrize("shape", SHAPES)
    def test_plain_matches_jax_pallas_kernel(self, shape, include_pad):
        """K2's plain version == the Pallas kernel (interpret mode) at 1e-6:
        the same separable _edge_inv weights."""
        x = np.random.RandomState(1).randn(*shape).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jfast_pool._pallas_pool(jnp.asarray(x), include_pad))
        got = fast_pool.avg_pool_3x3_s1_p1(torch.from_numpy(x), include_pad).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("n", [1, 2, 5])
    @pytest.mark.parametrize("include_pad", [True, False])
    def test_edge_inv_matches_jax(self, n, include_pad):
        np.testing.assert_array_equal(fast_pool._edge_inv(n, include_pad), jfast_pool._edge_inv(n, include_pad))

    def test_bf16_in_bf16_out(self):
        x = torch.from_numpy(np.random.RandomState(2).randn(2, 5, 5, 4).astype(np.float32))
        got = fast_pool.avg_pool_3x3_s1_p1(x.bfloat16(), True)
        assert got.dtype == torch.bfloat16
        ref = fast_pool.avg_pool_3x3_s1_p1(x.bfloat16().float(), True).bfloat16()
        assert torch.equal(got, ref)


class TestEpilogueMatmul:
    @pytest.mark.parametrize("n", [100, 256])
    def test_plain_matches_jax_pallas_kernel(self, n):
        """K3's plain version == epilogue_matmul (interpret mode) at 1e-4."""
        rng = np.random.RandomState(n)
        a = rng.randn(n, n).astype(np.float32)
        b = rng.randn(n, n).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jpallas.epilogue_matmul(jnp.asarray(a), jnp.asarray(b), alpha=1.5, beta=-0.5))
        got = pallas_kernels.epilogue_matmul(torch.from_numpy(a), torch.from_numpy(b), 1.5, -0.5).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

    def test_ns_iteration_matches_jax(self):
        """The NS iteration on the plain step == newton_schulz_sqrtm_pallas
        (interpret): trace within 1e-4 relative."""
        rng = np.random.RandomState(0)
        prod = (_random_psd(rng, 96) @ _random_psd(rng, 96)).astype(np.float32)
        ref = np.trace(np.asarray(jpallas.newton_schulz_sqrtm_pallas(jnp.asarray(prod), iters=30)))
        got = float(torch.trace(pallas_kernels.newton_schulz_sqrtm_pallas(torch.from_numpy(prod), iters=30)))
        assert abs(got - ref) / abs(ref) < 1e-4

    def test_zero_matrix_gives_zero(self):
        out = pallas_kernels.newton_schulz_sqrtm_pallas(torch.zeros(8, 8))
        assert torch.equal(out, torch.zeros(8, 8))


class TestKernelWrappersRefuseCpu:
    """A kernel wrapper never takes the plain version itself: a CPU tensor
    handed to it directly is refused."""

    def test_normalize_kernel(self):
        with pytest.raises(ValueError, match="CUDA"):
            preprocess.normalize_kernel(torch.zeros(1, 2, 2, 3, dtype=torch.uint8), "fid")

    def test_avg_pool_kernel(self):
        with pytest.raises(ValueError, match="CUDA"):
            fast_pool.avg_pool_kernel(torch.zeros(1, 2, 2, 3))

    def test_epilogue_matmul_kernel(self):
        with pytest.raises(ValueError, match="CUDA"):
            pallas_kernels.epilogue_matmul_kernel(torch.zeros(4, 4), torch.zeros(4, 4))


class TestFrechet:
    @pytest.mark.parametrize("method,tol", [("scipy", 1e-8), ("eigh", 1e-8), ("ns", 1e-3), ("ns-pallas", 1e-3)])
    def test_matches_jax(self, method, tol):
        """Host methods (float64) within 1e-8 relative; the f32 device
        Newton–Schulz methods within 1e-3 relative."""
        rng = np.random.RandomState(3)
        mu1, mu2 = rng.randn(48), rng.randn(48)
        s1, s2 = _random_psd(rng, 48), _random_psd(rng, 48)
        ref = jsqrtm.frechet_distance(mu1, s1, mu2, s2, method=method)
        got = sqrtm.frechet_distance(mu1, s1, mu2, s2, method=method)
        assert abs(got - ref) <= tol * abs(ref), (got, ref)

    def test_scipy_eps_retry_on_singular_product(self):
        """A singular product takes the reference's eps-diagonal retry path in
        both packages and gives the same value."""
        rng = np.random.RandomState(4)
        a = rng.randn(6, 16)
        s1 = np.cov(a, rowvar=False)  # rank 5 of 16
        mu = rng.randn(16)
        ref = jsqrtm.frechet_distance(mu, s1, 0 * mu, s1, method="scipy")
        got = sqrtm.frechet_distance(mu, s1, 0 * mu, s1, method="scipy")
        assert abs(got - ref) <= 1e-8 * abs(ref)

    def test_trace_sqrtm_product_ns_matches_jax(self):
        rng = np.random.RandomState(5)
        s1, s2 = _random_psd(rng, 32), _random_psd(rng, 32)
        ref = jsqrtm.trace_sqrtm_product(s1, s2, method="ns")
        got = sqrtm.trace_sqrtm_product(s1, s2, method="ns")
        assert abs(got - ref) <= 1e-4 * abs(ref)

    def test_unknown_method_raises(self):
        with pytest.raises(ValueError):
            sqrtm.trace_sqrtm_product(np.eye(2), np.eye(2), method="schur")


@pytest.mark.parametrize("name", ["IS_STAR_TEMPERATURE_CUB", "IS_STAR_TEMPERATURE_COCO", "O_IS_TEMPERATURE",
                                  "DETECTOR_SCORE_THRESHOLD", "PA_SUCCESS_THRESHOLD", "NUM_SPLITS"])
def test_calibration_constants_match_jax(name):
    from tise_tpu.core import config as jconfig
    from tise_tpu_torch.core import config

    assert getattr(config, name) == getattr(jconfig, name)


class TestMoments:
    def test_kahan_moments_match_jax(self):
        """Two masked updates, then the f64 and the f32 finalisation, against
        tise_tpu.ops.stats on the same inputs: f32 accumulators within 1e-6
        relative."""
        rng = np.random.RandomState(6)
        batches = [rng.randn(8, 16).astype(np.float32) for _ in range(2)]
        mask = np.array([True] * 6 + [False] * 2)
        js, ts = jstats.init_moments(16), stats.init_moments(16)
        for b in batches:
            js = jstats.update_moments(js, jnp.asarray(b), jnp.asarray(mask))
            ts = stats.update_moments(ts, torch.from_numpy(b), torch.from_numpy(mask))
        for name in ("count", "total", "outer", "total_c", "outer_c"):
            np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
        for got, ref in zip(stats.finalize_moments(ts), jstats.finalize_moments(js)):
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        for got, ref in zip(stats.finalize_moments_f32(ts), jstats.finalize_moments_f32(js)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)

    def test_exact_stats_is_numpy_reference(self):
        acts = np.random.RandomState(7).randn(20, 5)
        mu, sigma = stats.exact_stats(acts)
        ref_mu, ref_sigma = jstats.exact_stats(acts)
        np.testing.assert_array_equal(mu, ref_mu)
        np.testing.assert_array_equal(sigma, ref_sigma)
