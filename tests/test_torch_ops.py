"""The port's ops (tise_tpu_torch.ops) against the JAX package on the CPU.

Inputs come from np.random.RandomState and go to both packages as numpy.  On
the CPU the port's wrappers take their kernels' plain PyTorch versions (K1
normalize, K2 avg pool, K3 epilogue matmul); the JAX side runs its Pallas
kernels in interpret mode, as tests/test_ops.py does.  The kernels
themselves run only on the card (chip_smoke.py holds them against these
plain versions there).
"""

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from threadpoolctl import threadpool_limits

from tise_tpu.ops import fast_pool as jfast_pool
from tise_tpu.ops import pallas_kernels as jpallas
from tise_tpu.ops import preprocess as jpreprocess
from tise_tpu.ops import sqrtm as jsqrtm
from tise_tpu.ops import stats as jstats
from tise_tpu_torch.ops import fast_pool, pallas_kernels, preprocess, sqrtm, stats


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


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

    @pytest.mark.parametrize("recipe", sorted(preprocess.RECIPES))
    def test_bf16_plain_matches_jax(self, recipe):
        """bf16: both round the product and the sum to bf16, and agree bit for
        bit on every byte value in every channel."""
        u8 = (np.arange(256 * 3).reshape(1, 16, 16, 3) % 256).astype(np.uint8)
        ref = np.asarray(jpreprocess.normalize(jnp.asarray(u8), recipe, jnp.bfloat16).astype(jnp.float32))
        got = preprocess.normalize(torch.from_numpy(u8), recipe, torch.bfloat16)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), ref)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("recipe", sorted(preprocess.RECIPES))
    def test_kernel_constants_are_the_plain_versions(self, recipe, dtype):
        """The six floats K1 takes are the plain version's constants in the
        output dtype, exactly, and are computed once per (recipe, dtype)."""
        scale, shift = preprocess._constants(recipe, dtype)
        got = preprocess._kernel_constants(recipe, dtype)
        assert got == tuple(scale.float().tolist()) + tuple(shift.float().tolist())
        assert torch.equal(torch.tensor(got, dtype=torch.float32).to(dtype), torch.cat([scale, shift]))
        assert preprocess._kernel_constants(recipe, dtype) is got


class TestNormalizeGeometry:
    """ops/preprocess.py::normalize_geometry, the cut K1's C entry takes.  The
    test mirrors csrc/normalize.cu: body block b, thread t, word i covers
    elements 4 (b * THREADS * WORDS + i * THREADS + t) + j, j < 4, of channel
    (t + i * (THREADS % 3) + j) mod 3; tail thread i of the blocks after the
    body covers element body_blocks * BLOCK_ELEMENTS + i when i < tail."""

    @pytest.mark.parametrize("aligned", [True, False])
    @pytest.mark.parametrize("n", [3, 48, 48 * 7 + 3, 6144, 6144 * 3, 6144 * 2 + 48, 6144 * 2 + 45, 64 * 64 * 3 * 3,
                                   299 * 299 * 3])
    def test_every_element_is_covered_once_with_its_channel(self, n, aligned):
        g = preprocess.normalize_geometry(n, aligned)
        t_n, w_n = preprocess.THREADS, preprocess.WORDS
        assert g.body_blocks == (n // preprocess.BLOCK_ELEMENTS if aligned else 0)
        assert g.tail == n - g.body_blocks * preprocess.BLOCK_ELEMENTS
        assert g.blocks == max(1, g.body_blocks + -(-g.tail // t_n))
        b, i, t, j = np.meshgrid(np.arange(g.body_blocks), np.arange(w_n), np.arange(t_n), np.arange(4), indexing="ij")
        body = 4 * (b * t_n * w_n + i * t_n + t) + j
        assert ((t % 3 + i * (t_n % 3) + j) % 3 == body % 3).all()
        tail_threads = np.arange((g.blocks - g.body_blocks) * t_n)
        tail = g.body_blocks * preprocess.BLOCK_ELEMENTS + tail_threads[tail_threads < g.tail]
        covered = np.bincount(np.concatenate([body.ravel(), tail]), minlength=n)
        assert len(covered) == n and (covered == 1).all()

    def test_main_path_shapes_take_no_tail(self):
        """A batch of 64 at 299 or 64 pixels is whole blocks but for a tail
        of less than one block."""
        for side in (299, 64):
            g = preprocess.normalize_geometry(64 * side * side * 3, True)
            assert g.tail < preprocess.BLOCK_ELEMENTS and g.body_blocks >= 128


class TestAvgPool:
    # the last four: C not a multiple of 8, a 1-wide and a 1-high map, and a row too wide for one block
    SHAPES = [(2, 17, 17, 8), (3, 35, 35, 5), (2, 1, 5, 4), (2, 5, 1, 4), (1, 1, 1, 3),
              (2, 17, 17, 36), (2, 9, 1, 8), (2, 1, 9, 8), (1, 3, 300, 6)]

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
        the same separable _edge_inv weights.  (XLA:CPU does not keep the
        kernel's order of adds: up to 1 ulp.)"""
        x = np.random.RandomState(1).randn(*shape).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jfast_pool._pallas_pool(jnp.asarray(x), include_pad))
        got = fast_pool.avg_pool_3x3_s1_p1(torch.from_numpy(x), include_pad).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("include_pad", [True, False])
    @pytest.mark.parametrize("shape", SHAPES)
    def test_plain_is_the_pallas_kernels_arithmetic_bit_for_bit(self, shape, include_pad):
        """K2's plain version == _pool_kernel's expression evaluated by numpy
        in f32 in its written order, ((x[i-1] + x[i]) + x[i+1]) * inv, with
        the JAX package's own _edge_inv: bit for bit.  K2 on the card is held
        to the plain version bit for bit (chip_smoke.py)."""
        x = np.random.RandomState(2).randn(*shape).astype(np.float32)
        _, h, w, _ = shape
        invh = jfast_pool._edge_inv(h, include_pad).reshape(1, h, 1, 1)
        invw = jfast_pool._edge_inv(w, include_pad).reshape(1, 1, w, 1)
        xh = np.pad(x, ((0, 0), (1, 1), (0, 0), (0, 0)))
        sh = ((xh[:, :-2] + xh[:, 1:-1]) + xh[:, 2:]) * invh
        sw = np.pad(sh, ((0, 0), (0, 0), (1, 1), (0, 0)))
        ref = ((sw[:, :, :-2] + sw[:, :, 1:-1]) + sw[:, :, 2:]) * invw
        got = fast_pool.avg_pool_3x3_s1_p1(torch.from_numpy(x), include_pad).numpy()
        assert ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)

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


# every shape chip_smoke.py holds K2 to on the card, and ragged ones: C = 36,
# W = 1, H = 1, W = 300
GEOMETRY_SHAPES = ([s for s, _ in chip_smoke.POOL_SHAPES] + [s for s, _ in chip_smoke.THIN_POOL_SHAPES]
                   + chip_smoke.EDGE_POOL_SHAPES + chip_smoke.RAGGED_POOL_SHAPES
                   + [(2, 9, 1, 36), (2, 1, 300, 64), (3, 300, 3, 40)])


class TestPoolGeometry:
    """ops/fast_pool.py::pool_geometry, the cut the wrapper hands K2's C
    entry.  The test mirrors the kernel's indexing (csrc/avg_pool3x3.cu): block
    (slice, chunk + n_chunks * band, image) has threads for columns
    chunk * chunk_w - 1 ... chunk * chunk_w + chunk_w (the two ends are its
    halo), writes rows band * band_h ... + band_h and the columns between the
    ends, and reads rows band * band_h - 1 ... band * band_h + band_h, all
    clipped to the image."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
    def test_every_output_is_written_once_and_halos_are_the_neighbours(self, shape, dtype):
        g = fast_pool.pool_geometry(shape, dtype)
        b, h, w, c = shape
        full = 4 if dtype == torch.float32 else 8
        assert g.vec == (full if c % full == 0 else 1)
        assert g.instance == ("chunked" if g.n_chunks > 1 else "vector" if g.vec > 1 else "scalar")
        cv = c // g.vec
        assert g.grid == (-(-cv // g.cvb), g.n_chunks * g.n_bands, b)
        assert g.threads == (g.chunk_w + 2) * g.cvb <= fast_pool.MAX_THREADS
        assert g.shared_bytes == 2 * g.threads * g.vec * 4 <= fast_pool.MAX_SHARED
        assert g.n_chunks == 1 or g.threads <= fast_pool.TARGET_THREADS
        written = np.zeros((h, w, cv), np.int32)
        for s in range(g.grid[0]):
            for y in range(g.grid[1]):
                chunk, band = y % g.n_chunks, y // g.n_chunks
                rows = np.arange(band * g.band_h, min(h, (band + 1) * g.band_h))
                cols = chunk * g.chunk_w - 1 + np.arange(g.chunk_w + 2)
                chans = s * g.cvb + np.arange(g.cvb)
                chans = chans[chans < cv]
                assert len(rows) and len(chans)
                out_cols = cols[1:-1][cols[1:-1] < w]
                written[np.ix_(rows, out_cols, chans)] += 1
                assert len(out_cols)
                # the band reads its rows and the one above and below it; the run its
                # columns and one on either side; nothing else
                read_rows = set(range(rows[0] - 1, rows[-1] + 2)) & set(range(h))
                assert read_rows == set(rows) | ({rows[0] - 1, rows[-1] + 1} & set(range(h)))
                read_cols = set(cols) & set(range(w))
                assert read_cols == set(range(out_cols[0] - 1, out_cols[-1] + 2)) & set(range(w))
        assert (written == 1).all(), np.argwhere(written != 1)[:5]

    def test_the_smokes_shapes_reach_every_instance(self):
        seen = {fast_pool.pool_geometry(s, d).instance for s in GEOMETRY_SHAPES for d in (torch.float32, torch.bfloat16)}
        assert seen == set(fast_pool.KERNEL_INSTANCES)

    def test_unaligned_pointers_take_the_scalar_instance(self):
        g = fast_pool.pool_geometry((2, 17, 17, 768), torch.float32, aligned=False)
        assert g.vec == 1 and g.instance == "scalar"

    def test_main_path_pools_fill_the_card(self):
        """The trunk's and the fast trunk's pools take whole rows and give at
        least MIN_BLOCKS blocks, or, where a pool is too small for that, cut
        it as finely as the rule allows: slices of MIN_CVB vectors, bands of
        MIN_BAND rows."""
        for shape, _ in chip_smoke.POOL_SHAPES + chip_smoke.THIN_POOL_SHAPES:
            g = fast_pool.pool_geometry(shape, torch.float32)
            assert g.instance == "vector" and g.n_chunks == 1 and g.chunk_w == shape[2]
            if g.grid[0] * g.grid[1] * g.grid[2] < fast_pool.MIN_BLOCKS:
                assert g.cvb == fast_pool.MIN_CVB and g.band_h == fast_pool.MIN_BAND, (shape, g)
            assert g.band_h >= min(fast_pool.MIN_BAND, shape[1])


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
        got = sqrtm.frechet_distance(mu1, s1, mu2, s2, method=method, device="cpu")
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
        got = sqrtm.trace_sqrtm_product(s1, s2, method="ns", device="cpu")
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
        js, ts = jstats.init_moments(16), stats.init_moments(16, device="cpu")
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
