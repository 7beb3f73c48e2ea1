"""The plain versions of the probe kernels P1-P6 (tise_tpu_torch.tools) against
the JAX package's Pallas kernels in interpret mode, on seeded random inputs.

The TPU probes of tools/mosaic_probe.py build their own all-ones inputs
inside each function, so the tests wrap ``pl.pallas_call`` for the duration of
one probe: the probe's own call and check run unchanged, and the same compiled
kernel is run once more on the random input.  On the CPU the port's wrappers
take the plain versions; the CUDA kernels are held against those on the card
by chip_smoke.py and by the probes' own entry points.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from threadpoolctl import threadpool_limits

import tools.mosaic_probe as jprobe
import tools.stem_mm_probe as jstem
from tise_tpu_torch.tools import mosaic_probe as tprobe
from tise_tpu_torch.tools import stem_mm_probe as tstem


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


def _pallas_on(fn, x: np.ndarray, monkeypatch) -> np.ndarray:
    """Run the TPU probe ``fn`` in interpret mode and return its kernel's
    output on ``x`` (of the probe's own input shape)."""
    captured = {}
    real = pl.pallas_call

    def spy(kernel, **kw):
        call = real(kernel, **kw)

        def run(own_input):
            assert own_input.shape == x.shape
            captured["out"] = np.asarray(call(jnp.asarray(x)))
            return call(own_input)

        return run

    monkeypatch.setattr(jprobe.pl, "pallas_call", spy)
    with pltpu.force_tpu_interpret_mode():
        fn()
    return captured["out"]


@pytest.mark.parametrize("name", list(tprobe.PROBES))
def test_plain_probe_matches_pallas_kernel(name, monkeypatch):
    """P2-P5 move and scale by 2 or 3: bit-equal.  P1 adds three f32 values,
    in an order the libraries may choose differently: 1e-6."""
    x = tprobe.probe_input(name, seed=1)
    ref = _pallas_on(getattr(jprobe, name), x, monkeypatch)
    got = tprobe.probe(name, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32
    if name == "lane_split":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, ref)


def test_probe_shapes_are_the_tpu_probes():
    assert {k: v[2] for k, v in tprobe.PROBES.items()} == {
        "lane_split": (44, 900), "dma_minor27": (8, 128, 27), "strided_slice": (8, 256),
        "lane_concat": (128, 128), "scratch_stage": (8, 64)}


@pytest.mark.parametrize("shape", [(8, 128, 27), (2, 128, 27), (1, 4, 27), (8, 128, 32), (5, 7, 4), (1, 1, 1024)])
def test_dma_minor27_runs_cover_the_rows_once_on_16_byte_words(shape):
    """P2's runs: whole rows, every run but the last of the same length, each
    starting and ending on a 16-byte word, one thread a float (at most 1024),
    covering every row once; at the probe's [8, 128, 27] at least 32 blocks."""
    b, r, m = shape
    run, blocks = tprobe.dma_minor27_runs(shape)
    rows = b * r
    assert run * m % 4 == 0 and run * m <= 1024
    starts = [k * run for k in range(blocks)]
    ends = [min(rows, s + run) for s in starts]
    assert starts[0] == 0 and ends[-1] == rows and all(e > s for s, e in zip(starts, ends))
    assert all(s * m * 4 % 16 == 0 and e * m * 4 % 16 == 0 for s, e in zip(starts, ends))
    assert all(ends[k] == starts[k + 1] for k in range(blocks - 1))
    if shape == (8, 128, 27):
        assert blocks >= 32


@pytest.mark.parametrize("shape", [(3, 1, 27), (1, 1, 1025), (1, 2, 27), (7, 1, 2)])
def test_dma_minor27_runs_refuse_rows_without_aligned_runs(shape):
    with pytest.raises(ValueError, match="16-byte"):
        tprobe.dma_minor27_runs(shape)


def test_dma_minor27_plain_names_the_tpu_probes_block(monkeypatch):
    """TPU_BLOCK is the block the TPU probe's BlockSpec moves."""
    seen = []
    real = pl.pallas_call

    def spy(kernel, **kw):
        seen.append(kw["in_specs"][0].block_shape)
        return real(kernel, **kw)

    monkeypatch.setattr(jprobe.pl, "pallas_call", spy)
    with pltpu.force_tpu_interpret_mode():
        jprobe.dma_minor27()
    assert [tuple(b) for b in seen] == [tprobe.TPU_BLOCK]


def test_mosaic_probe_entry_point_on_the_cpu(capsys):
    """Asked for the CPU, the entry point holds the plain versions against
    themselves: five PASS lines and exit code 0.  With no device named it
    wants the card and raises here."""
    assert tprobe.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("PASS") == 5
    with pytest.raises(RuntimeError, match="--device cpu"):
        tprobe.main([])


def test_mosaic_probe_entry_point_fails_on_a_wrong_kernel(monkeypatch, capsys):
    """A probe that disagrees with its plain version is a FAIL and a non-zero
    exit code."""
    real = tprobe.probe

    def odd_columns(name, x):  # a strided slice that starts one column late
        return x[:, 1::2].contiguous() if name == "strided_slice" else real(name, x)

    monkeypatch.setattr(tprobe, "probe", odd_columns)
    assert tprobe.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert out.count("FAIL  max_abs_err") == 1 and out.count("PASS  max_abs_err") == 4
    assert "strided_slice  FAIL" in out


@pytest.mark.parametrize("name", list(tprobe.PROBES) + ["stem_mm"])
def test_kernel_wrappers_refuse_cpu_tensors(name):
    """A kernel wrapper never falls back: on a CPU tensor it raises."""
    if name == "stem_mm":
        x = torch.zeros(16, 16, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="CUDA"):
            tstem.stem_mm_kernel(x, torch.zeros(16, 32, dtype=torch.bfloat16), 1)
        return
    with pytest.raises(ValueError, match="CUDA"):
        tprobe.PROBES[name][0](torch.from_numpy(tprobe.probe_input(name)))


@pytest.mark.parametrize("m,k,n,nsteps", [(40, 27, 32, 3), (24, 48, 64, 2), (33, 27, 32, 1), (24, 48, 128, 2)])
def test_stem_mm_plain_matches_pallas_kernel(m, k, n, nsteps):
    """P6's plain version (f32 products of the bf16 values) against
    _mm_kernel in interpret mode at a small shape and a few steps: the sum of
    y[0, 0] within 1e-5 relative (k f32 adds in another order)."""
    xs, ws = tstem.probe_inputs(m, k, n, seed=2)
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(functools.partial(jstem._mm_kernel, nsteps),
                              out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32))
        ref = np.asarray(call(jnp.asarray(xs, jnp.bfloat16), jnp.asarray(ws, jnp.bfloat16)))
    x, w = torch.from_numpy(xs).to(torch.bfloat16), torch.from_numpy(ws).to(torch.bfloat16)
    got = tstem.stem_mm(x, w, nsteps)
    assert got.shape == (1, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    s, y = tstem.stem_mm_plain(x, w, nsteps)
    assert torch.equal(s, got) and y.shape == (m, n)
    # w is re-rounded through f32 with a term far below its last bit: every step is the same dot
    np.testing.assert_allclose(float(s), nsteps * float((x.float() @ w.float())[0, 0]), rtol=1e-6)


# the probe's five shapes, two ragged ones (m not a multiple of 64, k not of 16, n of 8 only) and
# a ragged one at a k whose steps latency bounds
GEOMETRY_SHAPES = [(m, k, n) for _, m, k, n in tstem.SHAPES] + [(130, 45, 24), (1000, 700, 48), (200, 20, 64)]


@pytest.mark.parametrize("m,k,n", GEOMETRY_SHAPES)
def test_stem_geometry_covers_y_once_in_one_wave(m, k, n):
    """P6's cut: block (i, j) owns rows 64i ... 64i + 63 of y (those below m)
    and columns nb j ... nb j + nb - 1, as csrc/stem_mm.cu indexes them.  Every
    (row, column) of y is owned once; a block's strip of x and slice of w fit
    the card's shared memory; nb is a wgmma n (a multiple of 8, at most 256)
    that the kernel is built for; all blocks run in one wave."""
    g = tstem.stem_geometry(m, k, n)
    assert g.nb % 8 == 0 and g.nb <= 256 and g.nb in tstem.WGMMA_N and n % g.nb == 0
    assert g.kp % 16 == 0 and k <= g.kp < k + 16
    assert g.smem_bytes == (tstem.BLOCK_ROWS + g.nb) * g.kp * 2 + 16 <= tstem.SMEM_LIMIT
    assert g.grid == (-(-m // tstem.BLOCK_ROWS), n // g.nb)
    owned = np.zeros((m, n), np.int32)
    for i in range(g.grid[0]):
        for j in range(g.grid[1]):
            rows = np.arange(i * tstem.BLOCK_ROWS, min(m, (i + 1) * tstem.BLOCK_ROWS))
            assert len(rows)
            owned[rows[0]:rows[-1] + 1, j * g.nb:(j + 1) * g.nb] += 1
    assert (owned == 1).all()
    assert g.occupancy >= 1 and g.grid[0] * g.grid[1] <= tstem.SMS * g.occupancy


@pytest.mark.parametrize("m,k,n", GEOMETRY_SHAPES)
def test_stem_geometry_takes_the_cheapest_slice(m, k, n):
    """Beyond LATENCY_KP no other wgmma n that fits moves fewer shared-memory
    bytes through the busiest SM a step: ceil(blocks / SMS) blocks, each
    reading its strip and slice (128 kp + 2 nb kp bytes) and rewriting its
    slice (4 nb kp).  Up to it, where latency sets a step, no narrower n
    that fits runs in one wave."""
    g = tstem.stem_geometry(m, k, n)
    fits = [nb for nb in tstem.WGMMA_N if n % nb == 0 and (tstem.BLOCK_ROWS + nb) * g.kp * 2 + 16 <= tstem.SMEM_LIMIT]
    assert [o.nb for o in tstem.stem_geometries(m, k, n)] == fits
    assert g.step_bytes == -(-g.grid[0] * g.grid[1] // tstem.SMS) * g.kp * (128 + 6 * g.nb)
    for o in tstem.stem_geometries(m, k, n):
        if g.kp <= tstem.LATENCY_KP:
            assert o.nb >= g.nb or o.grid[0] * o.grid[1] > tstem.SMS * o.occupancy
        else:
            assert g.step_bytes <= -(-o.grid[0] * o.grid[1] // tstem.SMS) * g.kp * (128 + 6 * o.nb)
    if (m, k, n) == (2384, 27, 32):  # conv1a: the narrowest slice, 152 blocks on 132 SMs, two to some of them
        assert g.nb == 8 and g.grid == (38, 4)


@pytest.mark.parametrize("m,k,n", [(64, 64, 12), (64, 1800, 8)])
def test_stem_geometry_refuses_what_the_kernel_cannot_take(m, k, n):
    """n must be a multiple of 8; a k whose 64-row strip and 8-column slice
    exceed the shared memory of a block is refused before a launch."""
    with pytest.raises(ValueError, match="shared memory"):
        tstem.stem_geometry(m, k, n)


def test_stem_probe_shapes_are_the_tpu_probes():
    assert [(m, k, n) for _, m, k, n in tstem.SHAPES] == [
        (2384, 27, 32), (2352, 288, 32), (2352, 288, 64), (1225, 1200, 64), (1176, 1152, 128)]
    assert tstem.PEAK_BF16 == 989e12


def test_stem_probe_entry_point_needs_the_card():
    with pytest.raises(RuntimeError, match="--device cpu"):
        tstem.main([])
    with pytest.raises(SystemExit):
        tstem.main(["--device", "cpu"])
