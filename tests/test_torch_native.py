"""The port's launch layer (tise_tpu_torch.ops.native) and the library entry
points that resolve their device, on the CPU.

``native.launch`` is the one place a ``ctypes``-bound kernel is called from.
There is no card and no ``nvcc`` here, so it is driven with a stand-in for
the C function (a Python callable) and stand-ins for the two CUDA lookups;
what it does with them is what it does with the real ones.  The entry points
of ``ops.sqrtm`` and ``ops.stats`` run on the card unless the caller asks for
the CPU, and so do the two trunks: without a card they raise, with
``device="cpu"`` they agree with the JAX package.  K3's CPU path is held against the Pallas kernel (interpret
mode) at the sizes its ragged instances see on the card.
"""

import ctypes
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from threadpoolctl import threadpool_limits

from tise_tpu.ops import pallas_kernels as jpallas
from tise_tpu.ops import sqrtm as jsqrtm
from tise_tpu.ops import stats as jstats
from tise_tpu_torch.backbones import inception_fast, inception_v3
from tise_tpu_torch.ops import fast_pool, native, pallas_kernels, preprocess, sqrtm, stats
from tise_tpu_torch.tools import mosaic_probe, stem_mm_probe


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


class _Counter:
    def __init__(self):
        self.launches = 0


class _StandIn:
    """Takes the place of a bound C entry: records its arguments, returns ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


@pytest.fixture
def fake_cuda(monkeypatch):
    """Device 0 is current and its stream's raw handle is 0xBEEF; entering
    another device is recorded instead of done."""
    entered = []

    class _Guard:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            entered.append(self.index)

        def __exit__(self, *exc):
            entered.append(("left", self.index))

    monkeypatch.setattr(native, "_current_device", lambda: 0)
    monkeypatch.setattr(native, "_raw_stream", lambda index: 0xBEEF + index)
    monkeypatch.setattr(torch.cuda, "device", _Guard)
    return entered


def _entry(stand_in, symbol="tise_stand_in"):
    fn = native.CFunction("no_such_library", symbol, [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.call = stand_in
    return fn


class TestLaunch:
    def test_arguments_arrive_in_order_with_the_stream_last(self, fake_cuda):
        stand_in, counter = _StandIn(), _Counter()
        native.launch(_entry(stand_in), counter, torch.device("cuda", 0), 0x1000, 0x2000, 7)
        assert stand_in.calls == [(0x1000, 0x2000, 7, 0xBEEF)]
        assert counter.launches == 1
        assert fake_cuda == []  # the tensors' device is the current one: no guard entered

    def test_another_device_is_made_current_for_the_call_only(self, fake_cuda):
        stand_in, counter = _StandIn(), _Counter()
        native.launch(_entry(stand_in), counter, torch.device("cuda", 1), 0x1000, 0x2000, 7)
        assert stand_in.calls == [(0x1000, 0x2000, 7, 0xBEEF + 1)]  # that device's stream
        assert fake_cuda == [1, ("left", 1)]
        assert counter.launches == 1

    def test_nonzero_return_raises_with_the_kernels_name_and_counts_nothing(self, fake_cuda):
        stand_in, counter = _StandIn(err=9), _Counter()
        with pytest.raises(RuntimeError, match=r"tise_probe_scratch_stage: CUDA error 9"):
            native.launch(_entry(stand_in, "tise_probe_scratch_stage"), counter, torch.device("cuda", 0), 1, 2, 3)
        assert counter.launches == 0
        assert len(stand_in.calls) == 1

    def test_each_launch_counts_once(self, fake_cuda):
        stand_in, counter = _StandIn(), _Counter()
        fn = _entry(stand_in)
        for _ in range(3):
            native.launch(fn, counter, torch.device("cuda", 0), 1, 2, 3)
        assert counter.launches == 3 and len(stand_in.calls) == 3

    def test_first_launch_binds_the_symbol_once(self, fake_cuda, monkeypatch):
        """An unbound entry asks ``native.library`` for its library at the
        first launch, sets the argument types, and keeps the function."""
        stand_in, asked = _StandIn(), []

        class _Lib:
            tise_stand_in = stand_in

        monkeypatch.setattr(native, "library", lambda name: asked.append(name) or _Lib)
        argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn = native.CFunction("some_library", "tise_stand_in", argtypes)
        assert fn.call is None
        counter = _Counter()
        native.launch(fn, counter, torch.device("cuda", 0), 5, 6)
        native.launch(fn, counter, torch.device("cuda", 0), 5, 6)
        assert asked == ["some_library"]
        assert fn.call is stand_in and stand_in.argtypes == argtypes and stand_in.restype is ctypes.c_int
        assert counter.launches == 2


class _FakeCudaTensor:
    """A CPU tensor that says it lives on card 0 at a made-up address: what
    a kernel wrapper reads of its tensors, and nothing more."""

    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, t: torch.Tensor, address: int):
        self._t, self._address = t, address
        self.shape, self.dtype = t.shape, t.dtype

    def dim(self):
        return self._t.dim()

    def numel(self):
        return self._t.numel()

    def is_contiguous(self):
        return self._t.is_contiguous()

    def data_ptr(self):
        return self._address


X_AT, OUT_AT = 0x10000, 0x90000


@pytest.fixture
def fake_wrapper_call(fake_cuda, monkeypatch):
    """Runs a kernel wrapper on a fake CUDA tensor with a stand-in for its C
    entry; returns the arguments the entry received."""

    def run(wrapper, entry: native.CFunction, t: torch.Tensor, *args):
        stand_in = _StandIn()
        monkeypatch.setattr(entry, "call", stand_in)
        monkeypatch.setattr(torch, "empty_like", lambda x: _FakeCudaTensor(torch.empty(x.shape, dtype=x.dtype), OUT_AT))
        counter_before = wrapper.launches
        wrapper(_FakeCudaTensor(t, X_AT), *args)
        assert wrapper.launches == counter_before + 1 and len(stand_in.calls) == 1
        return stand_in.calls[0]

    return run


def _c_entry(source: str, symbol: str):
    """(name, C type) of each parameter of ``symbol`` as csrc/``source``
    declares it; a pointer's type is "*"."""
    text = (native.CSRC / source).read_text()
    params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text).group(1)
    out = []
    for p in " ".join(params.split()).split(","):
        words = p.split()
        out.append((words[-1].lstrip("*"), "*" if "*" in p else " ".join(w for w in words[:-1] if w != "const")))
    return out


_CTYPES = {"*": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _check_order(entry: native.CFunction, source: str, values: dict, got: tuple):
    """The wrapper's arguments are the C entry's parameters, in its order and
    with its types (pointers as c_void_p, int, long long and float as their
    ctypes), the stream last."""
    params = _c_entry(source, entry.symbol)
    assert [n for n, _ in params][-1] == "stream" and len(entry.argtypes) == len(params)
    for (name, ctype), argtype in zip(params, entry.argtypes):
        assert argtype is _CTYPES[ctype], name
    assert got == tuple(values[name] for name, _ in params)


class TestWrappersCallTheirCEntries:
    @pytest.mark.parametrize("shape,dtype", [
        ((2, 17, 17, 768), torch.float32), ((2, 35, 35, 32), torch.bfloat16), ((2, 17, 17, 36), torch.bfloat16),
        ((1, 3, 300, 64), torch.float32), ((2, 1, 5, 8), torch.float32)])
    @pytest.mark.parametrize("include_pad", [True, False])
    def test_avg_pool_kernel(self, fake_wrapper_call, shape, dtype, include_pad):
        """K2's wrapper hands tise_avg_pool3x3_s1_p1 the tensors, the sizes,
        the dtype code, the count mode, the forward mode and pool_geometry's
        cut."""
        got = fake_wrapper_call(fast_pool.avg_pool_kernel, fast_pool._AVG_POOL, torch.zeros(shape, dtype=dtype),
                                include_pad)
        g = fast_pool.pool_geometry(shape, dtype)
        values = dict(x=X_AT, out=OUT_AT, B=shape[0], H=shape[1], W=shape[2], C=shape[3],
                      dtype=fast_pool._DTYPES[dtype], include_pad=int(include_pad), adjoint=0, vec=g.vec,
                      cvb=g.cvb, chunk_w=g.chunk_w, n_chunks=g.n_chunks, band_h=g.band_h, n_bands=g.n_bands,
                      stream=0xBEEF)
        _check_order(fast_pool._AVG_POOL, "avg_pool3x3.cu", values, got)

    @pytest.mark.parametrize("shape,dtype", [((64, 17, 17, 768), torch.float32), ((64, 35, 35, 288), torch.bfloat16)])
    @pytest.mark.parametrize("include_pad", [True, False])
    def test_avg_pool_backward_kernel(self, fake_wrapper_call, shape, dtype, include_pad):
        """K2's backward hands K2's entry the forward's arguments, the
        gradient in the input's place, in the forward mode where the padding
        counts (the pool is its own adjoint) and in the adjoint mode where it
        does not."""
        got = fake_wrapper_call(fast_pool.avg_pool_backward_kernel, fast_pool._AVG_POOL,
                                torch.zeros(shape, dtype=dtype), include_pad)
        g = fast_pool.pool_geometry(shape, dtype)
        values = dict(x=X_AT, out=OUT_AT, B=shape[0], H=shape[1], W=shape[2], C=shape[3],
                      dtype=fast_pool._DTYPES[dtype], include_pad=int(include_pad), adjoint=int(not include_pad),
                      vec=g.vec, cvb=g.cvb, chunk_w=g.chunk_w, n_chunks=g.n_chunks, band_h=g.band_h,
                      n_bands=g.n_bands, stream=0xBEEF)
        _check_order(fast_pool._AVG_POOL, "avg_pool3x3.cu", values, got)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", [(64, 64, 64, 3), (3, 5, 7, 3)])
    def test_normalize_kernel(self, fake_wrapper_call, monkeypatch, shape, dtype):
        """K1's wrapper hands tise_normalize the tensors, the element count,
        normalize_geometry's cut, the dtype code and the recipe's six
        constants."""
        monkeypatch.setattr(torch, "empty", lambda s, dtype, device: _FakeCudaTensor(torch.zeros(s, dtype=dtype), OUT_AT))
        got = fake_wrapper_call(preprocess.normalize_kernel, preprocess._NORMALIZE,
                                torch.zeros(shape, dtype=torch.uint8), "clip", dtype)
        g = preprocess.normalize_geometry(torch.Size(shape).numel(), True)
        s0, s1, s2, b0, b1, b2 = preprocess._kernel_constants("clip", dtype)
        values = dict(x=X_AT, out=OUT_AT, n=torch.Size(shape).numel(), body_blocks=g.body_blocks, tail=g.tail,
                      blocks=g.blocks, dtype=preprocess._DTYPE_CODES[dtype], s0=s0, s1=s1, s2=s2, b0=b0, b1=b1, b2=b2,
                      stream=0xBEEF)
        _check_order(preprocess._NORMALIZE, "normalize.cu", values, got)

    @pytest.mark.parametrize("return_last", [False, True])
    @pytest.mark.parametrize("m,k,n", [(2384, 27, 32), (1176, 1152, 128), (130, 45, 24)])
    def test_stem_mm_kernel(self, fake_cuda, monkeypatch, m, k, n, return_last):
        """P6's wrapper hands tise_stem_mm the operands, the outputs (no y
        unless asked), the sizes, stem_geometry's nb and shared-memory bytes
        and the step count."""
        stand_in = _StandIn()
        monkeypatch.setattr(stem_mm_probe._STEM_MM, "call", stand_in)
        made = []

        def empty(shape, dtype, device):
            made.append(tuple(shape))
            return _FakeCudaTensor(torch.zeros(shape, dtype=dtype), OUT_AT + len(made))

        monkeypatch.setattr(torch, "empty", empty)
        x = _FakeCudaTensor(torch.zeros(m, k, dtype=torch.bfloat16), X_AT)
        w = _FakeCudaTensor(torch.zeros(k, n, dtype=torch.bfloat16), X_AT + 1)
        before = stem_mm_probe.stem_mm_kernel.launches
        stem_mm_probe.stem_mm_kernel(x, w, 7, return_last=return_last)
        assert stem_mm_probe.stem_mm_kernel.launches == before + 1 and len(stand_in.calls) == 1
        g = stem_mm_probe.stem_geometry(m, k, n)
        blocks = g.grid[0] * g.grid[1]
        assert made == [(1, 1), (blocks * stem_mm_probe.THREADS,)] + ([(m, n)] if return_last else [])
        values = dict(x=X_AT, w=X_AT + 1, s_out=OUT_AT + 1, sink=OUT_AT + 2, y_out=OUT_AT + 3 if return_last else None,
                      m=m, k=k, n=n, nb=g.nb, smem_bytes=g.smem_bytes, nsteps=7, stream=0xBEEF)
        _check_order(stem_mm_probe._STEM_MM, "stem_mm.cu", values, stand_in.calls[0])

    @pytest.mark.parametrize("shape", [(8, 128, 27), (1, 4, 27), (3, 5, 8)])
    def test_dma_minor27_kernel(self, fake_wrapper_call, shape):
        """P2's wrapper hands tise_probe_dma_minor27 the tensors, the rows,
        their width and the rows of one run."""
        got = fake_wrapper_call(mosaic_probe.dma_minor27_kernel, mosaic_probe._DMA_MINOR27, torch.zeros(shape))
        run, _ = mosaic_probe.dma_minor27_runs(shape)
        values = dict(x=X_AT, out=OUT_AT, rows=shape[0] * shape[1], M=shape[2], run_rows=run, stream=0xBEEF)
        _check_order(mosaic_probe._DMA_MINOR27, "layout_probes.cu", values, got)

    @pytest.mark.parametrize("shape", [(3, 1, 27), (1, 1, 1025), (2, 3, 9)])
    def test_dma_minor27_refuses_rows_without_aligned_runs(self, fake_wrapper_call, shape):
        """Rows whose floats cannot be cut into runs of whole 16-byte words
        are refused before anything is launched."""
        with pytest.raises(ValueError, match="16-byte"):
            fake_wrapper_call(mosaic_probe.dma_minor27_kernel, mosaic_probe._DMA_MINOR27, torch.zeros(shape))


@pytest.mark.parametrize("source,name,value", [
    ("normalize.cu", "THREADS", preprocess.THREADS), ("normalize.cu", "WORDS", preprocess.WORDS),
    ("stem_mm.cu", "ROWS", stem_mm_probe.BLOCK_ROWS), ("stem_mm.cu", "THREADS", stem_mm_probe.THREADS)])
def test_python_cuts_use_the_sources_block_sizes(source, name, value):
    """K1's and P6's cuts are computed in Python from the block sizes their
    C sources are compiled with (the C entries refuse a cut that differs on
    the card); a drift between the two copies fails here first."""
    text = (native.CSRC / source).read_text()
    assert int(re.search(rf"constexpr int {name} = (\d+);", text).group(1)) == value


def test_stem_mm_source_has_an_instance_for_every_wgmma_n():
    """``tise_stem_mm`` launches exactly the wgmma n's stem_geometry may pick."""
    text = (native.CSRC / "stem_mm.cu").read_text()
    assert tuple(int(n) for n in re.findall(r"case (\d+): return launch<\1>", text)) == stem_mm_probe.WGMMA_N
    assert tuple(int(n) for n in re.findall(r"template <> struct Mma<(\d+)>", text)) == stem_mm_probe.WGMMA_N


def test_nothing_is_built_or_bound_on_import():
    """Importing every module that holds a ctypes kernel loads no library,
    binds no symbol and starts no compiler."""
    code = (
        "import subprocess\n"
        "def refuse(*a, **k): raise AssertionError('a process was started on import')\n"
        "subprocess.Popen = refuse\n"
        "from tise_tpu_torch.ops import native, fast_pool, pallas_kernels, preprocess\n"
        "from tise_tpu_torch.tools import mosaic_probe, stem_mm_probe, epilogue_matmul_compare, kernel_compare\n"
        "assert native._LIBS == {} and native.BUILD_LOG == {}\n"
        "entries = [v for m in (preprocess, fast_pool, pallas_kernels, mosaic_probe, stem_mm_probe)\n"
        "           for v in vars(m).values() if isinstance(v, native.CFunction)]\n"
        "assert len(entries) == 10, len(entries)\n"
        "assert all(e.call is None for e in entries)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], check=True, capture_output=True, text=True)
    assert out.stdout.strip() == "ok"


class TestDeviceDefaults:
    """``device=None`` means the card.  These tests run where there is none."""

    def _no_card(self):
        if torch.cuda.is_available():
            pytest.skip("shows what happens without a CUDA device; one is present")

    @pytest.mark.parametrize("method", ["ns", "ns-pallas"])
    def test_frechet_distance_without_device_raises(self, method):
        self._no_card()
        rng = np.random.RandomState(0)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            sqrtm.frechet_distance(rng.randn(8), _random_psd(rng, 8), rng.randn(8), _random_psd(rng, 8), method=method)

    @pytest.mark.parametrize("method", ["ns", "ns-pallas"])
    def test_trace_sqrtm_product_without_device_raises(self, method):
        self._no_card()
        rng = np.random.RandomState(1)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            sqrtm.trace_sqrtm_product(_random_psd(rng, 8), _random_psd(rng, 8), method=method)

    def test_init_moments_without_device_raises(self):
        self._no_card()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            stats.init_moments(16)

    def test_inception_v3_without_device_raises(self):
        """The trunk goes to the card unless the CPU is asked for; the device
        is resolved before any weight is read."""
        self._no_card()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            inception_v3.InceptionV3.from_state_dict({})

    def test_fast_inception_without_device_raises(self):
        self._no_card()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            inception_fast.FastInception(folded={"w": {}, "fc": None})

    def test_fast_inception_on_the_cpu_when_asked(self):
        net = inception_fast.FastInception(folded={"w": {}, "fc": None}, device="cpu")
        assert net.device == torch.device("cpu")

    def test_trace_sqrtm_product_ns_pallas_on_the_cpu_matches_jax(self):
        """The K3 iteration (plain step on the CPU) against the Pallas one: 1e-4 relative."""
        rng = np.random.RandomState(5)
        s1, s2 = _random_psd(rng, 32), _random_psd(rng, 32)
        ref = jsqrtm.trace_sqrtm_product(s1, s2, method="ns-pallas")
        got = sqrtm.trace_sqrtm_product(s1, s2, method="ns-pallas", device="cpu")
        assert abs(got - ref) <= 1e-4 * abs(ref)

    def test_init_moments_on_the_cpu_matches_jax(self):
        ts, js = stats.init_moments(16, device="cpu"), jstats.init_moments(16)
        for name in ("count", "total", "outer", "total_c", "outer_c"):
            got, ref = getattr(ts, name), np.asarray(getattr(js, name))
            assert got.device.type == "cpu" and got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)


class TestEpilogueMatmulRaggedSizes:
    @pytest.mark.parametrize("n", [1, 127, 130])
    def test_cpu_path_matches_jax_pallas_kernel(self, n):
        """K3 on CPU tensors against the Pallas kernel (interpret mode) at
        the sizes that take the ragged instances on the card: smaller than a
        tile, rows not 16-byte aligned, one tile and a sliver.  f32 sums in
        another order: 1e-5 of the output's scale."""
        rng = np.random.RandomState(n)
        a = rng.randn(n, n).astype(np.float32)
        b = rng.randn(n, n).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jpallas.epilogue_matmul(jnp.asarray(a), jnp.asarray(b), alpha=1.5, beta=-0.5))
        got = pallas_kernels.epilogue_matmul(torch.from_numpy(a), torch.from_numpy(b), 1.5, -0.5).numpy()
        assert got.shape == ref.shape == (n, n)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
