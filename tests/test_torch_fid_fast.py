"""The port's FID CLI under ``--precision fast`` (the bf16 folded trunk)
against the JAX package's on the CPU, and the precision switch itself.

The same inputs as tests/test_torch_fid.py: two folders of 12 blocky 64x64
PNGs (resized to 299 by PIL on the host) and one npz of planted weights made
by numpy in the JAX package's pytree layout.  Each package's fast CLI runs
once for the whole module.
"""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from tise_tpu.backbones import inception_v3 as jinception
from tise_tpu.core import weights as jweights
from tise_tpu.metrics import fid as jfid
from tise_tpu_torch.backbones.inception_v3 import random_state_dict
from tise_tpu_torch.core import io as result_io
from tise_tpu_torch.metrics import fid as tfid


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


def _write_folder(root, n, seed, block):
    """n blocky RGB images: random colours on a grid of block x block cells."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    cells = 64 // block
    for i in range(n):
        arr = np.kron(rng.randint(0, 256, (cells, cells, 3)), np.ones((block, block, 1))).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(root, f"{i:03d}.png"))
    return str(root)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("fid_fast")
    weights = str(root / "planted.npz")
    params = jinception.params_from_torch_state_dict(random_state_dict(seed=0, num_classes=10), num_classes=10)
    jweights.save_pytree_npz(weights, params)
    return {
        "root": root,
        "a": _write_folder(root / "a", 12, seed=1, block=16),
        "b": _write_folder(root / "b", 12, seed=2, block=4),
        "weights": weights,
    }


@pytest.fixture(scope="module")
def fast_runs(world):
    """Each package's FID CLI with --precision fast (host resize) and
    --save_stats, once, and the port's f32 --save_stats beside them.  The JAX
    flag sets a process-wide matmul precision; it is put back."""
    root, out = world["root"], {}
    f32_stats = str(root / "stats_a_torch_f32.npz")
    tfid.main(["--path1", world["a"], "--save_stats", f32_stats, "--weights", world["weights"],
               "--batch-size", "4", "--device", "cpu"])
    out["torch f32"] = {"stats": f32_stats}
    before = jax.config.jax_default_matmul_precision
    try:
        for name, main, device in (("jax", jfid.main, []), ("torch", tfid.main, ["--device", "cpu"])):
            saved = str(root / f"fid_fast_{name}.txt")
            main(["--path1", world["a"], "--path2", world["b"], "--weights", world["weights"], "--sqrtm", "eigh",
                  "--batch-size", "4", "--saved_file", saved, "--precision", "fast", *device])
            stats_npz = str(root / f"stats_fast_a_{name}.npz")
            main(["--path1", world["a"], "--save_stats", stats_npz, "--weights", world["weights"],
                  "--batch-size", "4", "--precision", "fast", *device])
            out[name] = {"saved": saved, "stats": stats_npz}
    finally:
        jax.config.update("jax_default_matmul_precision", before)
    return out


def test_precision_fast_cli_matches_jax(fast_runs):
    """--precision fast runs the bf16 folded trunk in both packages.  bf16
    rounds at other places in the two frameworks (features agree to about
    1e-2 of their scale), so the distances are held to 5% of each other."""
    ref = result_io.read_fid_result(fast_runs["jax"]["saved"])
    got = result_io.read_fid_result(fast_runs["torch"]["saved"])
    assert np.isfinite(got) and got > 0.0
    assert abs(got - ref) <= 5e-2 * abs(ref), (got, ref)


def test_precision_fast_stats_match_jax_and_the_f32_run(fast_runs):
    """--save_stats under --precision fast: mu within 0.04 of its scale (the
    bf16 tolerance of tests/test_inception.py) of the JAX fast run's and of
    the port's own f32 run's."""
    mu, sigma = result_io.load_stats_npz(fast_runs["torch"]["stats"])
    assert mu.shape == (2048,) and sigma.shape == (2048, 2048) and np.isfinite(sigma).all()
    for other in (fast_runs["jax"]["stats"], fast_runs["torch f32"]["stats"]):
        ref_mu, _ = result_io.load_stats_npz(other)
        assert np.abs(mu - ref_mu).max() <= 0.04 * np.abs(ref_mu).max()
    f32_mu, _ = result_io.load_stats_npz(fast_runs["torch f32"]["stats"])
    assert not np.array_equal(mu, f32_mu)  # the bf16 trunk did run


def test_precision_fast_keeps_tf32_off():
    """"fast" lives in the folded trunk's dtype: TF32 stays off process-wide,
    so the Fréchet stage of a fast run is IEEE like a highest one's."""
    from tise_tpu_torch.core.config import configure_precision

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    configure_precision("fast")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    with pytest.raises(ValueError):
        configure_precision("fastest")


def test_precision_highest_turns_tf32_off():
    """cuDNN convolutions default to TF32 on Hopper; "highest" turns it off
    for convolutions and matmuls both."""
    from tise_tpu_torch.core.config import configure_precision

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    configure_precision("highest")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
