"""The port's FID CLI with the device resize (``--device-resize-from``), in
f32 and with the bf16 fast trunk, against the JAX package's CLI on the CPU.

One numpy-made torchvision-layout state dict goes into both packages (the
JAX side through params_from_torch_state_dict, saved as the npz both CLIs
read); two folders of 8 blocky 64 x 64 PNGs are the inputs.
"""

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from tise_tpu.backbones import inception_v3 as jinception
from tise_tpu.core import weights as jweights
from tise_tpu.metrics import fid as jfid
from tise_tpu_torch.backbones import inception_v3 as tinception
from tise_tpu_torch.core import io as result_io
from tise_tpu_torch.metrics import fid as tfid

NUM_CLASSES = 10


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


def _write_folder(root, n, seed, block):
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    cells = 64 // block
    for i in range(n):
        arr = np.kron(rng.randint(0, 256, (cells, cells, 3)), np.ones((block, block, 1))).astype(np.uint8)
        Image.fromarray(arr).save(str(root / f"{i:03d}.png"))
    return str(root)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("fast")
    weights = str(root / "planted.npz")
    state_dict = tinception.random_state_dict(seed=3, num_classes=NUM_CLASSES)
    jweights.save_pytree_npz(weights, jinception.params_from_torch_state_dict(state_dict, num_classes=NUM_CLASSES))
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
