"""tise-tpu-torch: the PyTorch / CUDA port of ``tise_tpu`` for NVIDIA Hopper.

The JAX package ``tise_tpu`` is the reference; this package mirrors its
module names so each file sits opposite its counterpart
(``tise_tpu_torch/ops/fast_pool.py`` <-> ``tise_tpu/ops/fast_pool.py``).
Plain tensor code is PyTorch; each TPU Pallas kernel of the ported slices is
a kernel written by hand for Hopper (``csrc/*.cu`` built with nvcc at first
use, or Triton), with a plain PyTorch version beside it that CPU tensors use.

Ported so far: the FID slice (``python -m tise_tpu_torch.metrics.fid``) and
O-FID on the same engine.  This package never imports ``jax`` or
``tise_tpu``.
"""

__version__ = "0.1.0"
