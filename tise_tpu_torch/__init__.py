"""tise-tpu-torch: the PyTorch / CUDA port of ``tise_tpu`` for NVIDIA Hopper.

The JAX package ``tise_tpu`` is the reference; this package mirrors its
module names so each file sits opposite its counterpart
(``tise_tpu_torch/ops/fast_pool.py`` <-> ``tise_tpu/ops/fast_pool.py``).
Plain tensor code is PyTorch; each TPU Pallas kernel of the ported slices is
a kernel written by hand for Hopper in CUDA C++ (``csrc/*.cu``, built with
nvcc at first use), with a plain PyTorch version beside it that CPU tensors
use.

Ported so far: every metric of both tracks, FID, O-FID, IS*, O-IS, RP-COCO,
PA, RP-CUB, the object crop step, SOA and CA (``python -m
tise_tpu_torch.metrics.{fid,o_fid,is_star,o_is,rp_coco,pa,rp_cub,crop_objects,
soa,ca}``), the ranking table (``python -m
tise_tpu_torch.ranking.ranking_score``), both track runners (``python -m
tise_tpu_torch.benchmark --track coco|cub``), the two probe entry points, the
image-generation path (``python -m tise_tpu_torch.models.{generate,gen_example}``
with the AttnGAN++ and CounterModel generators), the calibration CLI
(``python -m tise_tpu_torch.calibration.cli``) and the download layer
(``python -m tise_tpu_torch.core.download``).  This package never imports ``jax`` or ``tise_tpu``, nor pandas or tabulate.
"""

__version__ = "0.1.0"
