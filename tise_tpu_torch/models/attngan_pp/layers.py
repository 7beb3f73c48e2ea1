"""Building blocks of AttnGAN++ and CounterModel in PyTorch, NCHW (mirrors
tise_tpu/models/attngan_pp/layers.py; reference: AttnGAN++/layers.py,
spectral.py).

  * GLU halves the channels, a * sigmoid(b) (:7-15): the channel axis is
    dim 1 here, the last axis in the JAX package, so a dense layer's
    features [B, F] and a feature map's channels split alike;
  * upBlock: nearest 2x upsample -> conv3x3 -> BN -> GLU (:29-36);
  * ResBlock: conv/BN/GLU/conv/BN + skip (:45-60);
  * D blocks: spectral-normalised convs + LeakyReLU(0.2) (:64-90), the
    power iteration written out as the JAX ``SpectralConv`` does it.

The JAX package's ``SyncBatchNorm`` is Flax's ``nn.BatchNorm(momentum=0.9)``
with eps 1e-5, whose moments are global over the sharded batch.  In eval
mode it reads its running statistics, as ``nn.BatchNorm`` does.  In train
mode it normalises with the batch's biased variance and moves the running
variance towards that same biased variance; ``nn.BatchNorm`` would move it
towards the unbiased one (4/3 as large over the 4 rows of a batch of 4).
So ``batch_norm`` builds a BatchNorm whose train mode keeps Flax's running
statistics: Flax's ``momentum=0.9`` (weight of the old running value) is
``momentum=0.1`` here (weight of the batch's).  Its moments are those of
the local batch, or, under ``synced_batch_norm``, of the global batch whose
shards the processes of a group hold (``global_moments``: the JAX module's
moments over a sharded batch).  Submodules keep the Flax
names with ``Conv_i`` as ``conv{i}``, ``SpectralConv_i`` as ``conv{i}`` and
``SyncBatchNorm_0/bn`` as ``bn`` (``models/weights.py``).
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tise_tpu_torch.parallel import gather_rows

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch's convention; Flax's momentum=0.9


def glu(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=1)
    return a * torch.sigmoid(b)


def global_moments(x: torch.Tensor, dims, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """(biased variance, mean) over ``dims`` of the global batch whose
    shards the processes of ``group`` hold, each the same size, with the
    gradient through both: each process's (mean, sum of squared deviations)
    is gathered and merged as Chan et al.'s parallel variance does, so no
    sum of squares cancels."""
    n = x.numel() // x.shape[1]
    mean = x.mean(dim=dims)
    m2 = ((x - mean.view(_channel_shape(x))) ** 2).sum(dim=dims)
    stats = gather_rows(torch.stack([mean, m2])[None], group)  # [processes, 2, C]
    means, m2s = stats[:, 0], stats[:, 1]
    g_mean = means.mean(dim=0)
    var = (m2s.sum(dim=0) + n * ((means - g_mean) ** 2).sum(dim=0)) / (n * stats.shape[0])
    return var, g_mean


def _channel_shape(x: torch.Tensor) -> Tuple[int, ...]:
    return (1, x.shape[1]) + (1,) * (x.dim() - 2)


class _FlaxRunningStats:
    """Train mode as Flax's BatchNorm: normalise with the batch's mean and
    biased variance, and move both running statistics towards those.  Under
    :func:`synced_batch_norm` the batch is the global one whose shards the
    processes of a group hold (the JAX ``SyncBatchNorm`` over a sharded
    batch)."""

    group = None  # a process group while synced

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = [0] + list(range(2, x.dim()))
        if self.group is None:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=dims, correction=0)
                self._move_running(mean, var)
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        var, mean = global_moments(x, dims, self.group)
        with torch.no_grad():
            self._move_running(mean, var)
        shape = _channel_shape(x)
        scale = self.weight.view(shape) * torch.rsqrt(var.view(shape) + self.eps)
        return (x - mean.view(shape)) * scale + self.bias.view(shape)

    def _move_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.lerp_(mean, self.momentum)
        self.running_var.lerp_(var, self.momentum)
        self.num_batches_tracked += 1


class BatchNorm1d(_FlaxRunningStats, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxRunningStats, nn.BatchNorm2d):
    pass


def batch_norm(features: int, dims: int = 2) -> nn.Module:
    """The JAX ``SyncBatchNorm`` (eval mode reads the running statistics,
    train mode keeps Flax's)."""
    cls = BatchNorm2d if dims == 2 else BatchNorm1d
    return cls(features, eps=BN_EPS, momentum=BN_MOMENTUM)


@contextlib.contextmanager
def synced_batch_norm(module: nn.Module, group):
    """Inside the block, every train-mode BatchNorm of ``module`` takes its
    moments over the global batch of ``group``'s processes (``None``: this
    process's batch)."""
    norms = [m for m in module.modules() if isinstance(m, _FlaxRunningStats)]
    for m in norms:
        m.group = group
    try:
        yield
    finally:
        for m in norms:
            m.group = None


def nearest_upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Each pixel repeated factor x factor times (NCHW)."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class Block3x3Relu(nn.Module):
    """conv3x3(out*2) -> BN -> GLU, keeps spatial size (layers.py:40-42)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv0 = conv3x3(cin, features * 2)
        self.bn = batch_norm(features * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return glu(self.bn(self.conv0(x)))


class UpBlock(Block3x3Relu):
    """nearest 2x -> conv3x3(out*2) -> BN -> GLU (layers.py:29-36)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(nearest_upsample(x))


class ResBlockG(nn.Module):
    """Generator residual block (layers.py:45-60)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv0 = conv3x3(channels, channels * 2)
        self.bn1 = batch_norm(channels * 2)
        self.conv1 = conv3x3(channels, channels)
        self.bn2 = batch_norm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = glu(self.bn1(self.conv0(x)))
        return x + self.bn2(self.conv1(y))


# ---------------------------------------------------------------------------
# Discriminator blocks
# ---------------------------------------------------------------------------


def l2_normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + 1e-12)


class SpectralConv(nn.Module):
    """Conv whose kernel is divided by its leading singular value, estimated
    by one power-iteration step a call (spectral.py:19-31; the JAX
    ``SpectralConv``, layers.py:110-157).  W is viewed as (out, -1);
    ``u`` is a buffer, normalised before use; v = l2n(W^T u) and
    u_new = l2n(W v) carry no gradient; sigma = u_new . (W v) does,
    through W only.  ``u`` is not written here: with ``update_stats`` the
    call keeps u_new in ``pending_u``, and ``commit_u`` stores it, so every
    call of a step starts from the u of the step's start, as the JAX
    step's discarded ``mutable`` collections do."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1, padding: int = 1, bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(features, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None
        self.register_buffer("u", torch.ones(features))
        self.pending_u = None

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        w_mat = self.weight.flatten(1)
        with torch.no_grad():
            u = l2_normalize(self.u)
            v = l2_normalize(w_mat.t() @ u)
            u_new = l2_normalize(w_mat @ v)
        if update_stats:
            self.pending_u = u_new
        sigma = u_new @ (w_mat @ v)
        return F.conv2d(x, self.weight / sigma, self.bias, self.stride, self.padding)

    def commit_u(self) -> None:
        if self.pending_u is not None:
            self.u.copy_(self.pending_u)
            self.pending_u = None


def commit_spectral(module: nn.Module) -> None:
    """Store the u that the spectral convs of ``module`` kept pending."""
    for m in module.modules():
        if isinstance(m, SpectralConv):
            m.commit_u()


def leaky(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2) in place on a conv's output, which nothing else reads:
    autograd then keeps one tensor for the activation and the next conv's
    input, not two (a D pass at 256 px and batch 64 holds gigabytes of
    them); the values are those of ``F.leaky_relu``."""
    return F.leaky_relu(x, 0.2, inplace=True)


class DownBlockD(nn.Module):
    """Spectral conv4x4 stride 2 + LeakyReLU(0.2) (layers.py:70-74)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv0 = SpectralConv(cin, features, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        return leaky(self.conv0(x, update_stats))


class Block3x3LeakyD(nn.Module):
    """Spectral conv3x3 + LeakyReLU(0.2), keeps the size (layers.py:64-67)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv0 = SpectralConv(cin, features, 3, stride=1, padding=1)

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        return leaky(self.conv0(x, update_stats))


class EncodeBy16(nn.Module):
    """Four stride-2 spectral convs: image -> 1/16 the side, 8 ndf channels
    (layers.py:78-90)."""

    def __init__(self, ndf: int):
        super().__init__()
        cin = 3
        for i, mult in enumerate((1, 2, 4, 8)):
            setattr(self, f"down{i}", DownBlockD(cin, ndf * mult))
            cin = ndf * mult

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        for i in range(4):
            x = getattr(self, f"down{i}")(x, update_stats)
        return x
