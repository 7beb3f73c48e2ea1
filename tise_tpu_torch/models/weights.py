"""Generator and discriminator weights: the JAX package's params carried
across, seeded ones, and the strict load (the generator side of
tise_tpu/models/generate.py's checkpoint handling), and the JAX trainer's
``TrainState`` as the port's trainer state.

The port's generators keep the Flax module names, so a Flax path maps to a
state-dict key by three renames: ``Conv_i`` -> ``conv{i}``,
``SyncBatchNorm_0`` -> ``bn``, and the ``bn`` inside each ``SyncBatchNorm``
wrapper is dropped (``up1/SyncBatchNorm_0/bn/scale`` ->
``up1.bn.weight``, ``res0/bn1/bn/mean`` -> ``res0.bn1.running_mean``).
Conv kernels go from HWIO to OIHW, dense kernels from [in, out] to
[out, in].  A discriminator's ``SpectralConv_i`` is ``conv{i}``, with its
power-iteration vector ``u`` (the JAX ``spectral`` collection) as a buffer.  Loading is strict: a tree made for another ``r_num``, branch
count or width raises and names the keys that do not fit (the JAX CLIs
apply a Flax module to any tree whose used leaves fit, so an ``r_num=3``
checkpoint silently loses a residual block a stage under their
``r_num=2``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from tise_tpu_torch.backbones import damsm
from tise_tpu_torch.core.config import resolve_device
from tise_tpu_torch.core.weights import flatten_pytree
from tise_tpu_torch.models.attngan_pp.discriminator import DNet
from tise_tpu_torch.models.attngan_pp.generator import GanConfig, GNet
from tise_tpu_torch.models.counter_model.discriminator import MSGDNet
from tise_tpu_torch.models.counter_model.generator import CounterGNet

GENERATORS = {"attngan_pp": GNet, "counter_model": CounterGNet}
_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def make_generator(model: str, cfg: GanConfig) -> nn.Module:
    if model not in GENERATORS:
        raise ValueError(f"unknown generator {model!r}; one of {sorted(GENERATORS)}")
    return GENERATORS[model](cfg)


def _torch_segment(seg: str) -> str:
    if seg == "SyncBatchNorm_0":
        return "bn"
    return re.sub(r"^(?:Spectral)?Conv_(\d+)$", r"conv\1", seg)


def _jax_segment(seg: str) -> str:
    if seg == "bn":
        return "SyncBatchNorm_0"
    return re.sub(r"^conv(\d+)$", r"Conv_\1", seg)


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k in sorted(tree):
        if isinstance(tree[k], Mapping):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(tree[k])


def g_state_dict_from_jax_params(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                                 model: str = "attngan_pp") -> Dict[str, np.ndarray]:
    """A JAX ``GNet``/``CounterGNet`` params tree and its ``batch_stats``
    (numpy leaves, as ``load_pytree_npz`` gives them) -> the port's state
    dict for ``model``.  Keys are not checked here: the strict load does."""
    if model not in GENERATORS:
        raise ValueError(f"unknown generator {model!r}; one of {sorted(GENERATORS)}")
    params = params.get("params", params)
    batch_stats = batch_stats.get("batch_stats", batch_stats)
    out: Dict[str, np.ndarray] = {}
    for tree in (params, batch_stats):
        for path, v in _leaves(tree):
            *mods, leaf = path
            if mods and mods[-1] == "bn":  # the nn.BatchNorm inside a SyncBatchNorm
                key = ".".join(_torch_segment(s) for s in mods[:-1])
                out[f"{key}.{_BN_LEAVES[leaf]}"] = v.astype(np.float32)
                out.setdefault(f"{key}.num_batches_tracked", np.zeros((), np.int64))
                continue
            key = ".".join(_torch_segment(s) for s in mods)
            if leaf == "kernel":
                v = np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v.T
                leaf = "weight"
            out[f"{key}.{leaf}"] = np.ascontiguousarray(v, np.float32)
    return out


def jax_params_from_g_state_dict(state: Mapping[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse: a state dict -> (params, batch_stats) in the JAX tree's
    layout, numpy leaves (for writing the JAX package's ``.npz``)."""
    state = {k: np.asarray(v) for k, v in state.items()}
    bns = {k[:-len(".running_mean")] for k in state if k.endswith(".running_mean")}
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    for key, v in state.items():
        prefix, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        path = [_jax_segment(s) for s in prefix.split(".")]
        if prefix in bns:
            name = {v_: k_ for k_, v_ in _BN_LEAVES.items()}[leaf]
            tree, path = (batch_stats if leaf.startswith("running_") else params), path + ["bn"]
        else:
            name = "kernel" if leaf == "weight" else leaf
            if name == "kernel":
                v = np.transpose(v, (2, 3, 1, 0)) if v.ndim == 4 else v.T
            tree = params
        node = tree
        for seg in path:
            node = node.setdefault(seg, {})
        node[name] = np.ascontiguousarray(v, np.float32)
    return params, batch_stats


def save_generator_npz(path: str, state: Mapping[str, Any]) -> None:
    """A generator checkpoint in the JAX package's ``.npz`` layout: the
    params under ``g_ema`` and the running statistics under
    ``g_batch_stats``, as ``generate.load_generator_from_checkpoint`` (and
    the JAX CLIs) read it."""
    params, batch_stats = jax_params_from_g_state_dict(state)
    np.savez(path, **flatten_pytree(params, "g_ema/"), **flatten_pytree(batch_stats, "g_batch_stats/"))


def random_g_state_dict(seed: int, cfg: GanConfig, model: str = "attngan_pp") -> Dict[str, np.ndarray]:
    """Seeded generator weights made with numpy: every conv and dense weight
    normal with std 1/sqrt(fan in) (the variance of Flax's lecun_normal),
    biases zero, BatchNorm scale 1, shift 0, running moments 0 and 1."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in make_generator(model, cfg).state_dict().items()}
    bns = {k[:-len(".running_mean")] for k in shapes if k.endswith(".running_mean")}
    rng = np.random.RandomState(seed)
    out: Dict[str, np.ndarray] = {}
    for key, shape in shapes.items():
        prefix, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            out[key] = np.zeros((), np.int64)
        elif prefix in bns:
            out[key] = (np.ones if leaf in ("weight", "running_var") else np.zeros)(shape, np.float32)
        elif leaf == "weight":
            out[key] = (rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)
        else:
            out[key] = np.zeros(shape, np.float32)
    return out


def load_generator(state: Mapping[str, Any], cfg: GanConfig, model: str = "attngan_pp", device=None) -> nn.Module:
    """An eval-mode generator on ``device`` (``None`` is the card, and raises
    where there is none) holding ``state``, loaded strictly."""
    device = resolve_device(device)
    net = make_generator(model, cfg)
    net.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in state.items()}, strict=True)
    return net.eval().to(device)


def r_num_of(state: Mapping[str, Any], default: int) -> int:
    """The residual blocks a stage holds in a generator state dict
    (``<stage>.res0`` .. ``res{n-1}``), or ``default`` where no stage has
    any.  A tree whose stages disagree is still refused by the strict load."""
    found = [int(m.group(1)) for k in state for m in [re.match(r"\w+\.res(\d+)\.", k)] if m]
    return max(found) + 1 if found else default


# ---------------------------------------------------------------------------
# Discriminators and the trainer's state
# ---------------------------------------------------------------------------


def _conv_leaf(leaf: str, v: np.ndarray) -> Tuple[str, np.ndarray]:
    if leaf == "kernel":
        return "weight", np.transpose(v, (3, 2, 0, 1))
    return leaf, v


def d_state_dict_from_jax_params(params: Mapping[str, Any], spectral: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX ``DNet``'s or ``MSGDNet``'s params and its ``spectral``
    collection (numpy leaves) -> the port's state dict: every spectral
    conv's kernel, bias and u, and the plain convs (the heads' ``out``,
    the MSG D's ``fRGB_0``).  A kernel's input channels keep their order:
    the port concatenates in the JAX order on dim 1."""
    out: Dict[str, np.ndarray] = {}
    for tree in (params.get("params", params), spectral.get("spectral", spectral)):
        for path, v in _leaves(tree):
            *mods, leaf = path
            leaf, v = _conv_leaf(leaf, v)
            out[".".join(_torch_segment(s) for s in mods) + f".{leaf}"] = np.ascontiguousarray(v, np.float32)
    return out


def jax_params_from_d_state_dict(state: Mapping[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse: a ``DNet`` or ``MSGDNet`` state dict -> (params,
    spectral) in the JAX tree's layout, numpy leaves.  Only the module that
    holds a leaf is a ``SpectralConv_i`` (the MSG D's ``conv1``/``conv2``
    blocks keep their names)."""
    params: Dict[str, Any] = {}
    spectral: Dict[str, Any] = {}
    for key, v in state.items():
        prefix, leaf = key.rsplit(".", 1)
        v = np.asarray(v)
        *outer, inner = prefix.split(".")
        path = outer + [re.sub(r"^conv(\d+)$", r"SpectralConv_\1", inner)]
        tree = spectral if leaf == "u" else params
        if leaf == "weight":
            leaf, v = "kernel", np.transpose(v, (2, 3, 1, 0))
        node = tree
        for seg in path:
            node = node.setdefault(seg, {})
        node[leaf] = np.ascontiguousarray(v, np.float32)
    return params, spectral


def random_d_state_dict(seed: int, ndf: int, nef: int, scale: int) -> Dict[str, np.ndarray]:
    """Seeded discriminator weights made with numpy: conv weights normal with
    std 1/sqrt(fan in) (the variance of Flax's lecun_normal), biases zero,
    every u standard normal."""
    return _random_d(seed, lambda: DNet(ndf, nef, scale))


def random_msg_d_state_dict(seed: int, ndf: int, nef: int) -> Dict[str, np.ndarray]:
    """The same for the CounterModel's ``MSGDNet``."""
    return _random_d(seed, lambda: MSGDNet(ndf, nef))


def _random_d(seed: int, make) -> Dict[str, np.ndarray]:
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in make().state_dict().items()}
    rng = np.random.RandomState(seed)
    out: Dict[str, np.ndarray] = {}
    for key, shape in shapes.items():
        leaf = key.rsplit(".", 1)[1]
        if leaf == "weight":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif leaf == "u":
            v = rng.standard_normal(shape)
        else:
            v = np.zeros(shape)
        out[key] = v.astype(np.float32)
    return out


class TrainStateDicts(NamedTuple):
    """The trainable state as state dicts: G's (parameters and running
    statistics), the EMA of G's parameters (parameter names only), and the
    Ds (parameters and u): one a scale by scale for AttnGAN++, the one MSG D
    for the CounterModel.  Adam's moments are not carried: they start at
    zero in both packages."""

    step: int
    g: Dict[str, np.ndarray]
    g_ema: Dict[str, np.ndarray]
    d: Any  # Dict[int, state dict] (attngan_pp) or one state dict (counter_model)


def train_state_dicts_from_jax(state: Any, model: str = "attngan_pp") -> TrainStateDicts:
    """The JAX trainer's ``TrainState`` or ``CounterTrainState`` (numpy
    leaves, as ``jax.device_get`` gives them) -> the port's
    ``TrainStateDicts``; the CounterModel's ``d_params`` is one tree."""
    g = g_state_dict_from_jax_params(state.g_params, state.g_batch_stats, model)
    ema = g_state_dict_from_jax_params(state.g_ema, {}, model)
    ema = {k: v for k, v in ema.items() if not k.endswith("num_batches_tracked")}
    if model == "counter_model":
        d = d_state_dict_from_jax_params(state.d_params, state.d_spectral)
    else:
        d = {int(k): d_state_dict_from_jax_params(state.d_params[k], state.d_spectral[k]) for k in state.d_params}
    return TrainStateDicts(int(np.asarray(state.step)), g, ema, d)


def damsm_state_dicts_from_jax(state: Any) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """The JAX ``DamsmTrainState``'s ``rnn_params`` and ``cnn_params``
    (numpy leaves) -> (text encoder, image encoder) state dicts in the
    reference's layout, which ``models.damsm_pretrain.init_state`` loads
    (the trunk and both heads)."""
    return damsm.rnn_state_dict_from_jax_params(state.rnn_params), damsm.cnn_state_dict_from_jax_params(state.cnn_params)
