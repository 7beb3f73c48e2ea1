"""Checkpoint loading and conversion (mirrors tise_tpu/core/weights.py).

Weights arrive in two layouts:
  * torchvision ``state_dict`` files (.pth), the reference's pretrained
    backbones; the port's modules use this key layout directly;
  * ``.npz`` pytrees (flat {'/'-joined path: array}) written by the JAX
    package; :func:`state_dict_from_jax_params` carries them across, and
    :func:`jax_params_from_state_dict` and :func:`save_pytree_npz` write
    them back (DAMSM pretraining's best encoders).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np


def flatten_pytree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """{'a': {'b': x}} -> {'a/b': x}, the JAX package's ``.npz`` keys."""
    out: Dict[str, np.ndarray] = {}
    for k in sorted(tree):
        if isinstance(tree[k], Mapping):
            out.update(flatten_pytree(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(tree[k])
    return out


def unflatten_pytree(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(v)
    return tree


def load_pytree_npz(path: str) -> Dict[str, Any]:
    with np.load(path, allow_pickle=False) as f:
        return unflatten_pytree({k: f[k] for k in f.files})


def save_pytree_npz(path: str, tree: Mapping[str, Any]) -> None:
    """A pytree as the JAX package's ``save_pytree_npz`` writes it, so that
    ``load_pytree_npz`` in either package reads it."""
    np.savez(path, **flatten_pytree(tree))


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Deserialize a torch .pth checkpoint to numpy arrays (CPU)."""
    import torch

    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v) for k, v in state.items()}


def state_dict_from_jax_params(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX InceptionV3 param pytree (numpy leaves) -> torchvision state_dict.

    The inverse of ``tise_tpu.backbones.inception_v3.params_from_torch_state_dict``:
    ``conv/kernel`` HWIO -> ``.conv.weight`` OIHW, ``bn_{scale,bias,mean,var}``
    -> ``.bn.{weight,bias,running_mean,running_var}``, ``fc/kernel`` [in, out]
    -> ``fc.weight`` [out, in].
    """
    tree = params.get("params", params)
    out: Dict[str, np.ndarray] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        if "conv" in node:
            out[f"{prefix}.conv.weight"] = np.ascontiguousarray(
                np.transpose(np.asarray(node["conv"]["kernel"]), (3, 2, 0, 1))
            )
            for src, dst in (("bn_scale", "weight"), ("bn_bias", "bias"),
                             ("bn_mean", "running_mean"), ("bn_var", "running_var")):
                out[f"{prefix}.bn.{dst}"] = np.asarray(node[src])
            return
        for k in sorted(node):
            walk(node[k], f"{prefix}.{k}" if prefix else k)

    for k in sorted(tree):
        if k == "fc":
            out["fc.weight"] = np.ascontiguousarray(np.asarray(tree["fc"]["kernel"]).T)
            out["fc.bias"] = np.asarray(tree["fc"]["bias"])
        else:
            walk(tree[k], k)
    return out


def jax_params_from_state_dict(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`state_dict_from_jax_params`: a torchvision
    InceptionV3 state dict (numpy leaves; ``num_batches_tracked`` and
    ``AuxLogits`` are dropped) -> the JAX package's param tree, without the
    ``params`` level."""
    tree: Dict[str, Any] = {}
    leaves = {"weight": "bn_scale", "bias": "bn_bias", "running_mean": "bn_mean", "running_var": "bn_var"}
    for key, v in state.items():
        v = np.asarray(v)
        if key.startswith("AuxLogits") or key.endswith("num_batches_tracked"):
            continue
        if key in ("fc.weight", "fc.bias"):
            tree.setdefault("fc", {})["kernel" if key == "fc.weight" else "bias"] = np.ascontiguousarray(
                v.T if key == "fc.weight" else v)
            continue
        module, kind, leaf = key.rsplit(".", 2)
        node = tree
        for part in module.split("."):
            node = node.setdefault(part, {})
        if kind == "conv":
            node["conv"] = {"kernel": np.ascontiguousarray(np.transpose(v, (2, 3, 1, 0)))}
        else:
            node[leaves[leaf]] = v
    return tree


def load_inception_state_dict(path: str) -> Dict[str, np.ndarray]:
    """InceptionV3 weights as a torchvision state_dict from .npz (a JAX
    pytree) or .pth (torchvision, used as is)."""
    if path.endswith(".npz"):
        return state_dict_from_jax_params(load_pytree_npz(path))
    return load_torch_state_dict(path)
