"""DAMSM text and image encoders in PyTorch (mirrors tise_tpu/backbones/damsm.py;
reference: text_relevance/encoders.py).

RNN_ENCODER (:24-114): embedding (300) -> [dropout, identity at eval] ->
one-layer bidirectional LSTM (128 units per direction) over packed sequences ->
  words_emb  [B, 256, T]  per-step forward || backward outputs, zero past
                          each length (pad_packed_sequence)
  sent_emb   [B, 256]     the final hidden states h_n of both directions

CNN_ENCODER (:117-219): bilinear align-corners upsample to 299 (:162) ->
torchvision InceptionV3 trunk -> region features: Mixed_6e (17x17x768)
through a 1x1 conv to nef = 256 (:218); global features: the final 8x8
average pool (2048) through a linear layer to nef = 256 (:215).

Each encoder has a no-grad ``forward`` (RP-CUB, the frozen encoders of GAN
training) and routes under autograd: ``CNNEncoder.encode`` (the GAN's
DAMSM loss pulls a gradient back to its input) and, for DAMSM pretraining,
``RNNEncoder.encode`` (to the embedding and the LSTM) and
``CNNEncoder.encode_heads`` (the frozen trunk under no_grad, the two heads
under autograd).

The LSTM is the library's ``nn.LSTM`` over ``pack_padded_sequence``: the
reference's semantics directly.  ``RNNEncoder(dtype=torch.bfloat16)`` is
the JAX ``RNNEncoder(dtype=bfloat16)``: the JAX module casts the embedded
words to bf16 and its cell multiplies them by its f32 weights, which
promotes them back, so the cell's gates, ``h`` and ``c`` are f32 and the
outputs f32.  Here the embedding is rounded to bf16 and the f32 LSTM runs
on it (the JAX module itself raises in its scan: its bf16 initial carry
does not match the f32 state the cell gives back).  The JAX package computes it as two masked
scans over the padded length; its backward scan starts each sequence at its
own last token, as the packed sequence does.  The trunk is the
port's InceptionV3, so kernel K2 runs its nine pools on the card.  Module and
parameter names are the reference checkpoints' (``encoder``, ``rnn.*_l0``;
torchvision trunk names plus ``emb_*``), so ``text_encoder200.pth`` and
``image_encoder200.pth`` load as they are; the ``*_from_jax_params``
functions carry the JAX package's params across.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from tise_tpu_torch.backbones import inception_v3
from tise_tpu_torch.backbones.inception_v3 import InceptionV3
from tise_tpu_torch.core.config import resolve_device
from tise_tpu_torch.core.weights import (jax_params_from_state_dict, load_pytree_npz, load_torch_state_dict,
                                         state_dict_from_jax_params)
from tise_tpu_torch.ops.preprocess import resize_bilinear_align_corners

IMAGE_SIZE = 299
_DIRECTIONS = (("fwd", ""), ("bwd", "_reverse"))
_LSTM_PARTS = (("w_ih", "weight_ih"), ("w_hh", "weight_hh"), ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))


def _tensors(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v)) for k, v in state.items()}


class RNNEncoder(nn.Module):
    """DAMSM text encoder (eval mode: dropout is the identity)."""

    def __init__(self, ntoken: int, ninput: int = 300, nhidden: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.encoder = nn.Embedding(ntoken, ninput)
        self.rnn = nn.LSTM(ninput, nhidden, batch_first=True, bidirectional=True)

    @classmethod
    def from_state_dict(cls, state: Mapping[str, Any], *, device=None,
                        dtype: torch.dtype = torch.float32) -> "RNNEncoder":
        """An eval-mode encoder on ``device`` (``None`` is the card, and
        raises where there is none) holding a reference-layout state dict;
        its shapes set the vocabulary and the widths; ``dtype`` the JAX
        module's (the embedding rounded to bf16 under bf16)."""
        device = resolve_device(device)
        ntoken, ninput = np.shape(state["encoder.weight"])
        model = cls(ntoken, ninput, np.shape(state["rnn.weight_hh_l0"])[1], dtype)
        model.load_state_dict(_tensors(state))
        return model.eval().to(device)

    @torch.no_grad()
    def forward(self, captions: torch.Tensor, lengths) -> Tuple[torch.Tensor, torch.Tensor]:
        """captions int [B, T] on the module's device, lengths [B] (each at
        least 1; kept on the host, as ``pack_padded_sequence`` needs them) ->
        (words_emb [B, 2H, T], sent_emb [B, 2H])."""
        return self._run(captions, lengths)

    def encode(self, captions: torch.Tensor, lengths) -> Tuple[torch.Tensor, torch.Tensor]:
        """``forward`` under autograd, to the embedding and the LSTM (DAMSM
        pretraining's route).  cuDNN keeps an RNN's backward for a forward
        run in train mode, so the LSTM runs in train mode here: one layer
        has no dropout, so that mode computes what eval mode does, and the
        embedding's dropout stays the identity, as in the JAX encoder."""
        was_training = self.rnn.training
        self.rnn.train()
        try:
            return self._run(captions, lengths)
        finally:
            self.rnn.train(was_training)

    def _run(self, captions: torch.Tensor, lengths) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t = captions.shape
        lengths = torch.as_tensor(lengths, dtype=torch.int64, device="cpu")
        emb = self.encoder(captions.long())
        if self.compute_dtype != torch.float32:  # the JAX cell's weights promote the rounded words back
            emb = emb.to(self.compute_dtype).to(emb.dtype)
        packed = pack_padded_sequence(emb, lengths, batch_first=True, enforce_sorted=False)
        out, (h_n, _) = self.rnn(packed)
        out, _ = pad_packed_sequence(out, batch_first=True, total_length=t)
        # h_n is [2, B, H], direction-major; the JAX package concatenates [h_fwd, h_bwd]
        return out.transpose(1, 2), h_n.transpose(0, 1).reshape(b, -1)


class CNNEncoder(nn.Module):
    """DAMSM image encoder: the InceptionV3 trunk and the nef-wide heads."""

    def __init__(self, trunk: InceptionV3, nef: int = 256):
        super().__init__()
        self.trunk = trunk
        self.emb_features = nn.Conv2d(768, nef, 1, bias=False)
        self.emb_cnn_code = nn.Linear(2048, nef)

    @classmethod
    def from_state_dict(cls, state: Mapping[str, Any], *, device=None) -> "CNNEncoder":
        """An eval-mode encoder on ``device`` (``None`` is the card) from a
        reference-layout state dict: torchvision trunk names at the top level
        (no fc) and the ``emb_*`` heads, which are split off before the trunk
        loads."""
        device = resolve_device(device)
        heads = {k: v for k, v in state.items() if k.startswith("emb_")}
        trunk = InceptionV3.from_state_dict({k: v for k, v in state.items() if not k.startswith("emb_")},
                                            device=device)
        model = cls(trunk, nef=np.shape(heads["emb_cnn_code.weight"])[0])
        model.emb_features.load_state_dict(_tensors({"weight": heads["emb_features.weight"]}))
        model.emb_cnn_code.load_state_dict(_tensors({"weight": heads["emb_cnn_code.weight"],
                                                     "bias": heads["emb_cnn_code.bias"]}))
        return model.eval().to(device)

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: normalized float NHWC [B, H, W, 3] -> (region features
        [B, 17, 17, nef] NHWC, cnn_code [B, nef]), with no autograd graph
        (RP-CUB's route)."""
        return self.encode(x)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``forward`` under autograd: the trainer's DAMSM loss pulls its
        gradient back to ``x`` through it (the caller freezes the parameters
        with ``requires_grad_(False)``; the BatchNorms are always in eval
        mode).  The resize runs in the input's dtype and the trunk in the
        encoder's: a ``bf16_copy`` takes f32 images and gives bf16 outputs."""
        return self._heads(self._trunk(x))

    def encode_heads(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``forward`` with the frozen trunk under ``torch.no_grad()`` and the
        two heads under autograd (DAMSM pretraining's route, which trains
        ``emb_features`` and ``emb_cnn_code`` only): no graph of the trunk
        is kept, and no gradient reaches ``x``."""
        with torch.no_grad():
            out = self._trunk(x)
        return self._heads(out)

    def _trunk(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = resize_bilinear_align_corners(x, (IMAGE_SIZE, IMAGE_SIZE)).to(self.emb_cnn_code.weight.dtype)
        return self.trunk.features(x, endpoints=("mixed6e", "pool3"))

    def _heads(self, out: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        features = self.emb_features(out["mixed6e"].permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return features, self.emb_cnn_code(out["pool3"])

    def bf16_copy(self) -> "CNNEncoder":
        """A copy whose convolutions and linear layer hold bf16 weights, the
        BatchNorms' statistics kept in f32 (the JAX package's
        ``CNNEncoder(dtype=bfloat16)``), frozen."""
        out = copy.deepcopy(self)
        for m in out.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.to(torch.bfloat16)
        return out.requires_grad_(False)


# ---------------------------------------------------------------------------
# Weights: the JAX package's params, the reference checkpoints, seeded random
# ---------------------------------------------------------------------------


def rnn_state_dict_from_jax_params(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX RNNEncoder params (numpy leaves) -> reference-layout state dict;
    the inverse of ``tise_tpu.backbones.damsm.rnn_params_from_torch``."""
    tree = params.get("params", params)
    out = {"encoder.weight": np.asarray(tree["embedding"])}
    for jax_dir, suffix in _DIRECTIONS:
        for jax_name, torch_name in _LSTM_PARTS:
            out[f"rnn.{torch_name}_l0{suffix}"] = np.asarray(tree["bilstm"][f"{jax_name}_{jax_dir}"])
    return out


def cnn_state_dict_from_jax_params(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX CNNEncoder params (numpy leaves) -> reference-layout state dict;
    the inverse of ``tise_tpu.backbones.damsm.cnn_params_from_torch``: the
    trunk through ``state_dict_from_jax_params``, the 1x1 kernel HWIO -> OIHW,
    the dense kernel [in, out] -> [out, in]."""
    tree = params.get("params", params)
    out = state_dict_from_jax_params(tree["trunk"])
    out["emb_features.weight"] = np.ascontiguousarray(np.transpose(np.asarray(tree["emb_features"]["kernel"]),
                                                                   (3, 2, 0, 1)))
    out["emb_cnn_code.weight"] = np.ascontiguousarray(np.asarray(tree["emb_cnn_code"]["kernel"]).T)
    out["emb_cnn_code.bias"] = np.asarray(tree["emb_cnn_code"]["bias"])
    return out


def jax_params_from_rnn_state_dict(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of ``rnn_state_dict_from_jax_params``: a reference-layout
    state dict -> the JAX ``RNNEncoder``'s ``{"params": ...}`` tree (numpy
    leaves), as ``tise_tpu.backbones.damsm.rnn_params_from_torch`` gives it."""
    bilstm = {f"{jax_name}_{jax_dir}": np.asarray(state[f"rnn.{torch_name}_l0{suffix}"])
              for jax_dir, suffix in _DIRECTIONS for jax_name, torch_name in _LSTM_PARTS}
    return {"params": {"embedding": np.asarray(state["encoder.weight"]), "bilstm": bilstm}}


def jax_params_from_cnn_state_dict(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of ``cnn_state_dict_from_jax_params``: a reference-layout
    state dict -> the JAX ``CNNEncoder``'s ``{"params": ...}`` tree (numpy
    leaves), as ``tise_tpu.backbones.damsm.cnn_params_from_torch`` gives it."""
    trunk = jax_params_from_state_dict({k: v for k, v in state.items() if not k.startswith("emb_")})
    return {"params": {
        "trunk": trunk,
        "emb_features": {"kernel": np.ascontiguousarray(np.transpose(np.asarray(state["emb_features.weight"]),
                                                                     (2, 3, 1, 0)))},
        "emb_cnn_code": {"kernel": np.ascontiguousarray(np.asarray(state["emb_cnn_code.weight"]).T),
                         "bias": np.asarray(state["emb_cnn_code.bias"])}}}


def load_rnn_state_dict(path: str) -> Dict[str, np.ndarray]:
    """``text_encoder*.pth`` (reference layout) or a JAX-package ``.npz`` pytree."""
    if path.endswith(".npz"):
        return rnn_state_dict_from_jax_params(load_pytree_npz(path))
    return load_torch_state_dict(path)


def load_cnn_state_dict(path: str) -> Dict[str, np.ndarray]:
    """``image_encoder*.pth`` (reference layout) or a JAX-package ``.npz`` pytree."""
    if path.endswith(".npz"):
        return cnn_state_dict_from_jax_params(load_pytree_npz(path))
    return load_torch_state_dict(path)


def random_rnn_state_dict(seed: int, ntoken: int, ninput: int = 300, nhidden: int = 128) -> Dict[str, np.ndarray]:
    """Seeded reference-layout text encoder weights made with numpy: the
    reference's init (embedding U(-0.1, 0.1)) and the
    library's LSTM init U(-1/sqrt(H), 1/sqrt(H))."""
    rng = np.random.RandomState(seed)
    r = 1.0 / np.sqrt(nhidden)
    out = {"encoder.weight": rng.uniform(-0.1, 0.1, (ntoken, ninput))}
    shapes = {"weight_ih": (4 * nhidden, ninput), "weight_hh": (4 * nhidden, nhidden),
              "bias_ih": (4 * nhidden,), "bias_hh": (4 * nhidden,)}
    for _, suffix in _DIRECTIONS:
        for _, name in _LSTM_PARTS:
            out[f"rnn.{name}_l0{suffix}"] = rng.uniform(-r, r, shapes[name])
    return {k: v.astype(np.float32) for k, v in out.items()}


def random_cnn_state_dict(seed: int, nef: int = 256) -> Dict[str, np.ndarray]:
    """Seeded reference-layout image encoder weights: the well-conditioned
    trunk of ``inception_v3.random_state_dict`` without its fc, and the heads
    under the reference's init (weights U(-0.1, 0.1); the
    library's bias init U(-1/sqrt(2048), 1/sqrt(2048)))."""
    out = {k: v for k, v in inception_v3.random_state_dict(seed).items() if not k.startswith("fc.")}
    rng = np.random.RandomState(seed + 1)
    out["emb_features.weight"] = rng.uniform(-0.1, 0.1, (nef, 768, 1, 1)).astype(np.float32)
    out["emb_cnn_code.weight"] = rng.uniform(-0.1, 0.1, (nef, 2048)).astype(np.float32)
    out["emb_cnn_code.bias"] = rng.uniform(-1, 1, (nef,)).astype(np.float32) / np.float32(np.sqrt(2048))
    return out
