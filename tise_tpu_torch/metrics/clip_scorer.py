"""Batched CLIP image-vs-caption-set scorer shared by RP-COCO and PA (mirrors
tise_tpu/metrics/clip_scorer.py).

The reference scores one image against its caption set per forward
(RP_coco.py:60-76: 1 image x 100 texts; PA.py:33-43: 1 image x 2 texts).
Here a block of items runs per step: uint8 images [B, 224, 224, 3] and
per-item token sets [B, K, 77] give the [B, K] logit matrix, the per-item
diagonal of the image/text similarity that ``model(image, text)`` yields
item by item.  Kernel K1 normalizes every image batch under the ``clip``
recipe.  The dedup path encodes each unique caption once into a bank on the
device and gathers each item's rows from it.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np
import torch

from tise_tpu_torch.backbones.clip_vit import CLIP
from tise_tpu_torch.core.config import resolve_device, tf32_forward
from tise_tpu_torch.ops.preprocess import normalize


class ClipPairScorer:
    """(uint8 images, token sets) -> per-item caption logits on one device."""

    def __init__(self, state_dict: Mapping[str, Any], device=None, fast: bool = False):
        """``state_dict``: OpenAI-layout CLIP weights (clip_vit.load_params).
        ``fast=True`` routes the image tower through the bf16 FastCLIPVisual
        (backbones/clip_fast.py); the text tower stays the f32 module and
        runs with TF32 allowed (``tf32_forward``), the card's counterpart of
        the JAX package's reduced-pass f32 matmuls under ``fast``."""
        self.device = resolve_device(device)
        self.model = CLIP.from_state_dict(state_dict, self.device)
        self.fast = fast
        self.fast_visual = None
        if fast:
            from tise_tpu_torch.backbones.clip_fast import FastCLIPVisual

            self.fast_visual = FastCLIPVisual(state_dict, torch.bfloat16, device=self.device)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return x.pin_memory().to(self.device, non_blocking=True)
        return x.to(self.device)

    def encode_images(self, images_u8: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC on the device -> [B, D] unit-norm f32 image embeddings."""
        if self.fast_visual is not None:
            img = self.fast_visual(normalize(images_u8, "clip", torch.bfloat16)).float()
        else:
            img = self.model.encode_image(normalize(images_u8, "clip", torch.float32))
        return img / img.norm(dim=-1, keepdim=True)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        """int [N, 77] on the device -> [N, D] unit-norm f32 text embeddings."""
        with tf32_forward(self.fast):
            txt = self.model.encode_text(tokens)
        return txt / txt.norm(dim=-1, keepdim=True)

    def _scale(self) -> torch.Tensor:
        return self.model.logit_scale.float().exp()

    def logits(self, images_u8: np.ndarray, tokens: np.ndarray) -> np.ndarray:
        """[B, 224, 224, 3] uint8 + [B, K, 77] int -> [B, K] float32.  Text
        activations scale with B*K rows; ``logits_from_bank`` removes the K
        axis."""
        b, k, t = tokens.shape
        with torch.inference_mode():
            img = self.encode_images(self._upload(images_u8))
            txt = self.encode_text(self._upload(tokens.astype(np.int64)).view(b * k, t)).view(b, k, -1)
            out = self._scale() * torch.einsum("bd,bkd->bk", img, txt)
        return out.cpu().numpy()

    def encode_text_bank(self, tokens: np.ndarray, *, batch_size: int = 1024) -> torch.Tensor:
        """[N, 77] int -> [N, D] unit-norm f32 embeddings ON THE DEVICE, in
        chunks of ``batch_size`` captions.

        The text half of the dedup rank path (``logits_from_bank``): each
        UNIQUE caption is encoded once instead of once per (item, caption
        slot); the reference re-runs the text tower on the same captions for
        every item (RP_coco.py:70-73)."""
        d = self.model.text_projection.shape[-1]
        if len(tokens) == 0:
            return torch.zeros((0, d), device=self.device)
        with torch.inference_mode():
            return torch.cat([self.encode_text(self._upload(tokens[s:s + batch_size].astype(np.int64)))
                              for s in range(0, len(tokens), batch_size)])

    def dispatch_from_bank(self, images_u8: np.ndarray, bank: torch.Tensor, idx: np.ndarray):
        """Non-blocking half of ``logits_from_bank``: upload, queue the
        forward and a copy of the logits into pinned host memory, and return
        (host tensor, event, row count) without synchronising, so the host
        decodes the next batch while the device computes this one."""
        with torch.inference_mode():
            img = self.encode_images(self._upload(images_u8))
            txt = bank[self._upload(idx.astype(np.int64))]  # [B, K, D]
            out = self._scale() * torch.einsum("bd,bkd->bk", img, txt)
            if self.device.type != "cuda":
                return out, None, len(images_u8)
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return host, done, len(images_u8)

    @staticmethod
    def pull_logits(inflight: Tuple[torch.Tensor, Any, int]) -> np.ndarray:
        """Blocking half: wait for the copy, -> [B, K] numpy."""
        host, done, b = inflight
        if done is not None:
            done.synchronize()
        return host.numpy()[:b]

    def logits_from_bank(self, images_u8: np.ndarray, bank: torch.Tensor, idx: np.ndarray) -> np.ndarray:
        """[B, 224, 224, 3] uint8 + [N, D] bank + [B, K] int rows -> [B, K]
        logits: ``logits(images, tokens[idx])`` with the text tower hoisted
        out (the per-item logit is scale * <img, txt> either way)."""
        return self.pull_logits(self.dispatch_from_bank(images_u8, bank, idx))
