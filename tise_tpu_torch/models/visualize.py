"""Attention-map visualisation grids (the port's own copy of
tise_tpu/models/visualize.py, which is host numpy and PIL only; reference:
miscc/utils.py:145-363 ``build_super_images``/``build_super_images2``).

Renders, per sample, the generated image followed by per-word overlays of
the spatial attention (word -> pixel softmax); ``gen_example`` writes one
grid a caption.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
from PIL import Image, ImageDraw

#: attention overlay colormap anchors (blue -> red)
_COLD = np.array([60, 80, 200], np.float32)
_HOT = np.array([230, 60, 40], np.float32)


def _to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float NHWC -> uint8."""
    return np.clip((img + 1.0) * 127.5, 0, 255).astype(np.uint8)


def _attn_overlay(image_u8: np.ndarray, attn: np.ndarray) -> np.ndarray:
    """Blend one word's attention map over the image (nearest-upsampled)."""
    h, w = image_u8.shape[:2]
    ah, aw = attn.shape
    a = attn - attn.min()
    if a.max() > 0:
        a = a / a.max()
    a = np.kron(a, np.ones((h // ah, w // aw), np.float32))[:h, :w]
    heat = _COLD[None, None] * (1 - a[..., None]) + _HOT[None, None] * a[..., None]
    return np.clip(0.55 * image_u8 + 0.45 * heat, 0, 255).astype(np.uint8)


def build_super_image(
    images: np.ndarray,
    attn_maps: np.ndarray,
    captions: np.ndarray,
    cap_lens: np.ndarray,
    ixtoword: Dict[int, str],
    *,
    max_words: int = 8,
    label_height: int = 14,
) -> Image.Image:
    """One grid image: rows = samples, columns = [generated | word overlays].

    images     [B, H, W, 3] in [-1, 1]
    attn_maps  [B, T, ah, aw] (losses.words_loss diagonal or the generator's
               SpatialAttention maps transposed to word-major)
    """
    b, h, w, _ = images.shape
    cols = 1 + max_words
    canvas = Image.new("RGB", (cols * w, b * (h + label_height)), (255, 255, 255))
    draw = ImageDraw.Draw(canvas)
    for i in range(b):
        base = _to_uint8(images[i])
        y = i * (h + label_height)
        canvas.paste(Image.fromarray(base), (0, y + label_height))
        n_words = int(min(cap_lens[i], max_words))
        for t in range(n_words):
            over = _attn_overlay(base, np.asarray(attn_maps[i, t], np.float32))
            x = (1 + t) * w
            canvas.paste(Image.fromarray(over), (x, y + label_height))
            word = ixtoword.get(int(captions[i, t]), "?")
            draw.text((x + 2, y + 1), word[:12], fill=(0, 0, 0))
    return canvas


def save_img_results(
    path: str,
    images: np.ndarray,
    attn_maps: np.ndarray,
    captions: np.ndarray,
    cap_lens: np.ndarray,
    ixtoword: Dict[int, str],
) -> None:
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    build_super_image(images, attn_maps, captions, cap_lens, ixtoword).save(path)
