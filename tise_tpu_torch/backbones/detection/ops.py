"""Detection ops on tensors: anchors, box transforms, IoU, NMS, ROIAlign
(mirrors tise_tpu/backbones/detection/ops.py).

The JAX package fixes every dynamically sized quantity of detectron2
(proposal counts, per-class survivors) to a static size with validity
masks; the port keeps those shapes and semantics, so both packages select
the same boxes, and adds a leading batch axis to every op: one call serves
every image of a batch.  Invalid rows carry a score of -inf.

Two points where PyTorch differs from XLA and the port restores XLA's
behaviour:

* ``jax.lax.top_k`` puts the lower index first among equal values;
  ``torch.topk`` on the card promises no order.  Greedy NMS and the choice
  of the surviving detections depend on that order, and ties do occur (rows
  of -inf, saturated softmax scores, bf16 logits), so :func:`topk_sorted`
  takes a stable descending sort.
* NMS is a fixpoint iteration whose stopping test needs the device's
  answer on the host.  The fixpoint is stable once reached, so
  :func:`nms_mask` tests every ``check_every`` rounds: the mask is the same
  and the host waits less often.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

#: rounds of the NMS fixpoint between two reads of its stopping test
NMS_CHECK_EVERY = 4


def generate_anchors(
    feat_h: int, feat_w: int, stride: int, size: float, aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0)
) -> np.ndarray:
    """[H*W*A, 4] xyxy anchors, detectron2 DefaultAnchorGenerator semantics:
    centered at (stride*i), area size^2, aspect h/w (numpy, bit-equal to the
    JAX package's)."""
    anchors = []
    for ar in aspect_ratios:
        w = size / np.sqrt(ar)
        h = size * np.sqrt(ar)
        anchors.append([-w / 2, -h / 2, w / 2, h / 2])
    base = np.asarray(anchors, np.float32)  # [A, 4]
    ys = (np.arange(feat_h, dtype=np.float32)) * stride
    xs = (np.arange(feat_w, dtype=np.float32)) * stride
    shift_x, shift_y = np.meshgrid(xs, ys)
    shifts = np.stack([shift_x, shift_y, shift_x, shift_y], axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def apply_deltas(boxes: torch.Tensor, deltas: torch.Tensor, clip: float = math.log(1000.0 / 16)) -> torch.Tensor:
    """Box regression transform (dx, dy, dw, dh) -> xyxy (detectron2
    Box2BoxTransform; the caller divides by the weights)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    dx, dy = deltas[..., 0], deltas[..., 1]
    dw = torch.clamp(deltas[..., 2], max=clip)
    dh = torch.clamp(deltas[..., 3], max=clip)
    ncx = dx * w + cx
    ncy = dy * h + cy
    nw = torch.exp(dw) * w
    nh = torch.exp(dh) * h
    return torch.stack([ncx - 0.5 * nw, ncy - 0.5 * nh, ncx + 0.5 * nw, ncy + 0.5 * nh], dim=-1)


def _clip(v: torch.Tensor, hi) -> torch.Tensor:
    v = torch.clamp(v, min=0)
    return torch.minimum(v, hi) if torch.is_tensor(hi) else torch.clamp(v, max=hi)


def clip_boxes(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clip xyxy boxes to [0, width] x [0, height]; ``height`` and ``width``
    are numbers or tensors that broadcast against ``boxes[..., 0]`` (one
    extent per image)."""
    return torch.stack([_clip(boxes[..., 0], width), _clip(boxes[..., 1], height),
                        _clip(boxes[..., 2], width), _clip(boxes[..., 3], height)], dim=-1)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] x [..., M, 4] -> [..., N, M] IoU."""
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) * torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) * torch.clamp(b[..., 3] - b[..., 1], min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    check_every: int = NMS_CHECK_EVERY,
    rounds: Optional[List[int]] = None,
) -> torch.Tensor:
    """Greedy NMS over rows sorted by score, descending -> bool keep mask.

    boxes [..., K, 4], scores [..., K]; every leading index is one
    independent set, and one loop serves them all.  ``keep`` is the unique
    solution of ``keep[j] = not any(i < j and keep[i] and iou[i, j] > t)``.
    Iterating the recursion from all-true makes every entry whose
    suppression chain has depth <= t right after t rounds, so the fixpoint is
    the sequential greedy result and is reached within K rounds.  Rows of
    -inf sort last and a zero-area box overlaps nothing, so padding rows
    change no earlier entry (``scores`` is not read otherwise).

    The JAX loop tests for a change after every round; this one runs
    ``check_every`` rounds between two reads of that test (one wait for the
    device each), and appends to ``rounds`` how many rounds the JAX loop
    runs: up to and including the first that changes nothing."""
    k = boxes.shape[-2]
    upper = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    over = (box_iou(boxes, boxes) > iou_threshold) & upper  # i suppresses j only if i ranks higher
    keep = torch.ones(boxes.shape[:-1], dtype=torch.bool, device=boxes.device)
    changed: List[torch.Tensor] = []
    while True:
        for _ in range(check_every):
            new = ~torch.any(over & keep.unsqueeze(-1), dim=-2)
            changed.append(torch.any(new != keep))
            keep = new
        flags = torch.stack(changed).tolist()
        if not flags[-1] or len(flags) >= k:
            break
    if rounds is not None:
        rounds.append(next((i + 1 for i, f in enumerate(flags) if not f), k))
    return keep


def topk_sorted(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top-k scores descending, indices) along the last axis, ties in index
    order as ``jax.lax.top_k`` gives them."""
    values, index = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...], index [B, K] -> x[b, index[b]] as [B, K, ...]."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, index]


def roi_align_multilevel(
    feats: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    levels: torch.Tensor,
    strides: Sequence[int] = (4, 8, 16, 32),
    out_size: int = 7,
    sampling: int = 2,
) -> torch.Tensor:
    """ROIAlign (aligned=True, a fixed ``sampling`` x ``sampling`` grid per
    bin) across FPN levels with one gather.

    feats: [B, H_l, W_l, C] maps (P2..P5, channels last); boxes [B, N, 4]
    xyxy in image coordinates; levels [B, N] in [2, 5]
    (:func:`assign_fpn_level`) -> [B, N, out, out, C] in the features' dtype.

    As in the JAX package: the four bilinear corners of every cell are packed
    channel-wise into one [rows, 4C] buffer (clamped x/y/xy shifts, which is
    the corner clamp), all levels of an image one after another and the
    images after each other; one gather takes N * out^2 * sampling^2 rows,
    ordered bin-major ([n, by, bx, sy, sx]) so each bin's samples lie next to
    each other; coordinates and weights are f32, the weighted corner sum runs
    in the features' dtype, and the bin mean in f32.
    """
    bsz, c = feats[0].shape[0], feats[0].shape[-1]
    dev = boxes.device
    hs = np.asarray([f.shape[1] for f in feats], np.int64)
    ws = np.asarray([f.shape[2] for f in feats], np.int64)
    offs = np.concatenate([[0], np.cumsum(hs * ws)])
    rows = int(offs[-1])

    def pack_corners(f: torch.Tensor) -> torch.Tensor:
        # [B, H, W, C] -> [B, H*W, 4C]: row (y, x) = (f[y,x], f[y,x+1], f[y+1,x], f[y+1,x+1]), edges clamped
        fx = torch.cat([f[:, :, 1:], f[:, :, -1:]], dim=2)
        fy = torch.cat([f[:, 1:], f[:, -1:]], dim=1)
        fxy = torch.cat([fy[:, :, 1:], fy[:, :, -1:]], dim=2)
        return torch.cat([f, fx, fy, fxy], dim=-1).reshape(bsz, -1, 4 * c)

    flat = torch.cat([pack_corners(f) for f in feats], dim=1).reshape(bsz * rows, 4 * c)
    li = torch.clamp(levels - 2, 0, len(feats) - 1)
    inv_stride = torch.from_numpy(1.0 / np.asarray(strides, np.float32)).to(dev)[li]  # [B, N]
    h_n = torch.from_numpy(hs).to(dev)[li]
    w_n = torch.from_numpy(ws).to(dev)[li]
    off_n = torch.from_numpy(offs[:-1]).to(dev)[li] + torch.arange(bsz, device=dev)[:, None] * rows

    b32 = boxes.float()
    x1 = b32[..., 0] * inv_stride - 0.5
    y1 = b32[..., 1] * inv_stride - 0.5
    x2 = b32[..., 2] * inv_stride - 0.5
    y2 = b32[..., 3] * inv_stride - 0.5
    bw = torch.clamp(x2 - x1, min=1e-6)
    bh = torch.clamp(y2 - y1, min=1e-6)
    s = out_size * sampling
    grid = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / sampling  # in bin units
    ys = y1[..., None] + bh[..., None] * grid / out_size  # [B, N, S]
    xs = x1[..., None] + bw[..., None] * grid / out_size

    def bilinear(coords, size):
        hi = (size - 1).float()[..., None]
        c0 = torch.minimum(torch.clamp(torch.floor(coords), min=0.0), hi)
        frac = torch.clamp(coords - c0, 0.0, 1.0)
        return c0.long(), frac

    y0, fy = bilinear(ys, h_n)
    x0, fx = bilinear(xs, w_n)

    n = boxes.shape[1]
    o, sp = out_size, sampling
    # bin-major index [b, n, by, bx, sy, sx] (see docstring)
    iy = y0.reshape(bsz, n, o, 1, sp, 1)
    ix = x0.reshape(bsz, n, 1, o, 1, sp)
    idx = off_n[..., None, None, None, None] + iy * w_n[..., None, None, None, None] + ix
    wd = flat.dtype
    fy = fy.reshape(bsz, n, o, 1, sp, 1)
    fx = fx.reshape(bsz, n, 1, o, 1, sp)
    wy0, wy1 = (1 - fy), fy
    wx0, wx1 = (1 - fx), fx
    v = flat[idx.reshape(bsz, n, o * o, sp * sp)]  # [B, N, 49, sp^2, 4C]: all four corners
    w = torch.stack([wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1], dim=-1)  # [B, N, o, o, sp, sp, 4]
    w = w.reshape(bsz, n, o * o, sp * sp, 4).to(wd)
    vals = v[..., :c] * w[..., 0:1]  # [B, N, 49, sp^2, C]: the corners summed in order, in place
    for k in range(1, 4):
        vals += v[..., k * c: (k + 1) * c] * w[..., k: k + 1]
    vals = torch.mean(vals.float(), dim=3)  # the bin mean over adjacent rows
    return vals.reshape(bsz, n, o, o, c).to(wd)


def assign_fpn_level(boxes: torch.Tensor, k_min: int = 2, k_max: int = 5, canonical: float = 224.0) -> torch.Tensor:
    """FPN level per box: floor(4 + log2(sqrt(area)/224)), clamped
    (detectron2 assign_boxes_to_levels)."""
    area = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0)
    lvl = torch.floor(4 + torch.log2(torch.sqrt(area) / canonical + 1e-8))
    return torch.clamp(lvl, k_min, k_max).long()
