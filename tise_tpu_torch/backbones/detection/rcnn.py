"""Faster R-CNN heads (RPN + box head), batched, detectron2 parity (mirrors
tise_tpu/backbones/detection/rcnn.py).

The reference's detector is detectron2's mask_rcnn_R_50_FPN_3x; every
consumer uses only ``pred_classes`` and ``pred_boxes`` (crop_object.py:32-33,
SOA.py:89-90), so the mask branch is left out, as in the JAX package.

The JAX package runs one image and ``vmap``s it; here every stage carries a
leading batch axis: the trunk, FPN and RPN on [B, ...], per-level top-k,
one NMS over all levels of all images, the global top-k, ROIAlign, the box
head and the postprocess.  No Python loop runs over images.  The static
shapes are the JAX package's:

  * RPN: per-level top-k (1000) pre-NMS candidates, NMS 0.7 as a mask,
    post-NMS top ``post_nms_topk`` proposals across levels with a validity
    mask;
  * ROI heads: ROIAlign on the level each proposal is assigned to;
    class-wise box decode; score threshold 0.5
    (cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST, crop_object.py:20); per-class
    NMS 0.5 as one NMS with the class-offset trick; top 100 detections with
    a validity mask.

Scores and boxes are f32 whatever the model's dtype.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tise_tpu_torch.backbones.detection import ops
from tise_tpu_torch.backbones.detection.resnet_fpn import FPN, ResNet50

STRIDES = (4, 8, 16, 32, 64)
ANCHOR_SIZES = (32, 64, 128, 256, 512)
NUM_ANCHORS = 3  # aspect ratios 0.5/1/2, one size per level
PRE_NMS_TOPK = 1000  # test-time, per level
POST_NMS_TOPK = 1000
RPN_NMS_THRESH = 0.7
DETECTIONS_PER_IMAGE = 100
NMS_THRESH = 0.5
NUM_CLASSES = 80
#: Box2BoxTransform weights for the box head (detectron2 default 10, 10, 5, 5)
BOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
ROI_SIZE = 7


class RPNHead(nn.Module):
    """Shared 3x3 conv -> objectness + anchor deltas, applied per level."""

    def __init__(self, channels: int = 256):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.objectness = nn.Conv2d(channels, NUM_ANCHORS, 1)
        self.anchor_deltas = nn.Conv2d(channels, NUM_ANCHORS * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        logits, deltas = [], []
        for f in feats:
            t = F.relu(self.conv(f))
            logits.append(self.objectness(t))
            deltas.append(self.anchor_deltas(t))
        return logits, deltas


class BoxHead(nn.Module):
    """2-fc head + predictors (FastRCNNConvFCHead + FastRCNNOutputLayers).
    ``fc1`` reads the [7, 7, C] ROI features flattened in HWC order, as the
    JAX package's Dense does (the detectron2 loader permutes its CHW rows)."""

    def __init__(self, channels: int = 256):
        super().__init__()
        self.fc1 = nn.Linear(ROI_SIZE * ROI_SIZE * channels, 1024)
        self.fc2 = nn.Linear(1024, 1024)
        self.cls_score = nn.Linear(1024, NUM_CLASSES + 1)
        self.bbox_pred = nn.Linear(1024, NUM_CLASSES * 4)

    def forward(self, roi_feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = roi_feats.flatten(-3)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.cls_score(x), self.bbox_pred(x)


class Detections(NamedTuple):
    boxes: torch.Tensor  # [B, D, 4] xyxy in input-image coordinates
    scores: torch.Tensor  # [B, D]
    classes: torch.Tensor  # [B, D] int64, contiguous 0..79
    valid: torch.Tensor  # [B, D] bool


def postprocess_detections(
    proposals: torch.Tensor,
    prop_valid: torch.Tensor,
    cls_logits: torch.Tensor,
    box_deltas: torch.Tensor,
    h: int,
    w: int,
    score_thresh: float = 0.5,
    clip_hw: Optional[torch.Tensor] = None,
    rounds: Optional[List[int]] = None,
) -> Detections:
    """detectron2 ``fast_rcnn_inference_single_image`` on a batch, static
    shapes: softmax minus background -> per-class box decode and clip ->
    score threshold -> per-class NMS 0.5 as one NMS with the boxes offset by
    class -> top ``DETECTIONS_PER_IMAGE`` with a validity mask.

    proposals [B, K, 4], prop_valid [B, K], cls_logits [B, K, 81],
    box_deltas [B, K, 320]; ``clip_hw`` [B, 2] is each image's true extent
    (default: h x w)."""
    bsz, k = proposals.shape[:2]
    probs = torch.softmax(cls_logits.float(), dim=-1)[..., :NUM_CLASSES]  # drop background
    weights = torch.tensor(BOX_REG_WEIGHTS, device=proposals.device)
    d = box_deltas.float().reshape(bsz, k, NUM_CLASSES, 4) / weights
    cls_boxes = ops.apply_deltas(proposals[:, :, None, :], d)
    if clip_hw is None:
        cls_boxes = ops.clip_boxes(cls_boxes, h, w)  # [B, K, C, 4]
    else:
        cls_boxes = ops.clip_boxes(cls_boxes, clip_hw[:, 0, None, None], clip_hw[:, 1, None, None])

    # flatten (proposal, class) pairs; boxes offset by class so that overlaps
    # across classes never suppress
    flat_scores = torch.where(prop_valid[..., None], probs, 0.0).reshape(bsz, -1)
    flat_boxes = cls_boxes.reshape(bsz, -1, 4)
    flat_cls = torch.arange(NUM_CLASSES, device=proposals.device).repeat(k)
    masked = torch.where(flat_scores > score_thresh, flat_scores, -torch.inf)
    sel_scores, sel = ops.topk_sorted(masked, min(4 * DETECTIONS_PER_IMAGE, masked.shape[-1]))
    sel_boxes = ops.gather_rows(flat_boxes, sel)
    sel_cls = flat_cls[sel]
    offset = sel_cls.float()[..., None] * (max(h, w) + 1.0)
    keep = ops.nms_mask(sel_boxes + offset, sel_scores, NMS_THRESH, rounds=rounds)
    final = torch.where(keep, sel_scores, -torch.inf)
    out_scores, order = ops.topk_sorted(final, DETECTIONS_PER_IMAGE)
    valid = torch.isfinite(out_scores)
    return Detections(
        boxes=ops.gather_rows(sel_boxes, order),
        scores=torch.where(valid, out_scores, 0.0),
        classes=torch.gather(sel_cls, 1, order),
        valid=valid,
    )


class FasterRCNN(nn.Module):
    """Backbone + RPN + ROI box head on a batch of images.

    The model runs in its parameters' dtype: ``.to(torch.bfloat16)`` is the
    fast path (bf16 convolutions and matmuls, the frozen-BN affine in bf16)
    with every score and box computation in f32, as ``dtype=jnp.bfloat16``
    in the JAX package.  ``score_thresh`` is detectron2's
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST (0.5, crop_object.py:20).
    ``roi_sampling``: ROIAlign samples per bin per axis (2 approximates
    detectron2's adaptive grid over the canonical box sizes; 1 samples each
    bin at its centre, the opt-in sweep setting).  ``post_nms_topk``:
    proposals kept after the RPN's NMS (detectron2's FPN default 1000; 256 is
    the other sweep setting).

    ``forward`` chains the four stages :meth:`features`, :meth:`proposals`,
    :meth:`box_features` and :meth:`detect`, each of which a caller may time.
    """

    def __init__(self, score_thresh: float = 0.5, roi_sampling: int = 2, post_nms_topk: int = POST_NMS_TOPK):
        super().__init__()
        self.score_thresh = score_thresh
        self.roi_sampling = roi_sampling
        self.post_nms_topk = post_nms_topk
        self.backbone = ResNet50()
        self.fpn = FPN()
        self.rpn = RPNHead()
        self.box_head = BoxHead()

    def features(self, images: torch.Tensor) -> List[torch.Tensor]:
        """images [B, 3, H, W] (BGR, mean-subtracted) -> [P2, ..., P6]."""
        return self.fpn(self.backbone(images))

    def proposals(
        self,
        feats: List[torch.Tensor],
        image_hw: Tuple[int, int],
        valid_hw: Optional[torch.Tensor] = None,
        rounds: Optional[List[int]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-level top-k -> decode, clip, drop empty boxes -> NMS 0.7 ->
        the top ``post_nms_topk`` over all levels: (proposals [B, K, 4] f32,
        valid [B, K]).  The levels' candidates are padded to one width and
        take one NMS (padding rows are empty boxes of score -inf)."""
        logits, deltas = self.rpn(feats)
        bsz, dev = feats[0].shape[0], feats[0].device
        vh, vw = image_hw if valid_hw is None else (valid_hw[:, 0:1], valid_hw[:, 1:2])
        ks = [min(PRE_NMS_TOPK, lg[0].numel()) for lg in logits]
        width = max(ks)
        boxes = torch.zeros(bsz, len(ks), width, 4, device=dev)
        scores = torch.full((bsz, len(ks), width), -torch.inf, device=dev)
        for lvl, (lg, dl) in enumerate(zip(logits, deltas)):
            fh, fw = lg.shape[-2:]
            anchors = torch.from_numpy(ops.generate_anchors(fh, fw, STRIDES[lvl], ANCHOR_SIZES[lvl])).to(dev)
            s = lg.permute(0, 2, 3, 1).reshape(bsz, -1).float()  # (h, w, a) order
            dlt = dl.permute(0, 2, 3, 1).reshape(bsz, -1, 4).float()
            top, idx = ops.topk_sorted(s, ks[lvl])
            b = ops.clip_boxes(ops.apply_deltas(anchors[idx], ops.gather_rows(dlt, idx)), vh, vw)
            nonempty = (b[..., 2] > b[..., 0]) & (b[..., 3] > b[..., 1])  # detectron2 drops empty proposals
            boxes[:, lvl, : ks[lvl]] = b
            scores[:, lvl, : ks[lvl]] = torch.where(nonempty, top, -torch.inf)
        keep = ops.nms_mask(boxes.flatten(0, 1), scores.flatten(0, 1), RPN_NMS_THRESH, rounds=rounds)
        scores = torch.where(keep.view(scores.shape), scores, -torch.inf)
        # the levels' rows one after another, without the padding: the order
        # the JAX package concatenates them in, which ties of -inf follow
        cat = torch.from_numpy(np.concatenate([lvl * width + np.arange(k) for lvl, k in enumerate(ks)])).to(dev)
        boxes, scores = boxes.view(bsz, -1, 4)[:, cat], scores.view(bsz, -1)[:, cat]
        prop_scores, idx = ops.topk_sorted(scores, min(self.post_nms_topk, scores.shape[-1]))
        return ops.gather_rows(boxes, idx), torch.isfinite(prop_scores)

    def box_features(self, feats: List[torch.Tensor], proposals: torch.Tensor) -> torch.Tensor:
        """ROIAlign of each proposal on its FPN level -> [B, K, 7, 7, C]."""
        levels = ops.assign_fpn_level(proposals)
        nhwc = [f.permute(0, 2, 3, 1) for f in feats[:4]]
        return ops.roi_align_multilevel(nhwc, proposals, levels, STRIDES[:4], ROI_SIZE, self.roi_sampling)

    def detect(
        self,
        roi: torch.Tensor,
        proposals: torch.Tensor,
        prop_valid: torch.Tensor,
        image_hw: Tuple[int, int],
        valid_hw: Optional[torch.Tensor] = None,
        rounds: Optional[List[int]] = None,
    ) -> Detections:
        """Box head, then the per-class decode, threshold and NMS."""
        cls_logits, box_deltas = self.box_head(roi)
        return postprocess_detections(proposals, prop_valid, cls_logits, box_deltas, image_hw[0], image_hw[1],
                                      self.score_thresh, valid_hw, rounds)

    def forward(
        self, images: torch.Tensor, valid_hw: Optional[torch.Tensor] = None, rounds: Optional[List[int]] = None
    ) -> Detections:
        """images [B, 3, H, W] normalized (BGR, mean-subtracted) in the
        model's dtype.  ``valid_hw`` [B, 2] f32: each image's true
        (pre-padding) extent, to which proposals and boxes are clipped, as
        detectron2 clips to ImageList.image_sizes; pass it when images carry
        the zero padding of the bucketed resize.  ``rounds`` collects the NMS
        rounds (ops.nms_mask)."""
        image_hw = tuple(images.shape[-2:])
        feats = self.features(images)
        proposals, prop_valid = self.proposals(feats, image_hw, valid_hw, rounds)
        roi = self.box_features(feats, proposals)
        return self.detect(roi, proposals, prop_valid, image_hw, valid_hw, rounds)
