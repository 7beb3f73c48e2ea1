"""Folder-level detection engine, the reference's DefaultPredictor surface
(mirrors tise_tpu/backbones/detection/predictor.py).

Preprocessing as detectron2's DefaultPredictor on the reference configs:
BGR input (cv2.imread, SOA.py:86 / crop_object.py:30), resized to 800, the
pixel mean [103.53, 116.28, 123.675] subtracted (std 1 for the caffe-style
R50).  Two modes:

  * default: every image resized to exactly 800 x 800 (TISE's generated
    images are square, so the aspect ratio is kept);
  * ``aspect_buckets``: detectron2's ResizeShortestEdge(800, max 1333) with
    zero padding into one of a few (h, w) buckets and the true extent passed
    to the model for box clipping, as detectron2's ImageList.image_sizes.

Boxes are rescaled to the original image's coordinates.  The sweep loop is
pipelined as in the JAX package: a host thread pool decodes the next chunk
while the card runs the current one, and the four outputs of a batch come
back as one packed [B, 100, 7] f32 tensor, one copy to the host a batch.
The JAX package's mesh, its sub-mesh fallback and ``micro_batch`` are TPU
dispatch devices and are left out: one card runs the whole batch, and a
short last chunk runs as it is, without padding.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from PIL import Image

from tise_tpu_torch.backbones.detection import weights as det_weights
from tise_tpu_torch.backbones.detection.coco_classes import COCO_CLASSES
from tise_tpu_torch.backbones.detection.rcnn import Detections, FasterRCNN
from tise_tpu_torch.core.config import resolve_device

INPUT_SIZE = 800
PIXEL_MEAN_BGR = np.array([103.530, 116.280, 123.675], np.float32)
#: detectron2 ResizeShortestEdge defaults on the reference configs
SHORT_EDGE = 800
MAX_SIZE = 1333
#: shape buckets for aspect-preserving inference (square, landscape,
#: portrait); 1344 = 1333 rounded up for even FPN striding
DEFAULT_BUCKETS = ((800, 800), (800, 1344), (1344, 800))

#: memory layout of the model and its input by dtype: cuDNN runs trunk+FPN
#: faster in NCHW in f32 and channels last in bf16 (chip_smoke.py's
#: det_timings on one H100)
MEMORY_FORMAT = {torch.float32: torch.contiguous_format, torch.bfloat16: torch.channels_last}

#: per image: ([class names], [class ids], [xyxy boxes in original coordinates])
FileDetections = Tuple[List[str], List[int], List[np.ndarray]]


def load_bgr_image(path: str, size: int = INPUT_SIZE) -> Tuple[np.ndarray, Tuple[int, int]]:
    """-> (uint8 BGR [size, size, 3], original (h, w))."""
    with Image.open(path) as im:
        im = im.convert("RGB")
        orig = (im.height, im.width)
        im = im.resize((size, size), Image.BILINEAR)
        rgb = np.asarray(im, np.uint8)
    return rgb[:, :, ::-1].copy(), orig


def pick_bucket(rh: int, rw: int, buckets: Sequence[Tuple[int, int]]) -> int:
    """Smallest-area bucket that fits (rh, rw); if none fits (extreme aspect
    ratio), the bucket needing the least extra downscale."""
    fitting = [i for i, (bh, bw) in enumerate(buckets) if bh >= rh and bw >= rw]
    if fitting:
        return min(fitting, key=lambda i: buckets[i][0] * buckets[i][1])
    return max(range(len(buckets)), key=lambda i: min(buckets[i][0] / rh, buckets[i][1] / rw))


def _resized_extent(oh: int, ow: int, short: int, max_size: int) -> Tuple[int, int]:
    """ResizeShortestEdge: scale = short / min side, capped so the long side
    stays <= max_size."""
    scale = short / min(oh, ow)
    if scale * max(oh, ow) > max_size:
        scale = max_size / max(oh, ow)
    return int(round(oh * scale)), int(round(ow * scale))


def load_bgr_image_bucketed(
    path: str, buckets: Sequence[Tuple[int, int]], short: int = SHORT_EDGE, max_size: int = MAX_SIZE
) -> Tuple[np.ndarray, Tuple[int, int], Tuple[int, int], int]:
    """detectron2 ResizeShortestEdge + zero-pad to a bucket.

    -> (uint8 BGR [bh, bw, 3], original (h, w), resized valid (rh, rw),
    bucket index).  An image that fits no bucket shrinks further into the
    chosen one."""
    with Image.open(path) as im:
        im = im.convert("RGB")
        oh, ow = im.height, im.width
        rh, rw = _resized_extent(oh, ow, short, max_size)
        bi = pick_bucket(rh, rw, buckets)
        bh, bw = buckets[bi]
        if rh > bh or rw > bw:  # extreme aspect ratio: shrink into the bucket
            fit = min(bh / rh, bw / rw)
            # round like every other resize here (truncation would bias the
            # oh/rh box rescale factor) and clamp into the bucket
            rh, rw = min(int(round(rh * fit)), bh), min(int(round(rw * fit)), bw)
        rgb = np.asarray(im.resize((rw, rh), Image.BILINEAR), np.uint8)
    canvas = np.zeros((bh, bw, 3), np.uint8)
    canvas[:rh, :rw] = rgb[:, :, ::-1]
    return canvas, (oh, ow), (rh, rw), bi


def pack_detections(det: Detections) -> torch.Tensor:
    """-> one [B, D, 7] f32 tensor (boxes | score | class | valid), so a batch
    costs one copy to the host (classes 0..79 are exact in f32).  Inverse:
    ``Detector._unpack``."""
    return torch.cat([det.boxes.float(), det.scores.float()[..., None], det.classes.float()[..., None],
                      det.valid.float()[..., None]], dim=-1)


def _double_buffer(chunks, decode):
    """Yield ``(chunk, decode(chunk))`` with the NEXT chunk's decode already
    running while the caller runs the card on the current one.  A dedicated
    one-thread runner drives the prefetch, so the shared decode pool is never
    filled by orchestration tasks."""
    if not chunks:
        return
    with ThreadPoolExecutor(max_workers=1) as runner:
        pending = runner.submit(decode, chunks[0])
        for i, chunk in enumerate(chunks):
            decoded = pending.result()
            if i + 1 < len(chunks):
                pending = runner.submit(decode, chunks[i + 1])
            yield chunk, decoded


class Detector:
    """Batched Faster R-CNN R50-FPN inference engine on one device (the JAX
    package's ``TPUDetector``).  Calling it on a list of files runs
    :meth:`detect_files`.

    ``weights``: a detectron2 ``.pkl`` or JAX ``.npz`` path, a port state
    dict, or ``None`` for ``random_detectron2_state_dict(0)``.
    ``dtype=torch.bfloat16`` selects the fast forward (f32 score and box
    math).  ``aspect_buckets`` turns on the aspect-preserving resize.
    ``device`` ``None`` means the card.  ``nms_rounds`` collects the rounds
    of every NMS the detector ran (``ops.nms_mask``)."""

    def __init__(
        self,
        weights: Union[None, str, Mapping[str, np.ndarray]] = None,
        batch_size: int = 4,
        dtype: torch.dtype = torch.float32,
        input_size: int = INPUT_SIZE,
        aspect_buckets: Optional[Sequence[Tuple[int, int]]] = None,
        aspect_short: int = SHORT_EDGE,
        aspect_max: int = MAX_SIZE,
        score_thresh: float = 0.5,
        roi_sampling: int = 2,
        proposals: int = 1000,
        device=None,
    ):
        self.device = resolve_device(device)
        if weights is None:
            state = det_weights.state_dict_from_detectron2(det_weights.random_detectron2_state_dict(0))
        elif isinstance(weights, str):
            state = det_weights.load_weights(weights)
        else:
            state = weights
        model = FasterRCNN(score_thresh=score_thresh, roi_sampling=roi_sampling, post_nms_topk=proposals)
        model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state.items()})
        self.memory_format = MEMORY_FORMAT[dtype]
        self.model = model.to(self.device, dtype, memory_format=self.memory_format).eval()
        self.dtype = dtype
        self.batch_size = batch_size
        self.input_size = input_size
        self.aspect_buckets = tuple(aspect_buckets) if aspect_buckets else None
        self.aspect_short = aspect_short
        self.aspect_max = aspect_max
        self.nms_rounds: List[int] = []
        self._mean = torch.from_numpy(PIXEL_MEAN_BGR).to(self.device)

    def _upload(self, images_u8_bgr: np.ndarray) -> torch.Tensor:
        """uint8 [B, H, W, 3] -> the model's input [B, 3, H, W] on the device
        in the model's memory layout: the mean is subtracted in f32 before
        the cast to the model's dtype, as in the JAX package (bf16 holds uint8
        exactly, not the shifted values)."""
        x = torch.from_numpy(np.ascontiguousarray(images_u8_bgr))
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        x = (x.float() - self._mean).to(self.dtype)
        return x.permute(0, 3, 1, 2).contiguous(memory_format=self.memory_format)

    def _forward(self, images_u8_bgr: np.ndarray, valid_hw: Optional[np.ndarray] = None) -> torch.Tensor:
        with torch.inference_mode():
            x = self._upload(images_u8_bgr)
            hw = None if valid_hw is None else torch.from_numpy(valid_hw).to(self.device)
            return pack_detections(self.model(x, hw, self.nms_rounds))

    def detect_batch(self, images_u8_bgr: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """[B, S, S, 3] BGR uint8 -> (boxes, scores, classes, valid) in the
        input's coordinates."""
        return self._unpack(self._forward(images_u8_bgr))

    @staticmethod
    def _unpack(packed: torch.Tensor) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """[B, D, 7] -> (boxes, scores, classes, valid) host arrays, one copy."""
        p = packed.cpu().numpy()
        return p[..., :4], p[..., 4], p[..., 5].astype(np.int64), p[..., 6] > 0.5

    def _run_pipeline(self, chunks, decode, dispatch, drain) -> None:
        """The 1-deep sweep loop of detect_files and detect_files_bucketed:
        the next chunk's decode overlaps the card's work
        (``_double_buffer``) and each dispatch runs one batch ahead of the
        blocking copy of its result."""
        inflight = None
        for chunk, decoded in _double_buffer(chunks, decode):
            det = dispatch(chunk, decoded)
            if inflight is not None:
                drain(*inflight)
            inflight = (chunk, decoded, det)
        if inflight is not None:
            drain(*inflight)

    @staticmethod
    def _collect(out, path, det_row, scale_xy) -> None:
        boxes, _scores, classes, valid = det_row
        sy, sx = scale_xy
        names: List[str] = []
        ids: List[int] = []
        bxs: List[np.ndarray] = []
        for j in range(boxes.shape[0]):
            if not valid[j]:
                continue
            cls = int(classes[j])
            names.append(COCO_CLASSES[cls])
            ids.append(cls)
            bxs.append(boxes[j] * np.array([sx, sy, sx, sy], np.float32))
        out[path] = (names, ids, bxs)

    def detect_files_bucketed(self, files: Sequence[str], num_workers: int = 8) -> Dict[str, FileDetections]:
        """Aspect-preserving path: group files by bucket from their headers
        (a sweep must not hold every decoded canvas), then decode a chunk at
        a time and run each bucket's shape with true-extent clipping; boxes
        rescale by the resize factor."""
        out: Dict[str, FileDetections] = {}

        def probe(path):
            with Image.open(path) as im:  # header read only, no decode
                oh, ow = im.height, im.width
            return pick_bucket(*_resized_extent(oh, ow, self.aspect_short, self.aspect_max), self.aspect_buckets)

        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            groups: Dict[int, List[int]] = {}
            for i, bi in enumerate(pool.map(probe, files)):
                groups.setdefault(bi, []).append(i)
            chunks = [idxs[start: start + self.batch_size]
                      for idxs in groups.values() for start in range(0, len(idxs), self.batch_size)]

            def decode(chunk):
                return list(pool.map(lambda i: load_bgr_image_bucketed(
                    files[i], self.aspect_buckets, self.aspect_short, self.aspect_max), chunk))

            def dispatch(chunk, decoded):
                imgs = np.stack([d[0] for d in decoded])
                return self._forward(imgs, np.asarray([d[2] for d in decoded], np.float32))

            def drain(chunk, decoded, det):
                b, s, c, v = self._unpack(det)
                for row, i in enumerate(chunk):
                    (oh, ow), (rh, rw) = decoded[row][1], decoded[row][2]
                    self._collect(out, files[i], (b[row], s[row], c[row], v[row]), (oh / rh, ow / rw))

            self._run_pipeline(chunks, decode, dispatch, drain)
        return out

    def detect_files(self, files: Sequence[str], num_workers: int = 8) -> Dict[str, FileDetections]:
        """DefaultPredictor-shaped output: path -> (names, ids, boxes in
        original image coordinates)."""
        if self.aspect_buckets:
            return self.detect_files_bucketed(files, num_workers)
        out: Dict[str, FileDetections] = {}
        chunks = [list(files[s: s + self.batch_size]) for s in range(0, len(files), self.batch_size)]
        with ThreadPoolExecutor(max_workers=num_workers) as pool:

            def decode(chunk):
                return list(pool.map(lambda f: load_bgr_image(f, self.input_size), chunk))

            def dispatch(chunk, decoded):
                return self._forward(np.stack([d[0] for d in decoded]))

            def drain(chunk, decoded, det):
                boxes, scores, classes, valid = self._unpack(det)
                for i, path in enumerate(chunk):
                    oh, ow = decoded[i][1]
                    sy, sx = oh / self.input_size, ow / self.input_size
                    self._collect(out, path, (boxes[i], scores[i], classes[i], valid[i]), (sy, sx))

            self._run_pipeline(chunks, decode, dispatch, drain)
        return out

    __call__ = detect_files


def make_folder_detector(
    weights: Union[None, str, Mapping[str, np.ndarray]],
    batch_size: Optional[int] = None,
    aspect_resize: bool = False,
    precision: str = "highest",
    roi_sampling: int = 2,
    proposals: int = 1000,
    device=None,
) -> Detector:
    """The CLIs' detector.  ``precision='fast'`` selects the bf16 forward
    (f32 score and box math) and a default batch of 32; 'highest' is f32 at
    a batch of 4.  ``roi_sampling=1`` and ``proposals`` (post-NMS top-k,
    detectron2's 1000 by default) are the opt-in sweep settings."""
    fast = precision == "fast"
    if batch_size is None:
        batch_size = 32 if fast else 4
    return Detector(
        weights,
        batch_size=batch_size,
        dtype=torch.bfloat16 if fast else torch.float32,
        aspect_buckets=DEFAULT_BUCKETS if aspect_resize else None,
        roi_sampling=roi_sampling,
        proposals=proposals,
        device=device,
    )
