"""The port's detection stack (tise_tpu_torch.backbones.detection) against the
JAX package's on the CPU.

Weights are one synthetic detectron2 state dict
(tests/torch_rcnn_ref.py::build_synthetic_state_dict, objectness and
classifier sharpened as in tests/test_detection.py's oracle test); inputs are
seeded numpy: boxes, feature maps, and 128 x 128 images of smooth blobs on
noise.  The ops are held to the JAX ops bit for bit or within 1e-6 (NMS
masks equal, with rows of -inf, planted ties and chains of suppression
deeper than the port's check interval); the trunk, FPN and RPN within 2e-3
of each map's scale (tests/test_detection.py's own bound); the postprocess
on the same inputs to the same kept set; whole detections as
tests/test_detection.py matches them (class equal, |score difference| <=
0.05, IoU > 0.85, >= 0.9 matched both ways) in f32; in bf16 against the
JAX bf16 model at least as well as that model matches the JAX f32 one,
less 0.05.  The SOA CLI of each package also runs its real detector at
128 px here, so that the JAX detector program is compiled once per dtype
for the module.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from tests.torch_rcnn_ref import build_synthetic_state_dict
from tise_tpu.backbones.detection import ops as jops
from tise_tpu.backbones.detection import predictor as jpredictor
from tise_tpu.backbones.detection.rcnn import BoxHead as JBoxHead
from tise_tpu.backbones.detection.rcnn import RPNHead as JRPNHead
from tise_tpu.backbones.detection.rcnn import postprocess_detections as jpostprocess
from tise_tpu.backbones.detection.resnet_fpn import FPN as JFPN
from tise_tpu.backbones.detection.resnet_fpn import ResNet50 as JResNet50
from tise_tpu.backbones.detection.weights import load_detectron2_pkl, params_from_detectron2
from tise_tpu.core import weights as jweights
from tise_tpu.metrics import soa as jsoa
from tise_tpu_torch.backbones.detection import ops, predictor, rcnn, weights
from tise_tpu_torch.core import io as tio
from tise_tpu_torch.metrics import soa as tsoa

SIZE = 128
GAINS = {"rpn_gain": 5.0, "cls_gain": 0.01}


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


def blob_images(n: int, size: int, seed: int) -> np.ndarray:
    """n uint8 RGB images of smooth coloured blobs on low noise."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    out = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        img = rng.uniform(0, 40, (size, size, 3)).astype(np.float32)
        for _ in range(6):
            cy, cx = rng.uniform(0, size, 2)
            s = rng.uniform(size / 16, size / 4)
            blob = np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * s * s))
            img += blob[..., None] * rng.uniform(50, 200, 3).astype(np.float32)
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The synthetic checkpoint as a detectron2 .pkl, its JAX params, the
    port's state dict, and four images."""
    root = tmp_path_factory.mktemp("detection")
    sd = build_synthetic_state_dict(seed=0, **GAINS)
    pkl = str(root / "model_final.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"model": sd}, f)
    return {"root": root, "sd": sd, "pkl": pkl, "jparams": params_from_detectron2(sd),
            "state": weights.state_dict_from_detectron2(sd), "images": blob_images(4, SIZE, seed=3)}


@pytest.fixture(scope="module")
def jax_detectors(world):
    """The JAX folder detectors at 128 px (f32 and bf16), each compiled once.
    Batches of 2: at 1,000 proposals ROIAlign gathers 0.8 GB an image in
    f32 whatever the image size, in both packages."""
    return {dt: jpredictor.TPUDetector(world["pkl"], batch_size=2, input_size=SIZE, dtype=dt)
            for dt in (jnp.float32, jnp.bfloat16)}


def port_detector(world, dtype=torch.float32, batch_size=2):
    return predictor.Detector(world["state"], batch_size=batch_size, dtype=dtype, input_size=SIZE, device="cpu")


def detect(det, images_bgr):
    """detect_batch a batch at a time -> (boxes, scores, classes, valid)."""
    parts = [det.detect_batch(images_bgr[i: i + det.batch_size]) for i in range(0, len(images_bgr), det.batch_size)]
    return tuple(np.concatenate(p) for p in zip(*parts))


# ------------------------------------------------------------------ weights


def test_random_state_dict_is_the_oracles():
    got = weights.random_detectron2_state_dict(0, **GAINS)
    want = build_synthetic_state_dict(0, **GAINS)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_weight_routes_bit_equal(world):
    """The direct detectron2 loader, and the JAX loader followed by the
    function that carries JAX params across (from the .pkl and from a JAX
    .npz pytree), give the same state dict bit for bit, which loads into
    the port's model with no key missing or left over."""
    direct = weights.load_weights(world["pkl"])
    carried = weights.state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, load_detectron2_pkl(world["pkl"])))
    npz = str(world["root"] / "detector.npz")
    jweights.save_pytree_npz(npz, world["jparams"])
    from_npz = weights.load_weights(npz)
    for other in (carried, from_npz):
        assert sorted(other) == sorted(direct)
        for k in direct:
            assert other[k].shape == direct[k].shape and np.array_equal(other[k], direct[k]), k
    model = rcnn.FasterRCNN()
    missing, unexpected = model.load_state_dict({k: torch.from_numpy(v) for k, v in direct.items()}, strict=False)
    assert not missing and not unexpected


# ---------------------------------------------------------------------- ops


@pytest.mark.parametrize("fh,fw,stride,size", [(4, 5, 16, 32), (32, 32, 4, 32), (13, 7, 64, 512)])
def test_generate_anchors_bit_equal(fh, fw, stride, size):
    got, want = ops.generate_anchors(fh, fw, stride, size), jops.generate_anchors(fh, fw, stride, size)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def random_boxes(rng, shape, lo=0.0, hi=128.0, min_wh=2.0, max_wh=60.0):
    centers = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(min_wh, max_wh, shape + (2,))
    return np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)


def close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_box_ops_match_jax():
    rng = np.random.RandomState(0)
    boxes = random_boxes(rng, (3, 50))
    deltas = (rng.randn(3, 50, 4) * 0.5).astype(np.float32)
    deltas[0, :5, 2:] = 9.0  # past the log(1000/16) clamp
    for b, d in zip(boxes, deltas):
        close(ops.apply_deltas(torch.from_numpy(b), torch.from_numpy(d)), jops.apply_deltas(b, d), atol=1e-5)
    batched = ops.apply_deltas(torch.from_numpy(boxes), torch.from_numpy(deltas))
    close(batched, np.stack([np.asarray(jops.apply_deltas(b, d)) for b, d in zip(boxes, deltas)]), atol=1e-5)
    wide = boxes * 2 - 40
    close(ops.clip_boxes(torch.from_numpy(wide), 100, 120), jops.clip_boxes(wide, 100, 120))
    hw = torch.tensor([[100.0], [64.0], [128.0]])  # one extent per image
    got = ops.clip_boxes(torch.from_numpy(wide), hw, hw + 8)
    for i in range(3):
        close(got[i], jops.clip_boxes(wide[i], float(hw[i, 0]), float(hw[i, 0]) + 8))
    got = ops.box_iou(torch.from_numpy(boxes), torch.from_numpy(boxes[:, :20]))
    for i in range(3):
        close(got[i], jops.box_iou(boxes[i], boxes[i, :20]), atol=1e-7)
    sized = random_boxes(rng, (200,), lo=0, hi=800, min_wh=4, max_wh=700)
    levels = ops.assign_fpn_level(torch.from_numpy(sized)).numpy()
    assert np.array_equal(levels, np.asarray(jops.assign_fpn_level(sized)))
    assert set(levels) == {2, 3, 4, 5}


def test_topk_sorted_breaks_ties_like_jax():
    """Planted ties (equal values, rows of -inf, values equal in bf16) come
    out in the order jax.lax.top_k gives them: lower index first."""
    rng = np.random.RandomState(1)
    x = rng.randint(0, 6, (4, 300)).astype(np.float32)
    x[1, ::3] = -np.inf
    x[2] = -np.inf
    x[3] = np.asarray(jnp.asarray(rng.rand(300), jnp.bfloat16).astype(jnp.float32))
    for k in (1, 37, 300):
        values, index = ops.topk_sorted(torch.from_numpy(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        assert np.array_equal(index.numpy(), np.asarray(ji)) and np.array_equal(values.numpy(), np.asarray(jv))


def nms_cases():
    """[cases, 60, 4] boxes sorted by score and their scores: random boxes;
    planted duplicates with equal scores; rows of -inf; a chain of 13 boxes
    each overlapping the next (suppression depth 12, three check intervals
    deep)."""
    rng = np.random.RandomState(2)
    k = 60
    boxes = random_boxes(rng, (4, k), hi=60.0, min_wh=4.0, max_wh=30.0)
    scores = -np.sort(-rng.rand(4, k).astype(np.float32), axis=1)
    boxes[1, 10:20] = boxes[1, 0:10]  # duplicates, tied scores
    scores[1, 10:20] = scores[1, 0:10]
    scores[1] = -np.sort(-scores[1])
    scores[2, 40:] = -np.inf
    boxes[2, 50:] = 0.0  # empty padding rows
    chain = np.arange(13, dtype=np.float32)[:, None] * 4.0
    boxes[3, :13] = np.concatenate([chain, chain * 0, chain + 10.0, chain * 0 + 10.0], 1)  # IoU 0.43 with the next
    return boxes, scores


def fixpoint_rounds(boxes, threshold):
    """Rounds of the JAX while loop on one set: up to and including the
    first that changes nothing."""
    k = len(boxes)
    over = (np.asarray(jops.box_iou(boxes, boxes)) > threshold) & np.triu(np.ones((k, k), bool), 1)
    keep, t = np.ones(k, bool), 0
    while True:
        new, t = ~(over & keep[:, None]).any(0), t + 1
        if (new == keep).all():
            return t
        keep = new


@pytest.mark.parametrize("threshold", [0.4, 0.5, 0.7])
def test_nms_mask_equals_jax(threshold):
    boxes, scores = nms_cases()
    rounds = []
    got = ops.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), threshold, rounds=rounds).numpy()
    for i in range(len(boxes)):
        want = np.asarray(jops.nms_mask(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), threshold))
        assert np.array_equal(got[i], want), i
    assert rounds == [max(fixpoint_rounds(b, threshold) for b in boxes)]
    if threshold == 0.4:  # the chain suppresses every other box, past three check intervals
        assert np.array_equal(got[3, :13], np.arange(13) % 2 == 0) and rounds[0] > 3 * ops.NMS_CHECK_EVERY
    for every in (1, 7):
        again = ops.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), threshold, check_every=every)
        assert np.array_equal(again.numpy(), got)


@pytest.mark.parametrize("sampling", [1, 2])
def test_roi_align_multilevel_matches_jax(sampling):
    """Two images' P2..P5 at 128 px and 24 boxes each, of every level."""
    rng = np.random.RandomState(4)
    feats = [rng.randn(2, SIZE // s, SIZE // s, 16).astype(np.float32) for s in (4, 8, 16, 32)]
    boxes = random_boxes(rng, (2, 24), lo=10, hi=SIZE - 10, min_wh=4, max_wh=100)
    got = ops.roi_align_multilevel([torch.from_numpy(f) for f in feats], torch.from_numpy(boxes),
                                   ops.assign_fpn_level(torch.from_numpy(boxes)), sampling=sampling).numpy()
    scale = max(np.abs(f).max() for f in feats)
    for i in range(2):
        want = jops.roi_align_multilevel([jnp.asarray(f[i]) for f in feats], jnp.asarray(boxes[i]),
                                         jops.assign_fpn_level(jnp.asarray(boxes[i])), sampling=sampling)
        np.testing.assert_allclose(got[i] / scale, np.asarray(want) / scale, rtol=0, atol=1e-5)


# ------------------------------------------------------------- the network


def normalized(images_u8_rgb: np.ndarray) -> np.ndarray:
    return images_u8_rgb[..., ::-1].astype(np.float32) - predictor.PIXEL_MEAN_BGR


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-3), ("bfloat16", 4e-2)])
def test_trunk_fpn_rpn_box_head_match_jax(world, dtype, tol):
    """ResNet50, FPN, RPNHead at 128 px and BoxHead on the same ROI
    features, port against JAX, within 2e-3 of each map's scale in f32
    (tests/test_detection.py's bound) and 4e-2 in bf16 (the bf16 bound of
    the Inception trunks' tests; either package's bf16 maps sit about 1e-2
    of scale from its f32 ones)."""
    params = world["jparams"]["params"]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = normalized(world["images"][:2])
    model = rcnn.FasterRCNN()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in world["state"].items()})
    model = model.to(tdt)
    with torch.no_grad():
        feats = model.features(torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt))
        logits, deltas = model.rpn(feats)
    xj = jnp.asarray(x).astype(jdt)
    trunk = jax.jit(lambda p, x: JResNet50(dtype=jdt).apply({"params": p}, x))(params["backbone"], xj)
    jfeats = jax.jit(lambda p, t: JFPN(dtype=jdt).apply({"params": p}, t))(params["fpn"], trunk)
    jlogits, jdeltas = jax.jit(lambda p, f: JRPNHead(dtype=jdt).apply({"params": p}, list(f)))(
        params["rpn"], tuple(jfeats))

    def within(got, want):
        want = np.asarray(want.astype(jnp.float32))
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(got.float().numpy() / scale, want / scale, rtol=0, atol=tol)

    for pairs in ((feats, jfeats), (logits, jlogits), (deltas, jdeltas)):
        for got, want in zip(*pairs):
            within(got.permute(0, 2, 3, 1), want)
    roi = np.random.RandomState(5).rand(2, 30, 7, 7, 256).astype(np.float32)
    with torch.no_grad():
        cls_logits, box_deltas = model.box_head(torch.from_numpy(roi).to(tdt))
    jcls, jbox = JBoxHead(dtype=jdt).apply({"params": params["box_head"]}, jnp.asarray(roi.reshape(60, 7, 7, 256)).astype(jdt))
    for got, want in ((cls_logits, jcls), (box_deltas, jbox)):
        within(got, want.reshape(got.shape))


def postprocess_inputs(seed):
    """tests/test_detection.py's postprocess case: 40 proposals, half of them
    near-duplicates of the other half, a few confident classes."""
    rng = np.random.RandomState(seed)
    k = 40
    centers = rng.uniform(40, 216, (k, 2))
    centers[20:] = centers[:20] + rng.uniform(-6, 6, (20, 2))
    sizes = rng.uniform(20, 80, (k, 2))
    proposals = np.concatenate([centers - sizes / 2, centers + sizes / 2], 1).astype(np.float32)
    cls_logits = rng.randn(k, 81).astype(np.float32)
    cls_logits[:, 80] += 2.0
    cls_logits[np.arange(k), rng.randint(0, 80, k)] += rng.uniform(0, 7, k).astype(np.float32)
    box_deltas = (rng.randn(k, 320) * 0.5).astype(np.float32)
    valid = rng.rand(k) > 0.1
    return proposals, valid, cls_logits, box_deltas


def test_postprocess_matches_jax():
    """Two images, each against the JAX postprocess on the same proposals,
    logits and deltas: the same kept set in the same order, boxes and scores
    within 1e-5; once with each image's own clip extent."""
    inputs = [postprocess_inputs(7), postprocess_inputs(8)]
    stacked = [torch.from_numpy(np.stack(a)) for a in zip(*inputs)]
    hw = np.asarray([[200.0, 230.0], [256.0, 180.0]], np.float32)
    for clip in (None, hw):
        det = rcnn.postprocess_detections(*stacked, 256, 256, clip_hw=None if clip is None else torch.from_numpy(clip))
        for i, args in enumerate(inputs):
            want = jpostprocess(*map(jnp.asarray, args), 256, 256,
                                clip_hw=None if clip is None else tuple(jnp.asarray(clip[i])))
            valid = np.asarray(want.valid)
            assert valid.sum() > 3 and np.array_equal(det.valid[i].numpy(), valid)
            assert np.array_equal(det.classes[i].numpy()[valid], np.asarray(want.classes)[valid])
            close(det.scores[i].numpy()[valid], np.asarray(want.scores)[valid], rtol=1e-5)
            close(det.boxes[i].numpy()[valid], np.asarray(want.boxes)[valid], rtol=1e-5, atol=1e-4)


def rows(boxes, scores, classes, valid):
    return [(int(c), b, float(s)) for b, s, c, v in zip(boxes, scores, classes, valid) if v]


def iou_one_to_many(box, boxes):
    lt, rb = np.maximum(box[:2], boxes[:, :2]), np.minimum(box[2:], boxes[:, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
    union = np.prod(box[2:] - box[:2]) + np.prod(boxes[:, 2:] - boxes[:, :2], axis=1) - inter
    return inter / np.maximum(union, 1e-9)


def matched(a, b, score_tol=0.05, iou_min=0.85):
    """The share of detections in ``a`` with a partner in ``b``: the same
    class, scores within ``score_tol``, IoU above ``iou_min``
    (tests/test_detection.py's rule)."""
    hits = 0
    for ca, ba, sa in a:
        cand = [bb for cb, bb, sb in b if cb == ca and abs(sa - sb) <= score_tol]
        hits += bool(cand) and bool((iou_one_to_many(np.asarray(ba), np.stack(cand)) > iou_min).any())
    return hits / max(len(a), 1)


def pooled(det, n):
    """Each image's valid detections as ((image, class), box, score), so that
    pooled over images a detection matches only within its own image."""
    return [((i, c), b, s) for i in range(n) for c, b, s in rows(*(a[i] for a in det))]


def test_end_to_end_detections_match_jax(world, jax_detectors):
    """Four images through the port's Detector and the JAX TPUDetector in
    f32: each image's detections matched >= 0.9 both ways."""
    bgr = world["images"][..., ::-1].copy()
    got, want = detect(port_detector(world), bgr), detect(jax_detectors[jnp.float32], bgr)
    for i in range(4):
        ours, theirs = rows(*(g[i] for g in got)), rows(*(w[i] for w in want))
        assert len(theirs) > 0
        assert matched(ours, theirs) >= 0.9 and matched(theirs, ours) >= 0.9, i


def test_end_to_end_bf16_detections_match_jax_bf16(world, jax_detectors):
    """The port's bf16 Detector against the JAX bf16 TPUDetector on the same
    four images, pooled.  With random weights bf16 rounding moves the
    detections in the JAX package itself: its bf16 detections match its own
    f32 ones at about 0.8 here (the random box head scores every proposal
    near one value, so the order of NMS among overlapping boxes turns on
    rounding).  So the bound is the JAX package's own bf16-against-f32
    share, capped at 0.9, less 0.05: the port's bf16 path must be as close
    to JAX's bf16 as bf16 is to f32."""
    bgr = world["images"][..., ::-1].copy()
    t16 = pooled(detect(port_detector(world, torch.bfloat16), bgr), 4)
    j16 = pooled(detect(jax_detectors[jnp.bfloat16], bgr), 4)
    j32 = pooled(detect(jax_detectors[jnp.float32], bgr), 4)
    floor = min(0.9, matched(j16, j32), matched(j32, j16)) - 0.05
    shares = {"port bf16 in JAX bf16": matched(t16, j16), "JAX bf16 in port bf16": matched(j16, t16),
              "JAX bf16 in JAX f32": matched(j16, j32), "JAX f32 in JAX bf16": matched(j32, j16)}
    print(f"bf16 detections matched, pooled over 4 images: {shares}")
    assert len(j16) > 0 and shares["port bf16 in JAX bf16"] >= floor and shares["JAX bf16 in port bf16"] >= floor, \
        (floor, shares)


def test_batch_equals_single_images(world):
    """The port's batch of two equals two forwards of one image."""
    det = port_detector(world)
    bgr = world["images"][:2, ..., ::-1].copy()
    batched = det.detect_batch(bgr)
    for i in range(2):
        single = det.detect_batch(bgr[i: i + 1])
        for got, want in zip(single, batched):
            np.testing.assert_allclose(got[0], want[i], rtol=1e-5, atol=1e-4)
        assert np.array_equal(single[2][0], batched[2][i]) and np.array_equal(single[3][0], batched[3][i])
    assert len(det.nms_rounds) == 2 * 3 and min(det.nms_rounds) >= 1


def test_soa_cli_with_the_real_detector_matches_jax(world, jax_detectors, tmp_path, monkeypatch):
    """Both SOA CLIs over 3 label folders of 2-3 images, each package with
    its own detector at 128 px from the same checkpoint: the per-label
    pickles hold the same files, and each file's detections match >= 0.9
    both ways (boxes in the original 128 px coordinates)."""
    root = tmp_path / "images"
    images = iter(blob_images(8, SIZE, seed=9))
    for label, n in ((15, 3), (2, 2), (40, 3)):
        folder = root / f"label_{label:02d}_{label:02d}"
        folder.mkdir(parents=True)
        for i in range(n):
            Image.fromarray(next(images)).save(str(folder / f"{i}.png"))
    monkeypatch.setattr(jpredictor, "make_folder_detector", lambda *a, **k: jax_detectors[jnp.float32].detect_files)
    monkeypatch.setattr(predictor, "make_folder_detector", lambda *a, **k: port_detector(world))
    common = ["--images", str(root), "--weights", world["pkl"]]
    jsoa.main(common + ["--detected_results", str(tmp_path / "jax"), "--saved_file", str(tmp_path / "jax.txt")])
    tsoa.main(common + ["--detected_results", str(tmp_path / "port"), "--saved_file", str(tmp_path / "port.txt"),
                        "--device", "cpu"])
    for name in sorted(os.listdir(tmp_path / "jax")):
        if not name.startswith("detected_"):
            continue
        ours, theirs = tio.load_pickle(str(tmp_path / "port" / name)), tio.load_pickle(str(tmp_path / "jax" / name))
        assert sorted(ours) == sorted(theirs) and len(theirs) > 0
        for f in theirs:
            a = [(c, np.asarray(b), 1.0) for c, b in zip(ours[f][1], ours[f][2])]
            b = [(c, np.asarray(b), 1.0) for c, b in zip(theirs[f][1], theirs[f][2])]
            assert matched(a, b) >= 0.9 and matched(b, a) >= 0.9, (name, f)
    assert tio.read_soa_result(str(tmp_path / "port.txt")) == tio.read_soa_result(str(tmp_path / "jax.txt"))


BUCKETS = ((128, 128), (128, 192), (192, 128))


def test_loaders_match_jax(tmp_path):
    """The square and the bucketed loaders give the JAX loaders' pixels and
    geometry; the bucket choice is the same."""
    rng = np.random.RandomState(6)
    for h, w in ((50, 100), (40, 40), (100, 30), (200, 20)):
        path = str(tmp_path / f"{h}x{w}.png")
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(path)
        got, want = predictor.load_bgr_image(path, 96), jpredictor.load_bgr_image(path, 96)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
        got = predictor.load_bgr_image_bucketed(path, BUCKETS, short=128, max_size=192)
        want = jpredictor.load_bgr_image_bucketed(path, BUCKETS, short=128, max_size=192)
        assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    for rh, rw in ((128, 128), (100, 192), (192, 90), (300, 20), (20, 300)):
        assert predictor.pick_bucket(rh, rw, BUCKETS) == jpredictor.pick_bucket(rh, rw, BUCKETS)


def test_bucketed_detections_match_jax(world, tmp_path):
    """Two landscape images through the bucketed path of both packages (one
    bucket, 128 x 192, zero padding below the resized image, proposals and
    boxes clipped to the true extent): each file's detections, in its
    original coordinates, matched >= 0.9 both ways.  Then a folder of three
    shapes through the port's bucketed path: every box inside its image."""
    files = []
    for name, (h, w) in (("a", (60, 96)), ("b", (64, 120))):
        files.append(str(tmp_path / f"{name}.png"))
        Image.fromarray(blob_images(1, max(h, w), seed=len(files))[0][:h, :w]).save(files[-1])
    kw = {"aspect_buckets": BUCKETS, "aspect_short": 128, "aspect_max": 192}
    ours = predictor.Detector(world["state"], batch_size=2, device="cpu", **kw).detect_files(files)
    theirs = jpredictor.TPUDetector(world["pkl"], batch_size=2, input_size=SIZE, **kw).detect_files(files)
    for f in files:
        a = [(c, b, 1.0) for c, b in zip(ours[f][1], ours[f][2])]
        b = [(c, b, 1.0) for c, b in zip(theirs[f][1], theirs[f][2])]
        assert len(b) > 0 and matched(a, b) >= 0.9 and matched(b, a) >= 0.9, f
    files.append(str(tmp_path / "c.png"))
    Image.fromarray(blob_images(1, 90, seed=7)[0][:, :50]).save(files[-1])
    det = predictor.Detector(world["state"], batch_size=2, device="cpu", **kw)
    out = det.detect_files(files)
    assert set(out) == set(files) and len(det.nms_rounds) == 2 * 2  # two buckets, one batch each
    for f, (_, _, boxes) in out.items():
        with Image.open(f) as im:
            w, h = im.size
        for b in boxes:
            assert b[0] >= 0 and b[1] >= 0 and b[2] <= w + 1e-3 and b[3] <= h + 1e-3
