"""The port's crop and SOA CLIs (tise_tpu_torch.metrics.{crop_objects,soa})
against the JAX package's on the CPU, with one stub detector that both
packages take: a fixed table of detections by file name, degenerate boxes
and boxes past the image's edge among them.  The crops (names and pixels),
the per-label pickles, ``result_file.pkl`` and the SOA result file must be
byte-identical, a crop run killed after one slab must resume to the same
files, and a SOA run with some labels already detected must run the
detector on the others only, in both packages.  The real detector's runs
are in tests/test_torch_detection.py.
"""

import inspect
import os

import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from tise_tpu.backbones.detection import predictor as jpredictor
from tise_tpu.core import io as jio
from tise_tpu.metrics import crop_objects as jcrop
from tise_tpu.metrics import soa as jsoa
from tise_tpu_torch.backbones.detection import predictor
from tise_tpu_torch.backbones.detection.coco_classes import COCO_CLASSES
from tise_tpu_torch.core import io as tio
from tise_tpu_torch.metrics import crop_objects as tcrop
from tise_tpu_torch.metrics import soa as tsoa

LABELS = (3, 15, 0, 79, 41, 2)  # folder order is sorted by name, not by label


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


class StubDetector:
    """A fixed table of detections by file name: 0-4 boxes an image, of 1-3
    classes (one of them the folder's label in half the images), with a box
    under a pixel wide, one under a pixel high, and one past the edge.
    Records the files of each call; ``fail_on_call`` raises on that call.
    Like the port's Detector it has ``nms_rounds``, which the CLIs report."""

    def __init__(self, fail_on_call: int = 0):
        self.calls, self.fail_on_call, self.nms_rounds = [], fail_on_call, []

    @staticmethod
    def table(path: str):
        name = os.path.basename(path)
        folder = os.path.basename(os.path.dirname(path))
        rng = np.random.RandomState(sum(map(ord, folder + name)))
        label = int(folder[6:8]) if folder.startswith("label_") else 0
        ids, boxes = [], []
        for j in range(rng.randint(0, 5)):
            x1, y1 = rng.uniform(-4, 40, 2)
            w, h = rng.uniform(2, 40, 2)
            if j == 1:
                w = 0.6
            if j == 2:
                h = 0.3
            ids.append(label if (j == 0 and rng.rand() < 0.5) else int(rng.randint(0, 80)))
            boxes.append(np.asarray([x1, y1, x1 + w, y1 + h], np.float32))
        return name, ([COCO_CLASSES[i] for i in ids], ids, boxes)

    def __call__(self, files):
        self.calls.append(list(files))
        if len(self.calls) == self.fail_on_call:
            raise RuntimeError("the card was lost")
        return {f: self.table(f)[1] for f in files}


def write_images(folder, n, seed):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)).save(os.path.join(folder, f"img_{i:02d}.png"))


def read_folder(folder):
    out = {}
    for name in sorted(os.listdir(folder)):
        with Image.open(os.path.join(folder, name)) as im:
            out[name] = np.asarray(im)
    return out


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """A source folder of 11 images, and six label folders of 3-5 images."""
    root = tmp_path_factory.mktemp("soa")
    write_images(str(root / "src"), 11, seed=0)
    for j, label in enumerate(LABELS):
        write_images(str(root / "images" / f"label_{label:02d}_{label:02d}"), 3 + j % 3, seed=10 + j)
    return root


def crop_both(layout, tmp_path, slab):
    out = {}
    for tag, crop in (("jax", jcrop.crop_folder), ("port", tcrop.crop_folder)):
        dest = str(tmp_path / tag)
        assert crop(StubDetector(), str(layout / "src"), dest, slab=slab) == len(os.listdir(dest))
        out[tag] = read_folder(dest)
    return out


def test_crops_identical_to_jax(layout, tmp_path):
    out = crop_both(layout, tmp_path, slab=4)
    port, jax_ = out["port"], out["jax"]
    assert sorted(port) == sorted(jax_) and len(port) > 5
    for name in jax_:
        assert np.array_equal(port[name], jax_[name]), name
    stems = {n.rsplit("_", 2)[0] for n in port}
    assert stems <= {f"img_{i:02d}" for i in range(11)}
    counts = sorted(int(n.rsplit("_", 1)[1][:-4]) for n in port)
    assert counts == list(range(len(port)))  # one running index over the folder
    boxes = [b for f in os.listdir(layout / "src") for b in StubDetector.table(str(layout / "src" / f))[1][2]]
    kept = [b for b in boxes if b[2] - b[0] >= 1.0 and b[3] - b[1] >= 1.0]
    assert len(port) == len(kept) < len(boxes)  # the degenerate boxes are skipped


@pytest.mark.parametrize("package", ["jax", "port"])
def test_killed_crop_run_resumes_to_the_same_files(layout, tmp_path, package):
    """A run whose detector fails on its second slab leaves the first slab's
    crops and the sentinel; the rerun resumes at the second slab and ends
    with the straight run's files, and removes the sentinel."""
    crop = {"jax": jcrop.crop_folder, "port": tcrop.crop_folder}[package]
    straight = str(tmp_path / "straight")
    crop(StubDetector(), str(layout / "src"), straight, slab=4)
    dest = str(tmp_path / "resumed")
    with pytest.raises(RuntimeError, match="the card was lost"):
        crop(StubDetector(fail_on_call=2), str(layout / "src"), dest, slab=4)
    assert os.path.exists(os.path.join(dest, ".crop_progress_0.json"))
    again = StubDetector()
    crop(again, str(layout / "src"), dest, slab=4)
    assert [len(c) for c in again.calls] == [4, 3]  # slabs 2 and 3 only
    assert not os.path.exists(os.path.join(dest, ".crop_progress_0.json"))
    want, got = read_folder(straight), read_folder(dest)
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.array_equal(got[name], want[name])


def test_crop_cli_identical_to_jax(layout, tmp_path, monkeypatch):
    monkeypatch.setattr(jpredictor, "make_folder_detector", lambda *a, **k: StubDetector())
    monkeypatch.setattr(predictor, "make_folder_detector", lambda *a, **k: StubDetector())
    argv = ["--source_image_dir", str(layout / "src")]
    jcrop.main(argv + ["--saved_cropped_object_dir", str(tmp_path / "jax")])
    tcrop.main(argv + ["--saved_cropped_object_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "jax"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


def plant_pickles(folder):
    """80 per-label pickles with varying recall and image counts."""
    os.makedirs(folder, exist_ok=True)
    for label in range(80):
        hits, total = label % 10, 10 + (label % 5)
        dets = {f"img{i}.png": [["x"], [label if i < hits else (label + 1) % 80], [np.zeros(4, np.float32)]]
                for i in range(total)}
        jio.save_pickle(os.path.join(folder, f"detected_label_{label:02d}_{label:02d}.pkl"), dets)


def test_soa_on_planted_pickles_byte_identical(tmp_path):
    """calc_soa of both packages on the same pickles: the same result file
    and result_file.pkl, byte for byte; the values as recomputed here."""
    det = str(tmp_path / "det")
    plant_pickles(det)
    written = {}
    for tag, calc in (("jax", jsoa.calc_soa), ("port", tsoa.calc_soa)):
        values = calc(det, str(tmp_path / f"{tag}.txt"))
        written[tag] = (values, (tmp_path / f"{tag}.txt").read_bytes(),
                        open(os.path.join(det, "result_file.pkl"), "rb").read())
    assert written["port"] == written["jax"]
    accs = [(l % 10) / (10 + l % 5) for l in range(80)]
    np.testing.assert_allclose(written["port"][0][0], np.mean(accs), rtol=1e-12)
    assert tio.read_soa_result(str(tmp_path / "port.txt")) == jio.read_soa_result(str(tmp_path / "jax.txt"))


def run_soa_cli(package, layout, out, extra=()):
    main = {"jax": jsoa.main, "port": tsoa.main}[package]
    argv = ["--images", str(layout / "images"), "--detected_results", str(out / "det"),
            "--saved_file", str(out / "soa.txt"), *extra]
    main(argv + (["--device", "cpu"] if package == "port" and "--skip_detection" not in extra else []))


def soa_files(out):
    det = out / "det"
    return {name: (det / name).read_bytes() for name in sorted(os.listdir(det))}, (out / "soa.txt").read_bytes()


def test_soa_cli_identical_to_jax_with_resume_and_skip(layout, tmp_path, monkeypatch):
    """Both SOA CLIs with the stub detector: the same pickles and result
    file bytes.  Then, with two labels' pickles removed, a rerun detects
    those two folders only, in both packages, and gives the same bytes;
    ``--skip_detection`` runs no detector and gives them again."""
    stubs = {"jax": StubDetector(), "port": StubDetector()}
    monkeypatch.setattr(jpredictor, "make_folder_detector", lambda *a, **k: stubs["jax"])
    monkeypatch.setattr(predictor, "make_folder_detector", lambda *a, **k: stubs["port"])
    first = {}
    for package in ("jax", "port"):
        run_soa_cli(package, layout, tmp_path / package)
        first[package] = soa_files(tmp_path / package)
        assert len(stubs[package].calls) == len(LABELS)
    assert first["port"] == first["jax"]
    for package in ("jax", "port"):
        stubs[package].calls.clear()
        for label in (15, 79):
            os.remove(tmp_path / package / "det" / f"detected_label_{label:02d}_{label:02d}.pkl")
        run_soa_cli(package, layout, tmp_path / package)
        assert [os.path.basename(os.path.dirname(c[0])) for c in stubs[package].calls] == [
            "label_15_15", "label_79_79"]
        assert soa_files(tmp_path / package) == first["jax"]
        stubs[package].calls.clear()
        (tmp_path / package / "soa.txt").unlink()
        run_soa_cli(package, layout, tmp_path / package, ["--skip_detection"])
        assert not stubs[package].calls and soa_files(tmp_path / package) == first["jax"]


def test_cli_defaults_and_device(layout, tmp_path, monkeypatch):
    """The detector is built at 800 px, 1,000 proposals and ROIAlign
    sampling 2 in f32 unless asked otherwise; ``--device`` defaults to the
    card, and a run without one raises instead of falling back to the CPU."""
    seen = []

    def record_build(weights, **kwargs):
        seen.append(kwargs)
        return StubDetector()

    monkeypatch.setattr(predictor, "make_folder_detector", record_build)
    run_soa_cli("port", layout, tmp_path / "a")
    assert seen[-1] == {"aspect_resize": False, "precision": "highest", "roi_sampling": 2, "proposals": 1000,
                        "device": torch.device("cpu")}
    assert inspect.signature(predictor.Detector).parameters["input_size"].default == predictor.INPUT_SIZE == 800
    tcrop.main(["--source_image_dir", str(layout / "src"), "--saved_cropped_object_dir", str(tmp_path / "c"),
                "--device", "cpu", "--precision", "fast", "--roi-sampling", "1", "--proposals", "256"])
    assert seen[-1]["precision"] == "fast" and seen[-1]["roi_sampling"] == 1 and seen[-1]["proposals"] == 256
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsoa.main(["--images", str(layout / "images"), "--detected_results", str(tmp_path / "b")])


def test_soa_result_reader(tmp_path):
    """read_soa_result reads what write_soa_result wrote (to the file's four
    decimals) and raises a ValueError naming the file where numbers are
    missing."""
    path = str(tmp_path / "soa.txt")
    tio.write_soa_result(path, 0.123456, 0.5, 0.98765, 0.0)
    assert tio.read_soa_result(path) == (0.1235, 0.5, 0.9877, 0.0)
    assert open(path).read() == (
        "Class average accuracy for all classes (SOA-C) is: 0.1235 \n"
        "Image weighted average accuracy (SOA-I) is: 0.5000 \n"
        "Top (SOA-C-Top40) and Bottom (SOA-C-Bot40) 40 class average accuracy is: 0.9877 and 0.0000")
    tio.write_soa_result(path, float("nan"), 0.5, float("nan"), 0.25)
    with pytest.raises(ValueError, match="soa.txt holds 2 of the 4 numbers"):
        tio.read_soa_result(path)
    open(path, "w").close()
    with pytest.raises(ValueError, match="holds 0 of the 4"):
        tio.read_soa_result(path)
