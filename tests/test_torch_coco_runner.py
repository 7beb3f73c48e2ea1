"""The port's ranking table (tise_tpu_torch.ranking.ranking_score) and its
COCO track runner (tise_tpu_torch.benchmark --track coco) against the JAX
package's on the CPU.

The table is held byte for byte to the JAX package's pandas + tabulate table
on the 11 published methods of BASELINE.md and on a hypothesis sweep, and
the ranking CLI runs with pandas and tabulate blocked.  Both runners run the
COCO track with every metric CLI's ``main`` stubbed in both packages, over
the placeholder layout of tests/test_benchmark.py, and must agree on the
argv (the port's is JAX's and ``--device cpu``), the order of stages, the
files they write and the skip, gate and stale-upstream cases; one real
``--only ca`` run of both on planted items gives the same CA.
"""

import json
import os
import shutil
import string
import subprocess
import sys
from collections import OrderedDict

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from threadpoolctl import threadpool_limits

from tests.test_torch_ca import make_ca_world
from tise_tpu import benchmark as jbench
from tise_tpu.core import io as jio
from tise_tpu.ranking import ranking_score as jrank
from tise_tpu_torch import benchmark as tbench
from tise_tpu_torch.backbones import counter as tcounter
from tise_tpu_torch.backbones.detection import predictor as tpredictor
from tise_tpu_torch.core import io as tio
from tise_tpu_torch.metrics import crop_objects as tcrop
from tise_tpu_torch.ranking import ranking_score as trank

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP_MAIN = tcrop.main  # the real CLI, before the ``stubbed`` fixture replaces it

#: BASELINE.md:31-42, the reference's COCO table (the golden file's row order)
PUBLISHED = OrderedDict((row[0], row[1:]) for row in [
    ("GAN-CLS", 8.10, 192.09, 10.00, 5.31, 5.71, 2.46, 51.13, 2.51, 32.79),
    ("StackGAN", 15.50, 53.44, 9.10, 9.24, 9.90, 3.36, 29.09, 2.41, 34.33),
    ("AttnGAN", 33.79, 36.90, 50.56, 47.13, 49.78, 5.04, 20.92, 1.82, 40.08),
    ("DM-GAN", 45.63, 28.96, 66.98, 55.77, 58.11, 5.22, 17.48, 1.71, 42.83),
    ("CPGAN", 59.64, 50.68, 69.08, 81.86, 83.83, 6.38, 20.07, 2.07, 43.28),
    ("DF-GAN", 30.45, 21.05, 42.44, 37.85, 40.19, 5.12, 14.39, 1.96, 40.39),
    ("AttnGAN + CL", 36.85, 26.93, 57.52, 47.45, 49.33, 4.92, 19.92, 1.72, 43.92),
    ("DM-GAN + CL", 46.61, 22.60, 70.36, 58.68, 61.05, 5.09, 15.50, 1.66, 49.06),
    ("DALLE-Mini", 19.82, 62.90, 48.72, 26.64, 27.90, 4.10, 23.83, 2.31, 47.39),
    ("AttnGAN++", 54.63, 26.58, 72.48, 67.83, 69.97, 6.01, 15.43, 1.57, 47.75),
    ("Real-Images", 51.25, 2.62, 83.54, 90.02, 91.19, 8.63, 0.00, 1.05, 100.0),
])
PUBLISHED_RS = {"GAN-CLS": 7.0, "StackGAN": 11.5, "AttnGAN": 29.0, "DM-GAN": 41.0, "CPGAN": 43.0, "DF-GAN": 31.5,
                "AttnGAN + CL": 37.0, "DM-GAN + CL": 51.5, "DALLE-Mini": 23.5, "AttnGAN++": 56.0,
                "Real-Images": 65.0}


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


def write_methods(root, scores) -> str:
    os.makedirs(root, exist_ok=True)
    for name, vals in scores.items():
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(dict(zip(trank.METRICS, vals)), f)
    return str(root)


# ---------------------------------------------------------------------------
# the ranking table
# ---------------------------------------------------------------------------


def test_table_byte_identical_to_jax_on_the_published_methods(tmp_path):
    methods = write_methods(tmp_path / "methods", PUBLISHED)
    order = list(PUBLISHED)
    want = jrank.render_table(jrank.load_method_scores(methods, order=order))
    got = trank.render_table(trank.load_method_scores(methods, order=order))
    assert got == want
    assert got.splitlines()[3] == ("| GAN-CLS      |  8.1  | 192.09 | 10    |    5.31 |    5.71 |   2.46 |   51.13 "
                                   "| 2.51 |  32.79 |  7   |")
    assert trank.render_table(trank.load_method_scores(methods)) == jrank.render_table(
        jrank.load_method_scores(methods))  # sorted names when no order is given


def test_rs_column_gives_the_published_values():
    rs = trank.ranking_scores(np.array(list(PUBLISHED.values())))
    assert dict(zip(PUBLISHED, rs.tolist())) == PUBLISHED_RS
    assert np.array_equal(trank.metric_ranks(np.array(list(PUBLISHED.values()))),
                          jrank.metric_ranks(np.array(list(PUBLISHED.values()))))


_NAMES = st.text(alphabet=string.ascii_letters + " +-", max_size=12).map(lambda t: "M" + t)
_VALUES = st.one_of(st.integers(-500, 20000).map(lambda v: v / 100), st.sampled_from([0.0, 1.0, 7.5, 100.0, 1e6]))


@settings(max_examples=50, deadline=None, database=None)
@given(st.integers(2, 12).flatmap(lambda n: st.tuples(
    st.lists(_NAMES, min_size=n, max_size=n, unique=True),
    st.lists(st.lists(_VALUES, min_size=len(trank.METRICS), max_size=len(trank.METRICS)), min_size=n, max_size=n),
    st.lists(st.integers(0, n - 1), min_size=n, max_size=n))))
def test_table_byte_identical_to_jax_on_a_sweep(case):
    """2-12 methods of 2-decimal values (some whole, some from a small pool
    so that they tie, a row copied from another to tie whole columns)."""
    names, rows, copy_from = case
    rows = [list(rows[j]) if j < i and j % 3 == 0 else row for i, (row, j) in enumerate(zip(rows, copy_from))]
    scores = OrderedDict(zip(names, rows))
    assert trank.render_table(scores) == jrank.render_table(scores)


def test_ranking_cli_runs_without_pandas_and_tabulate(tmp_path):
    methods = write_methods(tmp_path / "methods", PUBLISHED)
    out = tmp_path / "results" / "table.txt"
    code = ("import sys\n"
            "sys.modules['pandas'] = sys.modules['tabulate'] = None\n"
            "from tise_tpu_torch.ranking import ranking_score\n"
            f"ranking_score.main(['--methods_dir', {methods!r}, '--output', {str(out)!r}, "
            f"'--order', {','.join(PUBLISHED)!r}])\n"
            "assert sys.modules['pandas'] is None and sys.modules['tabulate'] is None\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120, capture_output=True)
    with open(out) as f:
        assert f.read() == jrank.render_table(jrank.load_method_scores(methods, order=list(PUBLISHED)))


# ---------------------------------------------------------------------------
# the COCO track runner, stubbed
# ---------------------------------------------------------------------------

STAGES = ["fid", "is_star", "rp", "soa", "pa", "ca", "crop", "o_is", "o_fid"]


def _flag(argv, name):
    return argv[argv.index(name) + 1]


@pytest.fixture
def stubbed(tmp_path, monkeypatch):
    """tests/test_benchmark.py's world: placeholder files for every DATA and
    WEIGHTS entry, three image dirs, and the nine metric CLIs stubbed in both
    packages, each recording (package, stage, argv) and writing its result
    with its package's writers."""
    data, weights = tmp_path / "data", tmp_path / "weights"
    assert tbench.DATA == jbench.DATA and tbench.WEIGHTS == jbench.WEIGHTS
    for root, table in ((data, tbench.DATA), (weights, tbench.WEIGHTS)):
        for rel in table.values():
            os.makedirs((root / rel).parent, exist_ok=True)
            (root / rel).write_bytes(b"x")
    for d in ("gen", "soa_gen", "pa_gen"):
        (tmp_path / d).mkdir()
    calls = []

    def results(io):
        return {"fid": lambda a: io.write_fid_result(_flag(a, "--saved_file"), 26.581254),
                "is_star": lambda a: io.write_is_coco_result(_flag(a, "--saved_file"), 54.62964, 1.53601),
                "rp": lambda a: io.write_rp_coco_result(_flag(a, "--saved_file_path"), 0.7248, 0.0251),
                "soa": lambda a: io.write_soa_result(_flag(a, "--saved_file"), 0.6783, 0.6997, 0.7530, 0.6036),
                "pa": lambda a: io.write_pa_result(_flag(a, "--saved_file_path"), 0.477536),
                "ca": lambda a: io.write_ca_result(_flag(a, "--result_file"), 1.57),
                "crop": lambda a: os.makedirs(_flag(a, "--saved_cropped_object_dir"), exist_ok=True),
                "o_is": lambda a: io.write_o_is_result(_flag(a, "--saved_file"), 6.01, 0.2),
                "o_fid": lambda a: io.write_fid_result(_flag(a, "--saved_file"), 15.43)}

    def stub(package, name, write):
        def run(argv):
            calls.append((package, name, list(argv)))
            write(argv)
        return run

    modules = ("fid", "is_star", "rp_coco", "soa", "pa", "ca", "crop_objects", "o_is", "o_fid")
    for package, prefix, io in (("jax", "tise_tpu.metrics.", jio), ("torch", "tise_tpu_torch.metrics.", tio)):
        writers = results(io)
        for stage, module in zip(STAGES, modules):
            __import__(prefix + module)
            monkeypatch.setattr(sys.modules[prefix + module], "main", stub(package, stage, writers[stage]))
    argv = ["--track", "coco", "--method_name", "MyModel", "--images", str(tmp_path / "gen"),
            "--soa_images", str(tmp_path / "soa_gen"), "--pa_images", str(tmp_path / "pa_gen"),
            "--data_root", str(data), "--weights_root", str(weights), "--output_root", str(tmp_path / "results")]
    return {"root": tmp_path, "argv": argv, "calls": calls, "weights": weights,
            "out": tmp_path / "results" / "MyModel", "methods": tmp_path / "published"}


def _run_both(stubbed, extra=(), fresh=True):
    """The JAX runner, then the port's, each over the same output root (so
    that the argv carry the same paths): returns, per package, its values,
    its calls and the bytes of every file it wrote under the root."""
    out = {}
    for package, runner, device in (("jax", jbench, []), ("torch", tbench, ["--device", "cpu"])):
        results = stubbed["root"] / "results"
        if fresh:
            shutil.rmtree(results, ignore_errors=True)
        shutil.rmtree(stubbed["methods"], ignore_errors=True)
        write_methods(stubbed["methods"], PUBLISHED)
        stubbed["calls"].clear()
        values = runner.main(stubbed["argv"] + ["--methods_dir", str(stubbed["methods"])] + list(extra) + device)
        files = {}
        for base in (results, stubbed["methods"]):
            for dirpath, _, names in os.walk(base):
                for name in names:
                    if name != "timings.json":  # wall-clocks
                        with open(os.path.join(dirpath, name), "rb") as f:
                            files[os.path.relpath(os.path.join(dirpath, name), stubbed["root"])] = f.read()
        out[package] = {"values": values, "calls": [c[1:] for c in stubbed["calls"]], "files": files}
        if fresh:
            os.rename(results, stubbed["root"] / f"results_{package}")
    return out


@pytest.mark.parametrize("extra", [[], ["--batch_size", "4", "--precision", "fast", "--roi-sampling", "1",
                                        "--proposals", "256"]])
def test_runner_gives_the_jax_runners_argv_order_and_files(stubbed, extra):
    """All nine stages in the JAX runner's order, each argv JAX's and
    ``--device cpu``; metrics.json, run_config.json, the methods JSON and
    the ranking table (the new method among the 11 published ones) equal
    byte for byte."""
    both = _run_both(stubbed, extra)
    jax_run, port = both["jax"], both["torch"]
    assert [n for n, _ in port["calls"]] == [n for n, _ in jax_run["calls"]] == STAGES
    for (name, jargv), (_, targv) in zip(jax_run["calls"], port["calls"]):
        assert targv == jargv + ["--device", "cpu"], name
    assert port["values"] == jax_run["values"] and len(port["values"]) == 9
    assert port["files"] == jax_run["files"]
    names = {os.path.basename(k) for k in port["files"]}
    assert {"metrics.json", "run_config.json", "MyModel.json", "benchmark_results.txt", "crop.done"} <= names
    table = port["files"][os.path.join("results", "benchmark_results.txt")].decode()
    assert len(table.splitlines()) == 12 + 4 and "| MyModel " in table
    with open(stubbed["root"] / "results_torch" / "MyModel" / "run_config.json") as f:
        config = json.load(f)
    assert config == {"track": "coco", "precision": "fast" if extra else "highest",
                      "roi_sampling": 1 if extra else 2, "proposals": 256 if extra else 1000}


def test_runner_skips_ca_and_the_ranking_without_the_counter(stubbed):
    os.remove(stubbed["weights"] / tbench.WEIGHTS["counter"])
    both = _run_both(stubbed)
    assert both["torch"]["files"] == both["jax"]["files"]
    assert "CA" not in both["torch"]["values"] and len(both["torch"]["values"]) == 8
    assert [n for n, _ in both["torch"]["calls"]] == [s for s in STAGES if s != "ca"]
    names = {os.path.basename(k) for k in both["torch"]["files"]}
    assert "MyModel.json" in names and "benchmark_results.txt" not in names


def test_runner_gates_o_is_and_o_fid_on_crop(stubbed, capsys):
    os.remove(stubbed["weights"] / tbench.WEIGHTS["detector_crop"])
    both = _run_both(stubbed)
    assert both["torch"]["files"] == both["jax"]["files"]
    assert [n for n, _ in both["torch"]["calls"]] == ["fid", "is_star", "rp", "soa", "pa", "ca"]
    assert not {"O-IS", "O-FID"} & set(both["torch"]["values"])
    assert capsys.readouterr().out.count("[benchmark] SKIP o_is (needs: crop)") == 2


def test_runner_resume_runs_again_downstream_of_a_stage_that_ran(stubbed):
    """Resumed after ``crop.done`` is lost: crop runs again, and so do O-IS
    and O-FID, whose results exist but were made from the old crops; every
    other stage is parsed.  A ``--resume`` under another ``--proposals`` is
    refused by both runners."""
    both = _run_both(stubbed)
    for package in ("jax", "torch"):
        os.rename(stubbed["root"] / f"results_{package}", stubbed["root"] / "results")
        os.remove(stubbed["out"] / "crop.done")
        runner, device = (jbench, []) if package == "jax" else (tbench, ["--device", "cpu"])
        stubbed["calls"].clear()
        values = runner.main(stubbed["argv"] + ["--methods_dir", str(stubbed["methods"]), "--resume"] + device)
        assert values == both[package]["values"]
        assert [c[1] for c in stubbed["calls"]] == ["crop", "o_is", "o_fid"], package
        with pytest.raises(SystemExit, match="resume refused"):
            runner.main(stubbed["argv"] + ["--resume", "--proposals", "256"] + device)
        with open(stubbed["out"] / "run_config.json") as f:
            assert json.load(f)["proposals"] == 1000
        os.rename(stubbed["root"] / "results", stubbed["root"] / f"results_{package}")


def test_runner_passes_sqrtm_to_fid_and_o_fid_only(stubbed):
    """``--sqrtm eigh`` (a flag of the port's runner only) reaches the FID and
    O-FID stages and no other, each argv otherwise the JAX runner's default
    one; it is recorded in run_config.json, and a ``--resume`` without it is
    refused."""
    jbench.main(stubbed["argv"] + ["--methods_dir", str(stubbed["methods"])])
    jax_calls = [c[1:] for c in stubbed["calls"]]
    shutil.rmtree(stubbed["root"] / "results")
    stubbed["calls"].clear()
    argv = stubbed["argv"] + ["--methods_dir", str(stubbed["methods"]), "--device", "cpu"]
    tbench.main(argv + ["--sqrtm", "eigh"])
    port_calls = [c[1:] for c in stubbed["calls"]]
    assert [n for n, _ in port_calls] == [n for n, _ in jax_calls] == STAGES
    for (name, jargv), (_, targv) in zip(jax_calls, port_calls):
        sq = ["--sqrtm", "eigh"] if name in ("fid", "o_fid") else []
        assert targv == jargv + sq + ["--device", "cpu"], name
    with open(stubbed["out"] / "run_config.json") as f:
        assert json.load(f)["sqrtm"] == "eigh"
    with pytest.raises(SystemExit, match="resume refused"):
        tbench.main(argv + ["--resume"])


def test_runner_resume_parses_every_stage(stubbed):
    both = _run_both(stubbed)
    os.rename(stubbed["root"] / "results_torch", stubbed["root"] / "results")
    again = _run_both(stubbed, ["--resume"], fresh=False)
    assert again["torch"]["calls"] == [] and again["torch"]["values"] == both["torch"]["values"]


class OneBoxDetector:
    """One box of ``class_id`` an image; raises on every call when ``fails``."""

    def __init__(self, class_id, fails=False):
        self.class_id, self.fails, self.nms_rounds = class_id, fails, []

    def __call__(self, files):
        if self.fails:
            raise RuntimeError("the card was lost")
        return {f: (["?"], [self.class_id], [np.asarray([2.0, 2.0, 20.0, 18.0], np.float32)]) for f in files}


def test_runner_crop_afresh_leaves_only_its_own_crops(stubbed, monkeypatch):
    """Two crop runs of the port's runner with detectors of different classes
    leave only the second run's crops, a failed third run leaves no
    ``crop.done``, and its ``--resume`` crops again.  (The JAX runner keeps
    the first run's crops and the stale ``crop.done``.)"""
    from PIL import Image

    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)).save(stubbed["root"] / "gen" / f"g{i}.png")
    (stubbed["out"] / "crops").mkdir(parents=True)
    (stubbed["out"] / "crops" / "notes.txt").write_text("not a crop")
    monkeypatch.setattr(sys.modules["tise_tpu_torch.metrics.crop_objects"], "main", CROP_MAIN)
    argv = stubbed["argv"] + ["--only", "crop", "--device", "cpu"]
    crops = stubbed["out"] / "crops"
    for class_id, name in ((0, "person"), (1, "bicycle")):
        monkeypatch.setattr(tpredictor, "make_folder_detector", lambda *a, c=class_id, **k: OneBoxDetector(c))
        tbench.main(argv)
        assert sorted(os.listdir(crops)) == sorted([f"g{i}_{name}_{i}.png" for i in range(3)] + ["notes.txt"])
        assert (stubbed["out"] / "crop.done").exists()
    monkeypatch.setattr(tpredictor, "make_folder_detector", lambda *a, **k: OneBoxDetector(2, fails=True))
    tbench.main(argv)
    assert not (stubbed["out"] / "crop.done").exists()
    assert os.listdir(crops) == ["notes.txt"]
    monkeypatch.setattr(tpredictor, "make_folder_detector", lambda *a, **k: OneBoxDetector(2))
    tbench.main(argv + ["--resume"])
    assert sorted(os.listdir(crops)) == sorted([f"g{i}_car_{i}.png" for i in range(3)] + ["notes.txt"])
    assert (stubbed["out"] / "crop.done").exists()


# ---------------------------------------------------------------------------
# one real stage
# ---------------------------------------------------------------------------


def test_runner_only_ca_gives_the_jax_runners_ca(tmp_path):
    """``--only ca`` with the real CA CLIs over a layout of 4 planted items."""
    w = make_ca_world(tmp_path, tcounter.random_countseg_state_dict(0), n_items=4)
    data, weights = tmp_path / "data", tmp_path / "weights"
    for base, rel, src in ((data, tbench.DATA["ca_captions"], w["pkl"]),
                           (weights, tbench.WEIGHTS["counter"], w["weights"])):
        os.makedirs((base / rel).parent, exist_ok=True)
        os.link(src, base / rel)
    argv = ["--track", "coco", "--method_name", "m", "--images", w["images"], "--data_root", str(data),
            "--weights_root", str(weights), "--only", "ca", "--batch_size", "4"]
    got = tbench.main(argv + ["--output_root", str(tmp_path / "torch"), "--device", "cpu"])
    want = jbench.main(argv + ["--output_root", str(tmp_path / "jax")])
    assert set(got) == {"CA"} and got == want and np.isfinite(got["CA"]) and got["CA"] > 0
    for root in ("torch", "jax"):
        with open(tmp_path / root / "m" / "ca.txt") as f:
            assert f.read() == f"CA = {got['CA']}"
