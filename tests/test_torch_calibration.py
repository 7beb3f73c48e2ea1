"""The port's calibration and download layers
(tise_tpu_torch.calibration.{temperature,plots,cli}, tise_tpu_torch.core.download)
against the JAX package's on the CPU.

Logits are seeded with a planted temperature (labels drawn from the softmax
of the logits, the logits then divided by t*, so the fit finds 1/t*): the
fitted T is held within 5e-5 relative of the float64 optimum (the JAX fit,
whose f32 objective stops it up to 2.9e-4 away, within 5e-4); ECE and the per-bin
table equal JAX's; the CLI prints JAX's lines with T compared as a float.
The download layer runs with its fetchers stubbed: no test reaches the
network.
"""

import io
import os
import zipfile
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from tise_tpu.calibration import cli as jcli
from tise_tpu.calibration import temperature as jtemp
from tise_tpu.core import download as jdownload
from tise_tpu_torch.calibration import cli as tcli
from tise_tpu_torch.calibration import plots as tplots
from tise_tpu_torch.calibration import temperature as ttemp
from tise_tpu_torch.core import download as tdownload


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


def planted(t_star, n=2000, k=10, seed=0):
    rng = np.random.RandomState(seed)
    base = rng.standard_normal((n, k)) * 2.0
    p = np.exp(base - base.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    labels = np.array([rng.choice(k, p=row) for row in p])
    return (base / t_star).astype(np.float32), labels


def optimum(logits, labels):
    """T minimising the NLL in float64 (a scalar search to 1e-12)."""
    from scipy.optimize import minimize_scalar

    x, y = torch.from_numpy(logits.astype(np.float64)), torch.from_numpy(labels)
    res = minimize_scalar(lambda v: float(torch.nn.functional.cross_entropy(x / np.exp(v), y)),
                          bracket=(-2.0, 2.0), tol=1e-12)
    return float(np.exp(res.x))


def near_optimum(t_port, t_jax, t_opt):
    """The port's fit within 5e-5 relative of the float64 optimum, the JAX
    fit within 5e-4 of it.  Closer agreement of the two fits is not there to
    hold: L-BFGS-B stops once the f32 NLL no longer falls (FACTR), which on
    these logits leaves the JAX fit up to 2.9e-4 from the optimum with its
    f32 gradient still that large, and either fit's last steps follow the
    last bits of its own f32 sums."""
    return abs(t_port - t_opt) <= 5e-5 * t_opt and abs(t_jax - t_opt) <= 5e-4 * t_opt


@pytest.mark.parametrize("t_star", [0.5, 1.0, 2.5])
def test_fit_matches_jax(t_star):
    logits, labels = planted(t_star)
    t_port = ttemp.fit_temperature(logits, labels, device="cpu")
    t_jax = jtemp.fit_temperature(logits, labels)
    t_opt = optimum(logits, labels)
    assert near_optimum(t_port, t_jax, t_opt), (t_port, t_jax, t_opt)
    assert abs(t_port - 1.0 / t_star) < 0.1 / t_star  # the planted temperature is found


@pytest.mark.parametrize("temperature", [1.0, 1.7])
def test_ece_and_table_equal_jax(temperature):
    logits, labels = planted(1.7, seed=1)
    assert ttemp.ece(logits, labels, 15, temperature) == jtemp.ece(logits, labels, 15, temperature)
    for got, want in zip(ttemp.reliability_diagram(logits, labels, 15, temperature),
                         jtemp.reliability_diagram(logits, labels, 15, temperature)):
        assert np.array_equal(got, want)


def test_report_matches_jax():
    logits, labels = planted(2.0, seed=2)
    got = ttemp.calibration_report(logits, labels, device="cpu")
    want = jtemp.calibration_report(logits, labels)
    assert near_optimum(got[0], want[0], optimum(logits, labels))
    # before: the same numbers; after: JAX's NLL and ECE at the port's T
    nll_after = float(jtemp.nll(jnp.asarray(np.log(got[0]), jnp.float32), jnp.asarray(logits),
                                jnp.asarray(labels, jnp.int32)))
    np.testing.assert_allclose([got[1], got[3]], [want[1], nll_after], rtol=1e-6)
    assert got[2] == want[2] and got[4] == jtemp.ece(logits, labels, 15, temperature=got[0])
    assert got[3] < got[1]  # the fit lowers the NLL


def _lines(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


def test_cli_prints_jax_lines(tmp_path):
    logits, labels = planted(0.6, seed=3)
    path = str(tmp_path / "val.npz")
    np.savez(path, logits=logits, labels=labels)
    got = _lines(tcli.main, ["--validation_npz", path, "--device", "cpu"])
    want = _lines(jcli.main, ["--validation_npz", path])
    assert len(got) == len(want) == 3 + 2 * 18
    t_opt = optimum(logits, labels)
    for a, b in zip(got, want):
        if "after calibration, T=" in b or b.startswith("Optimal temperature: "):
            # T compared as a float
            (ha, ta), (hb, tb) = (line.replace("T=", ": ").rstrip("):").rsplit(": ", 1) for line in (a, b))
            assert ha == hb and near_optimum(float(ta), float(tb), t_opt), (a, b)
        else:
            assert a == b


def test_cli_without_device_raises_where_there_is_no_card(tmp_path):
    path = str(tmp_path / "val.npz")
    np.savez(path, logits=np.zeros((4, 3), np.float32), labels=np.zeros(4, np.int64))
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.main(["--validation_npz", path])


def test_png_written_on_the_cpu(tmp_path):
    pytest.importorskip("matplotlib")
    logits, labels = planted(1.3, seed=4)
    path = str(tmp_path / "val.npz")
    np.savez(path, features=logits, targets=labels)  # another key spelling
    lines = _lines(tcli.main, ["--validation_npz", path, "--plot_prefix", str(tmp_path / "rel"), "--device", "cpu"])
    for tag in ("before", "after"):
        png = tmp_path / f"rel_{tag}.png"
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and f"wrote {png}" in lines


def test_ascii_table_is_jax_copy():
    from tise_tpu.calibration import plots as jplots

    conf, acc, frac = np.linspace(0.05, 0.95, 10), np.linspace(0.0, 0.9, 10), np.full(10, 0.1)
    assert tplots.ascii_reliability(conf, acc, frac) == jplots.ascii_reliability(conf, acc, frac)


# ---------------------------------------------------------------------------
# download, with the fetchers stubbed
# ---------------------------------------------------------------------------


def test_manifest_is_jax_copy():
    assert tdownload.BUNDLES == jdownload.BUNDLES


def test_skip_existing(tmp_path, capsys):
    dest = tmp_path / "file.zip"
    dest.write_bytes(b"x")
    assert tdownload.fetch_and_unzip("fake_id", str(dest)) == str(dest)
    assert "skipping" in capsys.readouterr().out and dest.read_bytes() == b"x"


def _zip_bytes():
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("inner/a.txt", "alpha")
    return buf.getvalue()


@pytest.mark.parametrize("src", ["drive_id", "https://example.invalid/x.zip"])
def test_fetch_unzips_in_place(tmp_path, monkeypatch, src):
    calls = []

    def fake(source, dest):
        calls.append(source)
        with open(dest, "wb") as f:
            f.write(_zip_bytes())
        return dest

    monkeypatch.setattr(tdownload, "download_from_google_drive", fake)
    monkeypatch.setattr(tdownload, "download_http", fake)
    dest = tmp_path / "sub" / "x.zip"
    os.makedirs(dest.parent)
    tdownload.fetch_and_unzip(src, str(dest))
    assert calls == [src] and (tmp_path / "sub" / "inner" / "a.txt").read_text() == "alpha"


def test_main_fetches_a_bundle_and_a_file_id(tmp_path, monkeypatch, capsys):
    fetched = []

    def fake(source, dest):
        fetched.append((source, os.path.relpath(dest, tmp_path)))
        with open(dest, "wb") as f:
            f.write(_zip_bytes() if dest.endswith(".zip") else b"payload")
        return dest

    monkeypatch.setattr(tdownload, "download_from_google_drive", fake)
    monkeypatch.setattr(tdownload, "download_http", fake)
    os.makedirs(tmp_path / "classifier_calibration" / "data")
    tdownload.main(["--bundle", "calibration_data", "--dest", str(tmp_path)])
    want = [(src, name) for name, src in tdownload.BUNDLES["calibration_data"].items()]
    assert fetched == want
    tdownload.main(["--file_id", "some_id", "--dest", str(tmp_path)])
    assert (tmp_path / "some_id").read_bytes() == b"payload"
    tdownload.main(["--list", "--bundle", "cub_data"])
    assert "cub_data:" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tdownload.main([])
