"""
The port's rseek (``riptide_tpu_torch.apps.rseek``) against the JAX
package's, on the CPU: the same parser defaults for the flags the port
has, and on PRESTO and SIGPROC (32-bit, 8-bit signed and unsigned)
inputs the same printed peak table, every column the same text but the
S/N, which agrees within rtol 1e-5 (the summation order of the prefix
sum, ROADMAP queue 3). Both run on the uint6 wire, as
``tests/test_torch_peaks.py`` runs them.
"""
import json

import numpy as np
import pytest

import riptide_tpu
from riptide_tpu.apps import rseek as ref_rseek
from riptide_tpu_torch.apps import rseek

from synth import generate_data_presto, write_presto, write_sigproc

TOBS, TSAMP, PERIOD = 128.0, 256e-6, 1.0
SEARCH = ["--Pmin", "0.5", "--Pmax", "2.0", "--bmin", "480", "--bmax", "520"]
SNR_RTOL = 1e-5


@pytest.fixture(autouse=True)
def uint6_wire(monkeypatch):
    monkeypatch.setenv("RIPTIDE_WIRE_DTYPE", "uint6")
    monkeypatch.setenv("RIPTIDE_FFA_PATH", "gather")


def _pulsar():
    np.random.seed(0)
    return riptide_tpu.TimeSeries.generate(TOBS, TSAMP, PERIOD, amplitude=20.0,
                                           ducy=0.02, stdnoise=1.0).data


def _input(kind, tmp_path):
    if kind == "presto":
        return "presto", generate_data_presto(
            tmp_path, "fake_pulsar", tobs=TOBS, tsamp=TSAMP, period=PERIOD,
            dm=0.0, amplitude=20.0, ducy=0.02)
    data = _pulsar()
    if kind == "sigproc32":
        return "sigproc", write_sigproc(tmp_path / "f32.tim", data, TSAMP,
                                        nbits=32)
    q = np.rint(data * 16.0)
    signed = kind == "sigproc8s"
    q = (np.clip(q, -128, 127).astype(np.int8) if signed
         else np.clip(q + 128.0, 0, 255).astype(np.uint8))
    return "sigproc", write_sigproc(tmp_path / f"{kind}.tim", q, TSAMP,
                                    nbits=8, signed=signed)


def _run(mod, fmt, fname, capsys, extra=()):
    argv = ["-f", fmt, *SEARCH, *extra, str(fname)]
    out = mod.run_program(mod.get_parser().parse_args(argv))
    return out, capsys.readouterr().out


@pytest.mark.parametrize("kind", ["presto", "sigproc32", "sigproc8u",
                                  "sigproc8s"])
def test_table_matches_reference(kind, tmp_path, capsys):
    fmt, fname = _input(kind, tmp_path)
    want, want_text = _run(ref_rseek, fmt, fname, capsys)
    got, got_text = _run(rseek, fmt, fname, capsys, ("--device", "cpu"))
    assert want is not None and got is not None
    assert got.columns == list(want.columns)
    for col in got.columns:
        if col == "snr":
            np.testing.assert_allclose(got[col], want[col].values,
                                       rtol=SNR_RTOL)
        else:
            np.testing.assert_array_equal(got[col], want[col].values)
    # The printed table: the same text line for line; the S/N column is
    # last and printed at 0.1, so it agrees as the values do.
    g, w = got_text.splitlines(), want_text.splitlines()
    assert len(g) == len(w) == len(got) + 1
    for gl, wl in zip(g, w):
        assert gl.rsplit(None, 1)[0] == wl.rsplit(None, 1)[0]
        assert len(gl) == len(wl)
    np.testing.assert_allclose([float(x.split()[-1]) for x in g[1:]],
                               [float(x.split()[-1]) for x in w[1:]],
                               atol=0.1 + 1e-9)
    top = got.row(0)
    assert abs(top["freq"] - 1.0 / PERIOD) < 0.1 / TOBS
    assert int(top["width"]) == 13
    assert abs(top["snr"] - 18.5) < 0.15


def test_pure_noise_prints_no_peaks(tmp_path, capsys):
    np.random.seed(42)
    inf = write_presto(tmp_path, "noise",
                       np.random.normal(size=32_000).astype(np.float32), 1e-3)
    argv = ["-f", "presto", "--Pmin", "1.0", "--Pmax", "2.0",
            "--bmin", "240", "--bmax", "260", str(inf)]
    assert ref_rseek.run_program(ref_rseek.get_parser().parse_args(argv)) \
        is None
    want = capsys.readouterr().out
    got_args = rseek.get_parser().parse_args(["--device", "cpu", *argv])
    assert rseek.run_program(got_args) is None
    got = capsys.readouterr().out
    assert "No peaks found above S/N = 7.00" in got
    assert got.splitlines()[-1] == want.splitlines()[-1]


def test_plan_stats_match_reference(tmp_path, capsys):
    fmt, fname = _input("presto", tmp_path)
    _, want = _run(ref_rseek, fmt, fname, capsys, ("--plan-stats",))
    _, got = _run(rseek, fmt, fname, capsys, ("--plan-stats", "--device",
                                                "cpu"))
    assert json.loads(got[got.index("{"):]) == \
        json.loads(want[want.index("{"):])


def test_parser_defaults_match_reference():
    """Every flag of the port's parser but --device has the reference's
    default; the port's flags are a subset of the reference's."""
    argv = ["-f", "presto", "x.inf"]
    got = vars(rseek.get_parser().parse_args(argv))
    want = vars(ref_rseek.get_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert set(got) <= set(want)
    assert got == {k: want[k] for k in got}


def test_profile_dir_writes_a_trace(tmp_path, capsys):
    fmt, fname = _input("presto", tmp_path)
    out, _ = _run(rseek, fmt, fname, capsys,
                  ("--device", "cpu", "--profile-dir", str(tmp_path / "tr")))
    assert out is not None
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
