"""
The port's file entry points, folding and JSON serialization against
the JAX package's, on the CPU.

* PRESTO .inf/.dat pairs and SIGPROC time series (32-bit, 8-bit signed
  and unsigned) written by tests/synth.py read through both packages'
  ``TimeSeries`` loaders give equal arrays and metadata; the port's
  SIGPROC reads take its native ``read_f32`` / ``decode8``.
* Truncated, empty and odd-length files under the ``strict`` /
  ``salvage`` / ``skip`` ingest policies give the same outcome in both
  packages (the same error type, None, or the same salvaged prefix),
  and the port counts salvaged and skipped files.
* ``TimeSeries.fold`` equals the reference's for a few (period, bins,
  subints).
* A JSON written by the JAX package's ``save_json`` loads in the port
  with equal data, and the port's own round trip gives equal data.
"""
import os
import warnings

import numpy as np
import pytest

import riptide_tpu as ref
from riptide_tpu.utils.coords import SkyCoord as RefSkyCoord
from synth import write_presto, write_sigproc

import riptide_tpu_torch as port
from riptide_tpu_torch import native, quality
from riptide_tpu_torch.survey.metrics import (MetricsRegistry, get_metrics,
                                              set_metrics)
from riptide_tpu_torch.utils.coords import SkyCoord

TSAMP = 256e-6


def _series(n=4096, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _outcome(load, *args, **kwargs):
    """What a loader does with a file: ("raise", error type name),
    ("none",) or ("data", samples, tsamp, metadata without fname)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            ts = load(*args, **kwargs)
        except (ValueError, KeyError, OSError) as err:
            return ("raise", type(err).__name__)
    if ts is None:
        return ("none",)
    return ("data", ts.data, ts.tsamp, _meta(ts.metadata))


def _meta(md):
    out = {}
    for k, v in md.items():
        if isinstance(v, (SkyCoord, RefSkyCoord)):
            v = (v.ra_deg, v.dec_deg)
        out[k] = v
    return out


def _assert_same(got, want):
    assert got[0] == want[0], (got, want)
    if got[0] == "raise":
        assert got[1] == want[1]
    elif got[0] == "data":
        assert got[1].dtype == want[1].dtype == np.float32
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        assert got[3] == want[3]


def _both(name, *args, **kwargs):
    return (_outcome(getattr(port.TimeSeries, name), *args, **kwargs),
            _outcome(getattr(ref.TimeSeries, name), *args, **kwargs))


@pytest.mark.parametrize("dm", [0.0, 12.5])
def test_presto_reads_match(tmp_path, dm):
    data = _series()
    inf = write_presto(str(tmp_path), "ts", data, TSAMP, dm=dm)
    got, want = _both("from_presto_inf", inf)
    _assert_same(got, want)
    np.testing.assert_array_equal(got[1], data)
    assert got[3]["dm"] == dm and got[3]["fname"] == os.path.realpath(inf)


def test_presto_header_matches(tmp_path):
    from riptide_tpu.reading import PrestoInf as RefInf
    from riptide_tpu_torch.reading import PrestoInf

    inf = write_presto(str(tmp_path), "brk", _series(64), TSAMP,
                       onoff_pairs=[(0, 10), (20, 63)])
    assert dict(PrestoInf(inf)) == dict(RefInf(inf))
    assert PrestoInf(inf).data_fname == RefInf(inf).data_fname


@pytest.mark.parametrize("nbits,signed", [(32, None), (8, True),
                                          (8, False)])
def test_sigproc_reads_match(tmp_path, nbits, signed):
    assert native.available()
    data = _series()
    if nbits == 8:
        data = np.clip(np.rint(data * 20 + (0 if signed else 128)),
                       -128 if signed else 0, 127 if signed else 255)
    path = write_sigproc(str(tmp_path / "ts.tim"), data, TSAMP, nbits=nbits,
                         signed=signed, refdm=3.0)
    got, want = _both("from_sigproc", path)
    _assert_same(got, want)
    np.testing.assert_array_equal(got[1], data.astype(np.float32))
    assert got[3]["dm"] == 3.0


def test_sigproc_without_signed_key_refused_alike(tmp_path):
    path = write_sigproc(str(tmp_path / "u.tim"), np.zeros(16), TSAMP,
                         nbits=8, signed=None)
    got, want = _both("from_sigproc", path)
    _assert_same(got, want)
    assert got[0] == "raise"


def test_native_readers_match_numpy(tmp_path):
    raw = np.arange(-128, 128, dtype=np.int8).tobytes()
    np.testing.assert_array_equal(
        native.decode8(raw, signed=True),
        np.frombuffer(raw, np.int8).astype(np.float32))
    np.testing.assert_array_equal(
        native.decode8(raw, signed=False),
        np.frombuffer(raw, np.uint8).astype(np.float32))
    path = tmp_path / "x.bin"
    data = _series(100)
    path.write_bytes(b"\0" * 12 + data.tobytes())
    np.testing.assert_array_equal(native.read_f32(str(path), 12, 100), data)
    with pytest.raises(OSError):
        native.read_f32(str(path), 12, 101)


def _truncated(tmp_path, kind):
    """A damaged file of ``kind``; returns (loader name, args)."""
    data = np.arange(64, dtype=np.float32)
    d = str(tmp_path)
    if kind == "presto-truncated":
        inf = write_presto(d, "t", data, TSAMP)
        with open(os.path.join(d, "t.dat"), "r+b") as f:
            f.truncate(16 * 4 + 2)
        return "from_presto_inf", (inf,)
    if kind == "presto-empty":
        inf = write_presto(d, "e", data, TSAMP)
        open(os.path.join(d, "e.dat"), "wb").close()
        return "from_presto_inf", (inf,)
    if kind == "presto-header":
        inf = write_presto(d, "h", data, TSAMP)
        with open(inf) as f:
            head = f.read().splitlines()[:6]
        with open(inf, "w") as f:
            f.write("\n".join(head))
        return "from_presto_inf", (inf,)
    if kind == "sigproc-odd":
        path = write_sigproc(os.path.join(d, "o.tim"), data, TSAMP)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 4 * 16 - 2)
        return "from_sigproc", (path,)
    if kind == "sigproc-empty":
        path = write_sigproc(os.path.join(d, "z.tim"), data[:0], TSAMP)
        return "from_sigproc", (path,)
    if kind == "binary-odd":
        path = os.path.join(d, "odd.bin")
        with open(path, "wb") as f:
            f.write(data[:8].tobytes() + b"\x01\x02")
        return "from_binary", (path, TSAMP)
    if kind == "binary-empty":
        path = os.path.join(d, "empty.bin")
        open(path, "wb").close()
        return "from_binary", (path, TSAMP)
    path = os.path.join(d, "bad.npy")
    with open(path, "wb") as f:
        f.write(b"\x93NUMPY garbage")
    return "from_npy_file", (path, TSAMP)


KINDS = ("presto-truncated", "presto-empty", "presto-header", "sigproc-odd",
         "sigproc-empty", "binary-odd", "binary-empty", "npy-bad")


@pytest.mark.parametrize("policy", quality.INGEST_POLICIES)
@pytest.mark.parametrize("kind", KINDS)
def test_damaged_files_same_outcome(tmp_path, kind, policy):
    name, args = _truncated(tmp_path, kind)
    prev = set_metrics(MetricsRegistry())
    try:
        got, want = _both(name, *args, policy=policy)
        counts = {k: get_metrics().counter(k)
                  for k in ("files_salvaged", "files_skipped")}
    finally:
        set_metrics(prev)
    _assert_same(got, want)
    if policy == "strict":
        assert got[0] == "raise"
    salvaged = int(got[0] == "data")
    skipped = int(got[0] == "none")
    assert counts == {"files_salvaged": salvaged, "files_skipped": skipped}


def test_strict_raises_malformed_file(tmp_path):
    name, args = _truncated(tmp_path, "binary-odd")
    with pytest.raises(port.MalformedFile, match="not a multiple"):
        getattr(port.TimeSeries, name)(*args)
    with pytest.raises(ValueError, match="ingest policy"):
        getattr(port.TimeSeries, name)(*args, policy="lenient")


def test_npy_file_reads_match(tmp_path):
    path = str(tmp_path / "x.npy")
    np.save(path, _series(333))
    _assert_same(*_both("from_npy_file", path, TSAMP))


@pytest.mark.parametrize("period,bins,subints", [
    (1.0, 100, None), (1.0, 100, 1), (1.0, 100, 2), (0.7071, 64, 5),
    (0.33, 50, 30)])
def test_fold_matches_reference(period, bins, subints):
    data = _series(10000, seed=7)
    got = port.TimeSeries(data, 0.001).fold(period, bins, subints=subints)
    want = ref.TimeSeries(data, 0.001).fold(period, bins, subints=subints)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_fold_refusals_match():
    ts = port.TimeSeries(_series(10000), 0.001)
    for args in ((20.0, 100), (0.05, 100), (1.0, 100, 11)):
        with pytest.raises(ValueError):
            ts.fold(*args)


def _series_object(pkg, coords):
    np.random.seed(4)
    ts = pkg.TimeSeries.generate(length=0.5, tsamp=0.001, period=0.1,
                                 amplitude=5.0)
    ts.metadata["skycoord"] = coords(12.3, -45.6)
    ts.metadata["dm"] = 7.5
    return ts


def test_reference_json_loads_in_port(tmp_path):
    path = str(tmp_path / "ts.json")
    ts = _series_object(ref, RefSkyCoord)
    ref.save_json(path, ts)
    loaded = port.load_json(path)
    assert isinstance(loaded, port.TimeSeries)
    np.testing.assert_array_equal(loaded.data, ts.data)
    assert loaded.tsamp == ts.tsamp
    assert _meta(loaded.metadata) == _meta(ts.metadata)
    assert loaded.version == ref.__version__


def test_port_json_round_trip(tmp_path):
    path = str(tmp_path / "ts.json")
    ts = _series_object(port, SkyCoord)
    port.save_json(path, ts)
    loaded = port.load_json(path)
    np.testing.assert_array_equal(loaded.data, ts.data)
    assert loaded.tsamp == ts.tsamp
    assert loaded.metadata == ts.metadata
    assert loaded.version == port.__version__
    # The JAX package reads the port's file alike.
    back = ref.load_json(path)
    np.testing.assert_array_equal(back.data, ts.data)
    assert _meta(back.metadata) == _meta(ts.metadata)


def test_periodogram_json_round_trip(tmp_path):
    from riptide_tpu_torch import Periodogram

    rng = np.random.default_rng(2)
    pg = Periodogram((1, 2), np.linspace(1, 2, 5), np.arange(5, dtype=np.uint32),
                     rng.standard_normal((5, 2)).astype(np.float32),
                     metadata=port.Metadata({"dm": 1.0}))
    path = str(tmp_path / "pg.json")
    port.save_json(path, pg)
    loaded = port.load_json(path)
    np.testing.assert_array_equal(loaded.snrs, pg.snrs)
    np.testing.assert_array_equal(loaded.periods, pg.periods)
    np.testing.assert_array_equal(loaded.widths, pg.widths)
