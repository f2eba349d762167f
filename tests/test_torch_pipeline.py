"""
The port's multi-DM pipeline (``riptide_tpu_torch.pipeline``) against
the JAX package's, on the CPU.

Both packages run configs A and B through their real argparse entry
points on the same three synthetic PRESTO DM trials (DM 0, 10 and 20,
128 s at 256 us, the pulsar brightest at DM 10; ``tests/synth.py``);
the JAX package on the CPU as ``tests/test_pipeline.py`` runs it, the
port with ``--device cpu``. Their products must agree:

* peaks.csv, clusters.csv and candidates.csv row for row, every column
  the same text but the S/N, which agrees within rtol 1e-5 (the
  summation order of the prefix sum, ROADMAP queue 3);
* the candidates' params, member peaks and metadata, and their folded
  subints bit for bit (the de-reddened series are the same bits).

Also held to the JAX package: config validation errors, DM selection,
harmonic tests, peak clusters; and the port's own guarantees: the CSV
bytes are pandas', the products are the same bytes with pandas, PyYAML
and matplotlib blocked, candidate files load in both packages, the
batcher does not deadlock at one loader thread, gives each staging
buffer back once, and an injected OOM bisects to the unthrottled peaks.
"""
import csv
import glob
import json
import os
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pandas
import pytest
import yaml

import riptide_tpu
import riptide_tpu.pipeline as ref_pipeline
import riptide_tpu_torch
import riptide_tpu_torch.pipeline as port_pipeline
from riptide_tpu.peak_detection import Peak as RefPeak
from riptide_tpu.pipeline import peak_cluster as ref_pc
from riptide_tpu_torch.peak_detection import Peak
from riptide_tpu_torch.pipeline import peak_cluster as port_pc
from riptide_tpu_torch.pipeline.batcher import BatchSearcher
from riptide_tpu_torch.search import engine
from riptide_tpu_torch.survey.faults import FaultPlan
from riptide_tpu_torch.survey.metrics import get_metrics

from synth import generate_data_presto

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CONFIGS = {"A": os.path.join(HERE, "pipeline_config_A.yml"),
           "B": os.path.join(HERE, "pipeline_config_B.yml")}
AMPLITUDES = {0.0: 10.0, 10.0: 20.0, 20.0: 10.0}
NOISE = {0.0: 0.0, 10.0: 0.0, 20.0: 0.0}
# Both packages on the uint6 wire (the JAX package's CPU default is the
# float32 wire of its gather path), as tests/test_torch_peaks.py runs them.
WIRE_ENV = {"RIPTIDE_WIRE_DTYPE": "uint6", "RIPTIDE_FFA_PATH": "gather"}
SNR_RTOL = 1e-5
PRODUCTS = ("peaks.csv", "clusters.csv", "candidates.csv")


def make_survey(outdir, amplitudes=AMPLITUDES):
    outdir.mkdir(parents=True, exist_ok=True)
    return [generate_data_presto(str(outdir), f"fake_DM{dm:.2f}", tobs=128.0,
                                 tsamp=256e-6, period=1.0, dm=dm,
                                 amplitude=amp, ducy=0.02)
            for dm, amp in amplitudes.items()]


def run_cli(pkg, config, files, outdir, extra=()):
    outdir.mkdir(parents=True, exist_ok=True)
    argv = ["--config", config, "--outdir", str(outdir),
            "--log-level", "WARNING", *extra, *[str(f) for f in files]]
    pkg.run_program(pkg.get_parser().parse_args(argv))
    return outdir


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Configs A and B through both packages' entry points:
    {(config, "ref" | "port"): output directory, "files": inputs}."""
    root = tmp_path_factory.mktemp("pipeline")
    files = make_survey(root / "data")
    out = {"files": files}
    with pytest.MonkeyPatch.context() as mp:
        for key, value in WIRE_ENV.items():
            mp.setenv(key, value)
        for name, config in CONFIGS.items():
            out[name, "ref"] = run_cli(ref_pipeline, config, files,
                                       root / name / "ref")
            out[name, "port"] = run_cli(port_pipeline, config, files,
                                        root / name / "port",
                                        ("--device", "cpu"))
    return out


def read_csv(path):
    with open(path, newline="") as fobj:
        return list(csv.DictReader(fobj))


def assert_rows_match(ref_rows, port_rows):
    assert len(port_rows) == len(ref_rows) > 0
    for r, p in zip(ref_rows, port_rows):
        assert list(p) == list(r)
        for key in r:
            if key == "snr":
                assert float(p[key]) == pytest.approx(float(r[key]),
                                                      rel=SNR_RTOL)
            else:
                assert p[key] == r[key], key


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("product", PRODUCTS)
def test_csv_products_match_reference(runs, config, product):
    ref = runs[config, "ref"] / product
    port = runs[config, "port"] / product
    assert port.exists() and ref.exists()
    assert_rows_match(read_csv(ref), read_csv(port))


def _meta(md):
    """Metadata as a plain dict, the sky position as its two angles
    (each package has its own SkyCoord class)."""
    out = dict(md)
    sc = out.pop("skycoord", None)
    if sc is not None:
        out["skycoord"] = (sc.ra_deg, sc.dec_deg)
    return out


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_candidates_match_reference(runs, config):
    ref_files = sorted(glob.glob(str(runs[config, "ref"] / "candidate_*.json")))
    port_files = sorted(glob.glob(str(runs[config, "port"] / "candidate_*.json")))
    assert [os.path.basename(f) for f in port_files] == \
        [os.path.basename(f) for f in ref_files]
    assert port_files
    for rf, pf in zip(ref_files, port_files):
        ref = riptide_tpu.load_json(rf)
        port = riptide_tpu_torch.load_json(pf)
        assert set(port.params) == set(ref.params)
        for key, want in ref.params.items():
            if key == "snr":
                assert port.params[key] == pytest.approx(want, rel=SNR_RTOL)
            else:
                assert port.params[key] == want, key
        assert _meta(port.tsmeta) == _meta(ref.tsmeta)
        assert port.peaks.columns == list(ref.peaks.columns)
        pv, rv = port.peaks.values, ref.peaks.values
        snr = port.peaks.columns.index("snr")
        np.testing.assert_array_equal(np.delete(pv, snr, 1),
                                      np.delete(rv, snr, 1))
        np.testing.assert_allclose(pv[:, snr], rv[:, snr], rtol=SNR_RTOL)
        assert port.subints.shape == ref.subints.shape
        np.testing.assert_array_equal(port.subints, ref.subints)
        dms, snrs = port.dm_curve
        rdms, rsnrs = ref.dm_curve
        np.testing.assert_array_equal(dms, rdms)
        np.testing.assert_allclose(snrs, rsnrs, rtol=SNR_RTOL)


def test_config_a_finds_the_pulsar(runs):
    """The reference's deterministic oracle
    (riptide/tests/test_pipeline.py:64-74) on the port's products."""
    cand = riptide_tpu_torch.load_json(
        str(runs["A", "port"] / "candidate_0000.json"))
    assert abs(cand.params["period"] - 1.0) < 0.1 / 128.0
    assert cand.params["dm"] == 10.0
    assert cand.params["width"] == 13
    assert abs(cand.params["snr"] - 18.5) < 0.15


def test_config_b_caps_and_plots(runs):
    out = runs["B", "port"]
    assert len(glob.glob(str(out / "candidate_*.json"))) == 1
    assert (out / "candidate_0000.png").stat().st_size > 0
    cand = riptide_tpu_torch.load_json(str(out / "candidate_0000.json"))
    assert cand.params["dm"] == 10.0


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_candidate_files_load_across_packages(runs, config):
    """Each package loads the other's candidate files: the port reads a
    DataFrame record as a Table, the JAX package the port's Table
    record as a DataFrame."""
    for rf in sorted(glob.glob(str(runs[config, "ref"] / "candidate_*.json"))):
        cand = riptide_tpu_torch.load_json(rf)
        ref = riptide_tpu.load_json(rf)
        assert isinstance(cand, riptide_tpu_torch.Candidate)
        assert isinstance(cand.peaks, riptide_tpu_torch.Table)
        np.testing.assert_array_equal(cand.peaks.values, ref.peaks.values)
        np.testing.assert_array_equal(cand.subints, ref.subints)
    for pf in sorted(glob.glob(str(runs[config, "port"] / "candidate_*.json"))):
        ref = riptide_tpu.load_json(pf)
        cand = riptide_tpu_torch.load_json(pf)
        assert isinstance(ref.peaks, pandas.DataFrame)
        assert list(ref.peaks.columns) == cand.peaks.columns
        np.testing.assert_array_equal(ref.peaks.values, cand.peaks.values)
        np.testing.assert_array_equal(ref.subints, cand.subints)
        assert ref.params == cand.params


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_csv_bytes_are_pandas(runs, config):
    """The port's CSV products are the bytes pandas writes for the same
    rows with the reference's arguments."""
    for product in PRODUCTS:
        path = runs[config, "port"] / product
        df = pandas.read_csv(path, dtype=str, keep_default_na=False)
        rows = [{k: _typed(v) for k, v in r.items()} for r in read_csv(path)]
        want = pandas.DataFrame.from_dict(rows).to_csv(
            sep=",", index=False, float_format="%.9f")
        assert list(df.columns) == list(rows[0])
        assert path.read_text() == want


def _typed(text):
    try:
        return int(text)
    except ValueError:
        return float(text)


@pytest.mark.parametrize("masked", [False, True])
def test_prepared_series_are_the_reference_bits(runs, masked):
    """The scanned, repaired, de-reddened and normalised series that the
    batcher searches are the JAX package's bits on the CPU, clean or
    with masked samples (NaN and a clipped run)."""
    for fname in runs["files"]:
        rts = riptide_tpu.TimeSeries.from_presto_inf(fname)
        pts = riptide_tpu_torch.TimeSeries.from_presto_inf(fname)
        if masked:
            for ts in (rts, pts):
                ts.data[50_000:80_000] = np.nan
                ts.data[200_000:202_000] = 50.0
        want, _ = riptide_tpu.quality.prepare_time_series(
            rts, rmed_width=4.0, rmed_minpts=101, record=False)
        got, _ = riptide_tpu_torch.quality.prepare_time_series(
            pts, rmed_width=4.0, rmed_minpts=101, device="cpu",
            record=False)
        frac = got.metadata["dq_masked_frac"]
        assert frac == want.metadata["dq_masked_frac"]
        assert (frac > 0) == masked
        np.testing.assert_array_equal(got.data, want.data)


def test_pure_noise_gives_no_candidates(monkeypatch, tmp_path):
    for key, value in WIRE_ENV.items():
        monkeypatch.setenv(key, value)
    files = make_survey(tmp_path / "data", NOISE)
    for name, pkg, extra in (("ref", ref_pipeline, ()),
                             ("port", port_pipeline, ("--device", "cpu"))):
        out = run_cli(pkg, CONFIGS["A"], files, tmp_path / name, extra)
        assert not glob.glob(str(out / "candidate_*"))


BLOCKED_RUN = """
import json, sys
sys.modules["pandas"] = sys.modules["yaml"] = sys.modules["matplotlib"] = None
from riptide_tpu_torch.pipeline import Pipeline
conf, files, outdir = json.loads(sys.argv[1])
Pipeline(conf, device="cpu").process(files, outdir)
assert not any(m.split(".")[0] in ("pandas", "yaml", "matplotlib")
               and sys.modules[m] is not None for m in sys.modules)
"""


def test_products_without_pandas_yaml_matplotlib(runs, tmp_path):
    """Config A from a dict in a fresh interpreter where pandas, yaml
    and matplotlib cannot be imported: the same product bytes as the
    CLI run."""
    with open(CONFIGS["A"]) as fobj:
        conf = yaml.safe_load(fobj)
    arg = json.dumps([conf, [str(f) for f in runs["files"]], str(tmp_path)])
    out = subprocess.run([sys.executable, "-c", BLOCKED_RUN, arg], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    want = runs["A", "port"]
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(tmp_path)) == names
    for name in names:
        assert (tmp_path / name).read_bytes() == (want / name).read_bytes(), name


# ----------------------------------------------------------------------------
# Config validation, DM selection, harmonic tests, clusters
# ----------------------------------------------------------------------------

def _config_a():
    with open(CONFIGS["A"]) as fobj:
        return yaml.safe_load(fobj)


def _drop_clustering(c):
    del c["clustering"]


BAD_CONFIGS = {
    "processes": lambda c: c.__setitem__("processes", -1),
    "format": lambda c: c["data"].__setitem__("format", "hdf5"),
    "no clustering": _drop_clustering,
    "wtsp": lambda c: c["ranges"][0]["ffa_search"].__setitem__("wtsp", 0.5),
    "unknown section": lambda c: c.__setitem__("unknown_section", {}),
    "liveness": lambda c: c.__setitem__("liveness", {"watchdog_k": 0.5}),
    "data_quality": lambda c: c.__setitem__(
        "data_quality", {"ingest_policy": "maybe"}),
}


@pytest.mark.parametrize("case", sorted(BAD_CONFIGS))
def test_config_validation_errors_match(case):
    """Each bad config of ``tests/test_pipeline.py`` (and two optional
    sections) raises the same exception type, with the same message, in
    both packages."""
    conf = _config_a()
    BAD_CONFIGS[case](conf)
    errors = []
    for pkg in (ref_pipeline, port_pipeline):
        with pytest.raises(Exception) as info:
            pkg.validate_pipeline_config(json.loads(json.dumps(conf)))
        errors.append(info.value)
    ref, port = errors
    assert type(ref).__name__ == type(port).__name__ == "InvalidPipelineConfig"
    assert str(port) == str(ref)


def test_example_config_validates_as_reference():
    with open(os.path.join(REPO, "riptide_tpu_torch", "pipeline", "config",
                           "example.yaml")) as fobj:
        conf = yaml.safe_load(fobj)
    with open(os.path.join(REPO, "riptide_tpu", "pipeline", "config",
                           "example.yaml")) as fobj:
        ref_conf = yaml.safe_load(fobj)
    assert conf == ref_conf
    port = port_pipeline.validate_pipeline_config(conf)
    assert port == ref_pipeline.validate_pipeline_config(ref_conf)
    port_pipeline.validate_ranges(port["ranges"], 64e-6)


@pytest.mark.parametrize("tsamp_max, bins", [(0.5 / 480 * 1.01, None),
                                             (256e-6 * 8, 4096),
                                             (256e-6, None)])
def test_range_validation_matches(tsamp_max, bins):
    outcomes = []
    for pkg in (ref_pipeline, port_pipeline):
        conf = pkg.validate_pipeline_config(_config_a())
        if bins:
            conf["ranges"][0]["candidates"]["bins"] = bins
        try:
            pkg.validate_ranges(conf["ranges"], tsamp_max)
            outcomes.append(None)
        except Exception as err:
            outcomes.append((type(err).__name__, str(err)))
    assert outcomes[0] == outcomes[1]


BAND = dict(fmin=1182.0, fmax=1582.0, nchans=1024)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_dms_matches_reference(seed):
    rng = np.random.default_rng(seed)
    trials = np.sort(rng.uniform(0.0, 300.0, 400))
    for lo, hi, wmin in ((0.0, 300.0, 1e-3), (12.5, 140.0, 5e-4),
                         (None, None, 2e-3)):
        lo = trials[0] if lo is None else lo
        hi = trials[-1] if hi is None else hi
        want = ref_pipeline.select_dms(trials, lo, hi, wmin=wmin, **BAND)
        got = port_pipeline.select_dms(trials, lo, hi, wmin=wmin, **BAND)
        np.testing.assert_array_equal(got, want)


def _cands(seed, n=40):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.2, 3.0, n // 2)
    freqs = np.concatenate([base, base * rng.choice([2, 3, 0.5, 1.5],
                                                    n // 2)])
    return [types.SimpleNamespace(freq=float(f), snr=float(s),
                                  ducy=float(d), dm=float(m))
            for f, s, d, m in zip(freqs, rng.uniform(6, 40, n),
                                  rng.uniform(0.01, 0.2, n),
                                  rng.choice([0.0, 10.0, 10.5, 80.0], n))]


@pytest.mark.parametrize("seed", [0, 1])
def test_harmonic_tests_match_reference(seed):
    cands = _cands(seed)
    kw = dict(tobs=128.0, fmin=1182.0, fmax=1582.0)
    for F in cands[:10]:
        for H in cands:
            if F is H:
                continue
            assert port_pipeline.htest(F, H, **kw) == \
                ref_pipeline.htest(F, H, **kw)
            assert port_pipeline.hdiag(F, H, **kw) == \
                ref_pipeline.hdiag(F, H, **kw)
    from riptide_tpu.pipeline.harmonic_testing import dm_distance_matrix as rd
    from riptide_tpu_torch.pipeline.harmonic_testing import dm_distance_matrix

    np.testing.assert_array_equal(dm_distance_matrix(cands, 1182.0, 1582.0),
                                  rd(cands, 1182.0, 1582.0))


def _peaks(cls, seed, n=30):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        f = float(rng.uniform(0.3, 3.0))
        out.append(cls(period=1.0 / f, freq=f, width=int(rng.integers(1, 40)),
                       ducy=float(rng.uniform(0.01, 0.3)), iw=0, ip=0,
                       snr=float(rng.uniform(6, 30)),
                       dm=float(rng.choice([0.0, 10.0, 20.0]))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_peak_clusters_match_reference(seed):
    """PeakCluster summaries and clusters_to_dataframe equal the
    reference's DataFrames, and their CSV bytes are pandas'."""
    from fractions import Fraction

    groups = [slice(0, 5), slice(5, 6), slice(6, 18), slice(18, 30)]
    made = {}
    for name, mod, cls in (("ref", ref_pc, RefPeak), ("port", port_pc, Peak)):
        peaks = _peaks(cls, seed)
        cls_ = [mod.PeakCluster(peaks[g]) for g in groups]
        for rank, cl in enumerate(cls_):
            cl.rank = rank
        cls_[3].parent_fundamental = cls_[0]
        cls_[3].hfrac = Fraction(3, 2)
        made[name] = cls_
    for r, p in zip(made["ref"], made["port"]):
        rdf, pt = r.summary_dataframe(), p.summary_dataframe()
        assert pt.columns == list(rdf.columns)
        np.testing.assert_array_equal(pt.values, rdf.values)
        assert pt.to_csv() == rdf.to_csv(index=False, float_format="%.9f")
        assert p.summary_dict() == r.summary_dict()
    rdf = ref_pc.clusters_to_dataframe(made["ref"])
    pt = port_pc.clusters_to_dataframe(made["port"])
    assert pt.columns == list(rdf.columns) == port_pc.SUMMARY_COLUMNS
    np.testing.assert_array_equal(pt.values, rdf.values)
    assert pt.to_csv() == rdf.to_csv(index=False, float_format="%.9f")


# ----------------------------------------------------------------------------
# The batcher
# ----------------------------------------------------------------------------

SMALL_CONF = [{
    "ffa_search": {"period_min": 0.3, "period_max": 1.2,
                   "bins_min": 64, "bins_max": 71},
    "find_peaks": {"smin": 6.0},
}]
DERED = {"rmed_width": 4.0, "rmed_minpts": 101}


@pytest.fixture(scope="module")
def small_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("small")
    return [generate_data_presto(str(root), f"s{i}_DM{dm:.2f}", tobs=16.0,
                                 tsamp=1e-3, period=0.5, dm=dm,
                                 amplitude=amp)
            for i, (dm, amp) in enumerate([(0.0, 20.0), (5.0, 12.0),
                                           (10.0, 8.0), (15.0, 15.0)])]


def test_batch_searcher_single_io_thread(small_files):
    """process_stream must not deadlock at io_threads=1 (the per-chunk
    staging task once shared the pool with the file loads it waits
    on), and gives the chunk's peaks."""
    bs = BatchSearcher(DERED, SMALL_CONF, io_threads=1, device="cpu")
    with ThreadPoolExecutor(max_workers=1) as runner:
        fut = runner.submit(bs.process_stream,
                            [small_files[:1], small_files[1:2]])
        peaks = fut.result(timeout=300)
    assert peaks
    best = max(peaks, key=lambda p: p.snr)
    assert abs(best.period - 0.5) < 1e-3


@pytest.mark.parametrize("requested", [1, 2, 10_000])
def test_loader_pool_leaves_a_core(requested, monkeypatch):
    """The loader pool is the requested size, but at most the usable
    cores less one and at least 1, on hosts of 1, 2 and 8 cores."""
    from riptide_tpu_torch.pipeline.batcher import loader_threads

    for cores in (1, 2, 8):
        monkeypatch.setattr(os, "sched_getaffinity",
                            lambda pid, n=cores: set(range(n)))
        want = max(1, min(requested, cores - 1))
        assert loader_threads(requested) == want
        bs = BatchSearcher(DERED, SMALL_CONF, io_threads=requested,
                           device="cpu")
        assert bs.io_threads == want


def _stream(files, **kw):
    bs = BatchSearcher(DERED, SMALL_CONF, io_threads=2, batch_size=2,
                       device="cpu", **kw)
    return bs, bs.process_stream([files[:2], files[2:]])


def test_batch_searcher_matches_run_search_batch(small_files):
    """The stream's peaks are those of run_search_batch on the same
    loaded and prepared series, chunk by chunk; each staging buffer
    goes back to the pool once."""
    bs, peaks = _stream(small_files)
    want = []
    for chunk in (small_files[:2], small_files[2:]):
        series = [bs.load_prepared(f, search=False) for f in chunk]
        batch = np.stack([ts.data for ts in series])
        plan = bs._plan_for(SMALL_CONF[0], batch.shape[1], series[0].tsamp)
        ppt, _ = engine.run_search_batch(
            plan, batch, tobs=batch.shape[1] * series[0].tsamp,
            dms=[ts.metadata["dm"] for ts in series], device="cpu",
            **SMALL_CONF[0]["find_peaks"])
        want += [p for trial in ppt for p in trial]
    assert peaks == want
    bufs = [id(buf) for stack in bs._staging_pool._free.values()
            for buf, _ in stack]
    assert len(bufs) == len(set(bufs))
    from riptide_tpu_torch import native

    if native.available():
        assert bufs, "the native prep took no staging buffer"


def test_injected_oom_bisects_to_the_same_peaks(small_files):
    _, want = _stream(small_files)
    before = get_metrics().counter("oom_bisections")
    _, got = _stream(small_files, faults=FaultPlan.parse("oom:1x2"))
    assert get_metrics().counter("oom_bisections") - before == 2
    assert got == want


def test_process_fname_list_is_one_chunk_of_the_stream(small_files):
    """``process_fname_list(fnames)`` searches the files as the one chunk
    of ``process_stream([fnames])``: the same peaks."""
    files = small_files[:2]
    got = BatchSearcher(DERED, SMALL_CONF, io_threads=2,
                        device="cpu").process_fname_list(files)
    want = BatchSearcher(DERED, SMALL_CONF, io_threads=2,
                         device="cpu").process_stream([files])
    assert got and got == want


def test_injected_oom_at_the_floor_raises(small_files):
    bs = BatchSearcher(DERED, SMALL_CONF, io_threads=2, batch_size=2,
                       device="cpu", faults=FaultPlan.parse("oom:0x9"),
                       oom_floor=2)
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        bs.process_stream([small_files[:2]])


def test_nan_inject_masks_and_records(small_files):
    bs = BatchSearcher(DERED, SMALL_CONF, io_threads=1, device="cpu",
                       faults=FaultPlan.parse("nan_inject:0"))
    bs.process_stream([small_files[:1]])
    (report,) = bs.dq_reports.values()
    assert report.n_nonfinite > 0 and not report.quarantined
    assert bs.dq_by_dm() == {0.0: report.masked_frac}


def test_fault_plan_refuses_unported_kinds():
    """An unknown kind is refused; ``peer_loss`` is a kind of the port's
    since the multi-GPU slice."""
    with pytest.raises(ValueError, match="bad fault directive"):
        FaultPlan.parse("no_such_kind:2")
    assert FaultPlan.parse("peer_loss:2")._directives == [
        {"kind": "peer_loss", "chunk": 2, "arg": None, "remaining": 1}]
    assert FaultPlan.parse("nan_inject:0:0.1x3,oom:4")._directives == [
        {"kind": "nan_inject", "chunk": 0, "arg": 0.1, "remaining": 3},
        {"kind": "oom", "chunk": 4, "arg": None, "remaining": 1}]


def test_pipeline_defaults_to_the_card():
    """Pipeline(device=None) means CUDA: without a card it raises before
    any work."""
    import torch

    if torch.cuda.is_available():
        assert port_pipeline.Pipeline(_config_a()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_pipeline.Pipeline(_config_a())
    assert port_pipeline.get_parser().parse_args(
        ["-c", "x.yml", "f.inf"]).device == "cuda"


def test_render_spawned_plots_in_workers_without_the_card(runs, tmp_path):
    """Spawned plot workers write every candidate's JSON and PNG, with
    the card hidden from them; the parent's environment is restored."""
    from riptide_tpu_torch.pipeline.pipeline import (CandidateWriter,
                                                     render_spawned)

    cand = riptide_tpu_torch.load_json(
        str(runs["A", "port"] / "candidate_0000.json"))
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    render_spawned(CandidateWriter(str(tmp_path), plot=True),
                   [(i, cand) for i in range(3)], 2)
    assert os.environ.get("CUDA_VISIBLE_DEVICES") == saved
    for i in range(3):
        assert (tmp_path / f"candidate_{i:04d}.png").stat().st_size > 0
        assert riptide_tpu_torch.load_json(
            str(tmp_path / f"candidate_{i:04d}.json")).params == cand.params


def test_stream_records_spans_and_metrics(small_files):
    """With the tracer on, every chunk of the stream records its stage,
    ship, queue and collect spans, and the loads, data-quality steps
    and wire prep inside its stage; the scan counts its samples."""
    from riptide_tpu_torch.obs import trace

    before = get_metrics().counter("dq_scanned_samples")
    tracer = trace.enable()
    try:
        _stream(small_files)
    finally:
        trace.disable()
    names = {(name, attrs.get("chunk")) for name, _, _, _, attrs, _
             in tracer.events()}
    for chunk in (0, 1):
        for name in ("stage", "ship", "queue", "collect", "load", "dq",
                     "prep"):
            assert (name, chunk) in names, (name, chunk)
    assert get_metrics().counter("dq_scanned_samples") - before == \
        4 * 16_000
    assert get_metrics().summary()["queue_depth"] == 0


def test_packaging_lists_the_new_packages():
    """pyproject.toml lists every package of the port and ships the
    pipeline's example config."""
    import pkgutil
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fobj:
        tool = tomllib.load(fobj)["tool"]["setuptools"]
    pkgs = {m.name for m in pkgutil.walk_packages(
        riptide_tpu_torch.__path__, "riptide_tpu_torch.") if m.ispkg}
    assert pkgs >= {"riptide_tpu_torch.pipeline", "riptide_tpu_torch.apps",
                    "riptide_tpu_torch.survey", "riptide_tpu_torch.obs"}
    assert pkgs <= set(tool["packages"])
    assert "config/*.yaml" in tool["package-data"]["riptide_tpu_torch.pipeline"]


def test_oom_drops_the_failed_batch_before_bisecting(small_files,
                                                     monkeypatch):
    """A device out-of-memory error at collect: the failed batch's S/N
    cube and its shipped wire are unreferenced before the halves run
    (the caching allocator can reuse their blocks), and the halves give
    the unthrottled peaks."""
    import weakref

    import torch

    from riptide_tpu_torch.pipeline import batcher

    _, want = _stream(small_files)
    cubes, wires, alive = [], [], []
    ship = batcher.ship_stage_data

    def tracked_ship(prepared, device):
        shipped = ship(prepared, device)
        wires.append(weakref.ref(shipped[0]))
        return shipped

    def failing_collect(handle, dms):
        cubes.append(weakref.ref(engine.search_snr_dev(handle)))
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")

    search_slice = BatchSearcher._search_slice

    def checked_slice(self, *args):
        alive.append([ref() is not None for ref in cubes + wires])
        return search_slice(self, *args)

    monkeypatch.setattr(batcher, "ship_stage_data", tracked_ship)
    monkeypatch.setattr(batcher, "collect_search_batch", failing_collect)
    monkeypatch.setattr(BatchSearcher, "_search_slice", checked_slice)
    _, got = _stream(small_files)
    assert len(cubes) == len(wires) == 2 and len(alive) == 4
    assert not any(any(a) for a in alive)
    assert got == want
