"""
The port's :class:`~riptide_tpu_torch.candidate.Candidate` and the
column :class:`~riptide_tpu_torch.table.Table` it keeps its peaks in,
against the JAX package's Candidate and pandas, on the CPU.

The same seeded series and peak clusters go through both packages'
``Candidate.from_pipeline_output``: equal params, member peaks, DM curve
and metadata, and the same folded sub-integrations (the fold is the
same float64 arithmetic). The table writes pandas' CSV bytes and
``to_string`` text, and its JSON form loads as a DataFrame in the JAX
package and back as a table here.
"""
import numpy as np
import pandas
import pytest

import riptide_tpu
import riptide_tpu_torch
from riptide_tpu.peak_detection import Peak as RefPeak
from riptide_tpu.pipeline.peak_cluster import PeakCluster as RefCluster
from riptide_tpu_torch import Candidate, Table
from riptide_tpu_torch.apps.rseek import FORMATTERS
from riptide_tpu_torch.peak_detection import Peak
from riptide_tpu_torch.pipeline.peak_cluster import PeakCluster


def _series(pkg, seed=0):
    np.random.seed(seed)
    return pkg.TimeSeries.generate(32.0, 1e-3, 0.5, amplitude=15.0,
                                   ducy=0.05)


def _cluster(cls, peak_cls, seed):
    rng = np.random.default_rng(seed)
    peaks = []
    for dm in (0.0, 5.0, 5.0, 10.0, 10.0, 20.0):
        f = 2.0 + float(rng.normal(0, 1e-4))
        peaks.append(peak_cls(period=1.0 / f, freq=f,
                              width=int(rng.integers(1, 20)),
                              ducy=float(rng.uniform(0.01, 0.2)), iw=1,
                              ip=int(rng.integers(0, 100)),
                              snr=float(rng.uniform(6, 30)), dm=dm))
    return cls(peaks)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("subints", [16, None, 1000])
def test_from_pipeline_output_matches_reference(seed, subints):
    ref = riptide_tpu.candidate.Candidate.from_pipeline_output(
        _series(riptide_tpu, seed), _cluster(RefCluster, RefPeak, seed), 128,
        subints=subints)
    got = Candidate.from_pipeline_output(
        _series(riptide_tpu_torch, seed), _cluster(PeakCluster, Peak, seed),
        128, subints=subints)
    assert got.params == ref.params
    assert got.peaks.columns == list(ref.peaks.columns)
    np.testing.assert_array_equal(got.peaks.values, ref.peaks.values)
    assert got.subints.shape == ref.subints.shape
    np.testing.assert_array_equal(got.subints, ref.subints)
    np.testing.assert_array_equal(got.profile, ref.profile)
    for g, w in zip(got.dm_curve, ref.dm_curve):
        np.testing.assert_array_equal(g, w)
    assert dict(got.tsmeta) == dict(ref.tsmeta)
    assert str(got) == str(ref)


def test_json_round_trip_in_both_packages(tmp_path):
    got = Candidate.from_pipeline_output(
        _series(riptide_tpu_torch), _cluster(PeakCluster, Peak, 0), 64,
        subints=8)
    path = tmp_path / "cand.json"
    riptide_tpu_torch.save_json(str(path), got)
    back = riptide_tpu_torch.load_json(str(path))
    assert isinstance(back.peaks, Table)
    assert back.params == got.params
    assert back.peaks == Table.from_values(got.peaks.values,
                                           got.peaks.columns)
    np.testing.assert_array_equal(back.subints, got.subints)
    ref = riptide_tpu.load_json(str(path))
    assert isinstance(ref.peaks, pandas.DataFrame)
    np.testing.assert_array_equal(ref.peaks.values, got.peaks.values)
    assert ref.params == got.params
    # ...and the JAX package's file of the same candidate loads here.
    ref_path = tmp_path / "ref.json"
    riptide_tpu.save_json(str(ref_path), ref)
    again = riptide_tpu_torch.load_json(str(ref_path))
    assert again.peaks == back.peaks
    np.testing.assert_array_equal(again.subints, got.subints)


def test_plot_writes_png(tmp_path):
    cand = Candidate.from_pipeline_output(
        _series(riptide_tpu_torch), _cluster(PeakCluster, Peak, 0), 64,
        subints=8)
    import matplotlib

    matplotlib.use("Agg")
    cand.savefig(str(tmp_path / "c.png"))
    assert (tmp_path / "c.png").stat().st_size > 0


# ----------------------------------------------------------------------------
# The column table against pandas
# ----------------------------------------------------------------------------

def _records(seed, n=12):
    rng = np.random.default_rng(seed)
    return [dict(period=float(rng.uniform(0.1, 30)), freq=rng.uniform(0, 5),
                 dm=float(rng.choice([0.0, 12.5, 300.0])),
                 width=int(rng.integers(1, 200)),
                 ducy=float(rng.uniform(0.001, 0.3)),
                 snr=np.float32(rng.uniform(6, 200)),
                 rank=int(i), flag=bool(i % 3),
                 name="a,b" if i == 2 else f"s{i}",
                 masked=None if i == 4 else round(float(rng.random()), 6))
            for i in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_csv_is_pandas(seed):
    recs = _records(seed)
    got = Table.from_records(recs)
    want = pandas.DataFrame.from_dict(recs)
    assert got.columns == list(want.columns)
    assert got.to_csv() == want.to_csv(sep=",", index=False,
                                       float_format="%.9f")
    sub = ["rank", "snr", "width", "period"]
    assert got[sub].to_csv() == want[sub].to_csv(index=False,
                                                 float_format="%.9f")
    num = ["period", "dm", "width", "snr"]
    assert got[num].values.dtype == want[num].values.dtype
    np.testing.assert_array_equal(got[num].values, want[num].values)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_to_string_is_pandas(seed):
    recs = [{k: r[k] for k in ("period", "freq", "width", "ducy", "snr",
                               "dm")} for r in _records(seed)]
    cols = ["period", "freq", "width", "ducy", "dm", "snr"]
    got = Table.from_records(recs).to_string(columns=cols,
                                             formatters=FORMATTERS)
    want = pandas.DataFrame(recs).to_string(columns=cols,
                                            formatters=FORMATTERS,
                                            index=False)
    assert got == want


def test_table_shapes_and_errors(tmp_path):
    t = Table.from_records([{"a": 1, "b": 2.5}, {"a": 3}])
    assert len(t) == 2 and t.columns == ["a", "b"]
    np.testing.assert_array_equal(t["b"], [2.5, np.nan])
    assert t.row(0) == {"a": 1, "b": 2.5}
    with pytest.raises(ValueError, match="rows"):
        t["c"] = [1, 2, 3]
    with pytest.raises(ValueError, match="do not fit"):
        Table.from_values(np.zeros((2, 3)), ["x", "y"])
    with pytest.raises(ValueError, match="needs a formatter"):
        t.to_string()
    t.to_csv(str(tmp_path / "t.csv"))
    assert (tmp_path / "t.csv").read_text() == "a,b\n1,2.500000000\n3,\n"
    df = t.to_dataframe()
    assert isinstance(df, pandas.DataFrame) and list(df.columns) == ["a", "b"]
    assert Table.from_values(np.empty(0), ["x"]).columns == ["x"]
