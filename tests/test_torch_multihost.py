"""
The port's multi-process survey layer (``riptide_tpu_torch.parallel``'s
``distributed`` and ``multihost``) on the CPU: the peak wire encoding
and the gather's padding against the JAX package's, local-only mode
after an injected or a real peer loss, the journal writer, and two real
processes joined over ``torch.distributed`` (gloo) on this host: the
counterpart of the JAX package's tests/test_multihost.py. Every
subprocess searches on the CPU (``device="cpu"``).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from riptide_tpu.parallel import multihost as ref_mh
from riptide_tpu_torch.parallel import distributed
from riptide_tpu_torch.parallel import multihost as mh
from riptide_tpu_torch.peak_detection import Peak
from riptide_tpu_torch.survey import metrics as port_metrics
from riptide_tpu_torch.survey.faults import FaultPlan, InjectedPeerLoss
from riptide_tpu_torch.survey.journal import SurveyJournal
from riptide_tpu_torch.survey.liveness import PeerTimeout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNR_RTOL = 1e-5
# The subprocesses' bound: each takes a few seconds on the CPU.
PROC_TIMEOUT_S = 120


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small per-shard ops:
    torch's pool spins between ops, which costs ~30x when the suite's
    parallel workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# The JAX package's two-process survey: N = 4096 at 1 ms, bins 64-71, two
# trials a process, process 1's trial 0 a 64 ms pulsar.
_SHARD = r"""
import numpy as np
from riptide_tpu_torch.libffa import generate_signal
from riptide_tpu_torch.search import periodogram_plan

N, TSAMP = 4096, 1e-3
PLAN = periodogram_plan(N, TSAMP, (1, 2, 3), 64e-3, 0.15, 64, 71)


def shard(seed, with_pulsar):
    rng = np.random.default_rng(seed)
    batch = rng.standard_normal((2, N)).astype(np.float32)
    if with_pulsar:
        np.random.seed(0)
        batch[0] = generate_signal(N, 64.0, amplitude=15.0, ducy=0.05)
    batch -= batch.mean(axis=1, keepdims=True)
    batch /= batch.std(axis=1, keepdims=True)
    return batch
"""

_WORKER = _SHARD + r"""
import json, sys
from riptide_tpu_torch.parallel import run_search_multihost
from riptide_tpu_torch.parallel.distributed import (init_distributed,
                                                    process_count,
                                                    process_index)
from riptide_tpu_torch.survey.journal import SurveyJournal

pid, port, jdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
assert init_distributed(f"localhost:{port}", num_processes=2,
                        process_id=pid, initialization_timeout=60) == 2
assert (process_index(), process_count()) == (pid, 2)
journal = SurveyJournal(jdir)
if pid == 0:
    journal.write_header("mh-survey", 1)
peaks, _ = run_search_multihost(PLAN, shard(pid, pid == 1), tobs=N * TSAMP,
                                dms_local=[2.0 * pid, 2.0 * pid + 1.0],
                                journal=journal, gather_timeout_s=60,
                                device="cpu")
print("PEAKS " + json.dumps([list(p) for p in peaks]), flush=True)
print(f"worker {pid} OK", flush=True)
"""

_PEER_LOSS_WORKER = _SHARD + r"""
import os, sys, time
import riptide_tpu_torch.parallel.multihost as mh
from riptide_tpu_torch.parallel import run_search_multihost
from riptide_tpu_torch.parallel.distributed import init_distributed
from riptide_tpu_torch.survey.journal import SurveyJournal
from riptide_tpu_torch.survey.liveness import PeerLivenessMonitor
from riptide_tpu_torch.survey.metrics import get_metrics

pid, port, jdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
assert init_distributed(f"localhost:{port}", num_processes=2,
                        process_id=pid, initialization_timeout=60) == 2
journal = SurveyJournal(jdir)
monitor = PeerLivenessMonitor(journal, process_index=pid, process_count=2,
                              max_age_s=0.2)
sentinel = os.path.join(jdir, "survivor_done")

if pid == 0:
    # The lost process: heartbeat once, then wedge — never search chunk
    # 0, never heartbeat again, never enter a collective. It lingers
    # (rank 0 holds the group's store) until the survivor is done.
    monitor.beat()
    for _ in range(1200):
        if os.path.exists(sentinel):
            break
        time.sleep(0.1)
    print("worker 0 OK: wedged process exiting", flush=True)
    os._exit(0)

# The survivor: its own heartbeats from a background beater, the peer's
# gone stale; the gather's collective really times out (the peer never
# enters it) and the survivor degrades to local-only mode.
monitor.start_beating(interval_s=0.05)
time.sleep(0.5)
journal.write_header("peerloss-survey", 2)
peaks, _ = run_search_multihost(
    PLAN, shard(1, True), tobs=N * TSAMP, dms_local=[2.0, 3.0],
    journal=journal, chunk_id=1, gather_timeout_s=2.0, monitor=monitor,
    device="cpu")
assert mh.is_degraded()
assert peaks, "survivor lost its own local peaks"
# Writer failover: process 0 is stale, so the lowest ALIVE process (us)
# journals.
assert monitor.lost() == [0], monitor.lost()
assert monitor.journal_writer() == 1
lost_chunks = monitor.unfinished_chunks(2)
assert lost_chunks == [0], lost_chunks
for cid in lost_chunks:
    run_search_multihost(PLAN, shard(0, False), tobs=N * TSAMP,
                         dms_local=[0.0, 1.0], journal=journal, chunk_id=cid,
                         monitor=monitor, device="cpu")
done = sorted(journal.completed_chunks())
assert done == [0, 1], done
assert monitor.partial_chunks() == [0, 1]
assert get_metrics().counter("peer_losses") == 1
print(f"worker 1 OK: survived peer loss, journaled chunks {done}",
      flush=True)
with open(sentinel, "w") as f:
    f.write("done")
# Skip the process group's shutdown: the wedged peer never joins it.
os._exit(0)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_two_processes(tmp_path, source, jdir):
    """Run the worker script as processes 0 and 1 of a two-process
    group; returns [(returncode, output), ...]."""
    script = tmp_path / "worker.py"
    script.write_text(source)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(i), port,
                               str(jdir)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    results = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=PROC_TIMEOUT_S)
            results.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (rc, out) in enumerate(results):
        assert rc == 0, f"worker {i} failed:\n{out[-4000:]}"
        assert f"worker {i} OK" in out
    return results


@pytest.fixture
def fresh(monkeypatch):
    """A fresh metrics registry, and local-only mode cleared."""
    reg = port_metrics.MetricsRegistry()
    monkeypatch.setattr(port_metrics, "_default", reg)
    mh.reset_degraded()
    yield reg
    mh.reset_degraded()


def _peak(period=0.5, snr=10.0, dm=0.0, iw=1, ip=7, width=3):
    return Peak(period=period, freq=1.0 / period, width=width, ducy=0.05,
                iw=iw, ip=ip, snr=snr, dm=dm)


def test_peak_encode_decode_roundtrip():
    peaks = [
        _peak(),
        # Large int fields survive the float64 wire exactly (float64 is
        # integer-exact through 2**53).
        _peak(period=1.25, snr=8.5, dm=112.75, iw=11, ip=123456789,
              width=1 << 40),
    ]
    arr = mh._encode(peaks)
    np.testing.assert_array_equal(arr, ref_mh._encode(peaks))
    out = mh._decode(arr)
    assert out == peaks
    for p in out:
        assert isinstance(p.iw, int) and isinstance(p.ip, int)
        assert isinstance(p.width, int)


def test_peak_encode_empty():
    arr = mh._encode([])
    assert arr.shape == (0, len(mh._FIELDS)) == ref_mh._encode([]).shape
    assert mh._decode(arr) == []
    assert mh._FIELDS == ref_mh._FIELDS


def test_gather_peaks_all_processes_empty_padding(monkeypatch, fresh):
    """Every process with zero peaks: the gather still pads to one row
    per process (all-gather needs equal shapes) and decodes back to an
    empty list, not phantom zero-peaks."""
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    shapes = []

    def fake_allgather(arr, timeout_s, what):
        shapes.append(arr.shape)
        return np.stack([np.zeros_like(arr), np.zeros_like(arr)])

    monkeypatch.setattr(mh, "_allgather", fake_allgather)
    assert mh.gather_peaks([]) == []
    assert shapes == [(1,), (1, len(mh._FIELDS))]


def test_gather_peaks_joins_in_process_order(monkeypatch, fresh):
    """Two processes' lists, the second longer: counts first, then rows
    padded to the longest, decoded in process order."""
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    mine = [_peak(snr=9.0)]
    theirs = [_peak(snr=12.0, ip=3), _peak(snr=7.0, ip=4)]

    def fake_allgather(arr, timeout_s, what):
        if arr.shape == (1,):
            return np.array([[1], [2]], np.int64)
        other = np.zeros_like(arr)
        other[:2] = mh._encode(theirs)
        return np.stack([arr, other])

    monkeypatch.setattr(mh, "_allgather", fake_allgather)
    assert mh.gather_peaks(mine, timeout_s=5.0) == mine + theirs
    assert fresh.snapshot()["timers"]["gather_s"]["count"] == 1


def test_gather_peaks_single_process_is_copy():
    local = [_peak(), _peak(snr=8.0)]
    out = mh.gather_peaks(local)
    assert out == local and out is not local


@pytest.mark.parametrize("how", ["injected", "timeout"])
def test_peer_loss_degrades_to_local_only(monkeypatch, fresh, how):
    """An injected ``peer_loss`` and a collective's PeerTimeout both
    degrade: ``peer_losses`` 1, a ``peer_loss`` incident, the flag
    sticky (the next gather enters no collective) and the local list
    returned."""
    from riptide_tpu_torch.survey import incidents

    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    calls = []
    emitted = []
    monkeypatch.setattr(incidents, "emit",
                        lambda kind, **kw: emitted.append(kind))

    def fake_allgather(arr, timeout_s, what):
        calls.append(what)
        raise PeerTimeout(f"{what} did not complete within {timeout_s}s")

    monkeypatch.setattr(mh, "_allgather", fake_allgather)
    faults = FaultPlan.parse("peer_loss:0") if how == "injected" else None
    local = [_peak()]
    assert mh.gather_peaks(local, faults=faults, timeout_s=0.1) == local
    assert mh.is_degraded()
    assert fresh.counter("peer_losses") == 1
    assert emitted == ["peer_loss"]
    assert calls == ([] if how == "injected"
                     else ["peak-count allgather (chunk 0)"])
    # Sticky: no further collective, no further count.
    assert mh.gather_peaks(local, faults=faults, chunk_id=1) == local
    assert fresh.counter("peer_losses") == 1
    assert len(calls) == (0 if how == "injected" else 1)


def test_injected_peer_loss_is_a_peer_timeout():
    assert issubclass(InjectedPeerLoss, PeerTimeout)
    plan = FaultPlan.parse("peer_loss:2")
    plan.before_gather(1)
    with pytest.raises(InjectedPeerLoss, match="chunk 2"):
        plan.before_gather(2)
    plan.before_gather(2)  # one firing


def _multihost_batch():
    from riptide_tpu_torch.libffa import generate_signal

    N = 4096
    np.random.seed(0)
    batch = np.stack([
        generate_signal(N, 64.0, amplitude=15.0, ducy=0.05),
        np.random.standard_normal(N).astype(np.float32),
    ])
    batch -= batch.mean(axis=1, keepdims=True)
    batch /= batch.std(axis=1, keepdims=True)
    return batch


def test_multihost_journals_on_process_zero(tmp_path, fresh, monkeypatch):
    """Single process: process 0 writes the chunk and a metrics snapshot,
    and the peaks are the JAX package's on the same input (uint6 wire)."""
    from riptide_tpu.parallel import run_search_multihost as ref_run
    from riptide_tpu.search import periodogram_plan as ref_plan
    from riptide_tpu_torch.parallel import run_search_multihost
    from riptide_tpu_torch.search import periodogram_plan

    monkeypatch.setenv("RIPTIDE_WIRE_DTYPE", "uint6")
    monkeypatch.setenv("RIPTIDE_FFA_PATH", "gather")
    N, tsamp = 4096, 1e-3
    args = (N, tsamp, (1, 2, 3), 64e-3, 0.15, 64, 71)
    batch = _multihost_batch()
    journal = SurveyJournal(tmp_path / "j")
    journal.write_header("mh", 1)
    peaks, polycos = run_search_multihost(
        periodogram_plan(*args), batch, tobs=N * tsamp, dms_local=[2.0, 3.0],
        journal=journal, device="cpu")
    assert peaks and len(polycos) == 2
    done = journal.completed_chunks()
    assert list(done) == [0] and done[0][1] == peaks
    assert journal.last_metrics() is not None
    assert fresh.counter("chunks_done") == 1
    want, _ = ref_run(ref_plan(*args), batch, tobs=N * tsamp,
                      dms_local=[2.0, 3.0])
    assert [(p.ip, p.iw, p.dm) for p in peaks] == \
        [(p.ip, p.iw, p.dm) for p in want]
    np.testing.assert_allclose([p.snr for p in peaks],
                               [p.snr for p in want], rtol=SNR_RTOL)


def test_init_distributed_single_process_contract(monkeypatch):
    """No coordinator configured: a no-op returning 0, rank 0 of 1; an
    unreachable coordinator is named in the error."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.init_distributed() == 0
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    with pytest.raises(RuntimeError, match="coordinator 'localhost:1'"):
        distributed.init_distributed("localhost:1", num_processes=2,
                                     process_id=1, initialization_timeout=1)


def test_local_device_never_falls_back_to_the_cpu(monkeypatch):
    if torch.cuda.is_available():
        monkeypatch.setenv("LOCAL_RANK", "3")
        n = torch.cuda.device_count()
        assert distributed.local_device() == torch.device("cuda", 3 % n)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.local_device()


def _peaks_of(out):
    line = [x for x in out.splitlines() if x.startswith("PEAKS ")][-1]
    return [Peak(*row) for row in json.loads(line[6:])]


def test_two_process_search_gathers_the_pulsar(tmp_path):
    """Two processes over gloo, one DM shard each: both return the same
    gathered list, which is a single-process search of both shards,
    sorted by S/N, and holds process 1's pulsar; process 0 journals."""
    jdir = tmp_path / "journal"
    results = _run_two_processes(tmp_path, _WORKER, jdir)
    lists = [_peaks_of(out) for _, out in results]
    assert lists[0] == lists[1]
    best = [p for p in lists[0] if abs(p.period - 0.064) < 1e-3
            and p.dm == 2.0]
    assert best, f"pulsar peak not gathered; got {lists[0][:5]}"
    ns = {}
    exec(compile(_SHARD, "shard", "exec"), ns)
    from riptide_tpu_torch.search.engine import run_search_batch

    batch = np.concatenate([ns["shard"](0, False), ns["shard"](1, True)])
    ppt, _ = run_search_batch(ns["PLAN"], batch, tobs=ns["N"] * ns["TSAMP"],
                              dms=[0.0, 1.0, 2.0, 3.0], device="cpu")
    want = sorted([p for t in ppt for p in t], key=lambda p: p.snr,
                  reverse=True)
    assert lists[0] == want
    journal = SurveyJournal(jdir)
    assert list(journal.completed_chunks()) == [0]
    assert journal.completed_chunks()[0][1] == want


def test_two_process_peer_loss_survivor_finishes(tmp_path):
    """Process 0 wedged (heartbeats stale, never in the gather): the
    survivor's bounded gather times out, it degrades to local-only mode,
    takes over the journal-writer role and completes BOTH chunks."""
    jdir = tmp_path / "journal"
    _run_two_processes(tmp_path, _PEER_LOSS_WORKER, jdir)
    journal = SurveyJournal(jdir)
    assert sorted(journal.completed_chunks()) == [0, 1]
    assert sorted(journal.read_heartbeats()) == [0, 1]
    assert journal.last_metrics()["peer_losses"] == 1
