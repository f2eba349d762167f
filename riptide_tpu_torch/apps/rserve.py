"""
rserve: the survey-as-a-service daemon on the card (the port's
counterpart of the JAX package's ``tools/rserve.py``).

Starts a :class:`riptide_tpu_torch.serve.daemon.ServeDaemon` rooted at
a serve directory and keeps it up until SIGTERM/SIGINT. The built CUDA
and native libraries and the search plans stay warm across jobs for the
life of the process — a second job with an already-served plan geometry
starts its first chunk with zero cold builds (the point of running a
daemon at all).

Usage::

    python -m riptide_tpu_torch.apps.rserve --root DIR [--port N]
        [--workers N] [--max-jobs N] [--device cuda|cpu]

* ``--root`` (or ``RIPTIDE_SERVE_DIR``): the serve directory —
  ``jobs.jsonl`` registry, per-job ``jobs/<id>/`` run directories,
  ``serve.port`` discovery file.
* ``--port`` (or ``RIPTIDE_SERVE_PORT``, default 0 = ephemeral): the
  loopback HTTP port; the bound port is printed and written to
  ``<root>/serve.port`` either way.
* ``--workers``: concurrent job runners (the fair-share queue still
  grants one turn on the card at a time).
* ``--device``: where every job searches (default ``cuda``; no
  fallback to the CPU).

Submit with ``python -m riptide_tpu_torch.apps.rseek --submit
http://127.0.0.1:<port> FILE`` or raw HTTP (``POST /jobs``). On restart
the daemon replays ``jobs.jsonl`` and resumes every unfinished job from
its own survey journal.

Shutdown is a graceful drain: SIGTERM/SIGINT (or ``POST /drain``)
stops admission (503), lets the chunk holding the turn finish, parks
every other job at its chunk gate WITHOUT a terminal registry record,
and exits 0 once the workers have parked (bounded by
``RIPTIDE_SERVE_DRAIN_TIMEOUT_S``). A restarted rserve re-queues the
parked jobs (``resumed``) and they continue from their journals.

A sticky CUDA error leaves the process's context unusable: the job that
met it fails, the others park the same way, and rserve exits with
:data:`EXIT_DEVICE_LOST` so that a supervisor restarts it.
"""
import argparse
import logging
import os
import signal
import sys
import threading

if not __package__:   # run by path: import the checkout's package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from riptide_tpu_torch.serve import ServeDaemon  # noqa: E402
from riptide_tpu_torch.utils import envflags  # noqa: E402

# Exit status after a sticky CUDA error (EX_TEMPFAIL: restart and retry).
EXIT_DEVICE_LOST = 75


def get_parser():
    ap = argparse.ArgumentParser(
        prog="rserve", description="warm multi-tenant survey service")
    ap.add_argument("--root", default=None,
                    help="serve directory (default: RIPTIDE_SERVE_DIR)")
    ap.add_argument("--port", type=int, default=None,
                    help="HTTP port (default: RIPTIDE_SERVE_PORT; "
                         "0 = ephemeral)")
    ap.add_argument("--workers", type=int, default=2,
                    help="concurrent job runner threads (default 2)")
    ap.add_argument("--max-jobs", type=int, default=None,
                    help="resident pending+running job cap "
                         "(default: RIPTIDE_SERVE_MAX_JOBS)")
    ap.add_argument("--device", default="cuda",
                    help="device every job searches on (default cuda; "
                         "'cpu' runs the plain PyTorch versions)")
    return ap


def main(argv=None):
    ap = get_parser()
    args = ap.parse_args(argv)
    root = args.root or envflags.get("RIPTIDE_SERVE_DIR")
    if not root:
        ap.error("no serve directory: give --root or set "
                 "RIPTIDE_SERVE_DIR")
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    daemon = ServeDaemon(root, port=args.port, max_jobs=args.max_jobs,
                         workers=args.workers, device=args.device)
    daemon.start()
    print(f"rserve: listening on http://127.0.0.1:{daemon.port}/jobs "
          f"(root {daemon.root}, device {daemon.device})", flush=True)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    timeout = float(envflags.get("RIPTIDE_SERVE_DRAIN_TIMEOUT_S"))
    try:
        while not stop.wait(timeout=0.5):
            # POST /drain initiates the same shutdown from the HTTP
            # side, and a lost card its own; fall through to the wait.
            if daemon.draining or daemon.device_lost:
                break
    finally:
        # Graceful drain: stop admission, let the running chunk finish,
        # park queued jobs at the chunk gate (journals resumable, no
        # terminal registry record), then tear the daemon down.
        if not daemon.device_lost:
            daemon.drain(timeout=timeout)
        if not daemon.wait_drained(timeout=timeout):
            print("rserve: drain timed out; exiting with workers "
                  "still parked", flush=True)
        daemon.stop()
    if daemon.device_lost:
        print("rserve: CUDA context lost; exiting for a restart (parked "
              "jobs resume from their journals)", flush=True)
        return EXIT_DEVICE_LOST
    print("rserve: drained, exiting", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
