"""
Multi-process initialisation over ``torch.distributed``.

The reference has no communication backend at all: its inter-process
data motion is fork + pickled ``Pool.map`` arguments
(riptide/pipeline/worker_pool.py:36-44). The JAX package scales past one
process with ``jax.distributed``; the port joins a ``torch.distributed``
process group on the ``gloo`` backend instead. Processes exchange only
peak lists, kilobytes a chunk, as host arrays (the JAX package's
``process_allgather`` is a host collective too), so gloo serves them on
one card or many: NCCL would refuse two ranks on one card and buys
nothing at this size. Each process searches on its own card,
:func:`local_device`.

The defaults come from torch's own environment variables:
``MASTER_ADDR`` and ``MASTER_PORT`` (the coordinator), ``WORLD_SIZE``
and ``RANK``.
"""
import datetime
import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger("riptide_tpu_torch.distributed")

__all__ = ["init_distributed", "process_index", "process_count",
           "local_device"]


def _initialized():
    return dist.is_available() and dist.is_initialized()


def process_index():
    """This process's rank in the process group; 0 when none is up."""
    return int(dist.get_rank()) if _initialized() else 0


def process_count():
    """The number of processes in the process group; 1 when none is
    up."""
    return int(dist.get_world_size()) if _initialized() else 1


def local_device():
    """This process's card: ``cuda:(LOCAL_RANK or rank) % device_count``,
    so every process of a run on a one-card machine shares ``cuda:0``.
    Raises without a card (the search never falls back to the CPU)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device for this process; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    local = os.environ.get("LOCAL_RANK")
    rank = int(local) if local not in (None, "") else process_index()
    return torch.device("cuda", rank % n)


def _env_address():
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{addr}:{port}" if addr and port else None


def _env_int(name):
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, initialization_timeout=None):
    """
    Join (or create) a multi-process run over ``torch.distributed``
    (gloo). Safe to call unconditionally: a single-process run with no
    coordinator configured is a no-op.

    ``coordinator_address`` ("host:port") defaults to ``MASTER_ADDR`` and
    ``MASTER_PORT``, ``num_processes`` to ``WORLD_SIZE``, ``process_id``
    to ``RANK``. ``initialization_timeout`` (seconds) bounds the wait for
    every process to reach the coordinator — without it a missing peer
    stalls startup for torch's default timeout; a connect failure is
    re-raised with the coordinator address named, so the operator knows
    *which* endpoint never answered.

    Returns the process count of the run (an int — truthiness is
    compatible with a boolean: 0 for a single-process no-op, >= 2 when
    a multi-process run is up).
    """
    if _initialized():
        n = process_count()
        return n if n > 1 else 0
    explicit = coordinator_address or _env_address()
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if explicit is None and num_processes is None:
        return 0
    kwargs = {}
    if initialization_timeout is not None:
        # Round up so a sub-second request cannot truncate to an
        # immediate 0-second timeout.
        kwargs["timeout"] = datetime.timedelta(
            seconds=max(1, int(round(float(initialization_timeout)))))
    try:
        if explicit is None:
            raise ValueError("no coordinator address: pass one or set "
                             "MASTER_ADDR and MASTER_PORT")
        if num_processes is None or process_id is None:
            raise ValueError("the process count and this process's index "
                             "are needed: pass them or set WORLD_SIZE and "
                             "RANK")
        dist.init_process_group("gloo", init_method=f"tcp://{explicit}",
                                world_size=int(num_processes),
                                rank=int(process_id), **kwargs)
    except Exception as err:
        log.error(
            "could not join the process group via coordinator %r "
            "(process_id=%s, num_processes=%s): %s",
            explicit, process_id, num_processes, err,
        )
        raise RuntimeError(
            f"distributed init failed: coordinator {explicit!r} "
            f"unreachable or peers missing ({err})"
        ) from err
    log.info("process group up: process %d/%d (gloo)", process_index(),
             process_count())
    # Same contract as the already-initialized branch: a 1-process run
    # is falsy (callers branch on truthiness to enable multi-process
    # paths).
    n = process_count()
    return n if n > 1 else 0
