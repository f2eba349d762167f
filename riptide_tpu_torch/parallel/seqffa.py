"""
Sequence-parallel FFA: one fold container split across devices (the
port of the JAX package's ``parallel/seqffa.py``).

The standard production layout keeps every time series on one device
and shards the DM batch (:mod:`.sharded`). When a single transform is
too large for one device — very long observations folded at short
periods — the row axis of the (m, p) fold container is sharded over a
``seq`` mesh axis instead.

The FFA merge tree (reference recursion: riptide/cpp/transforms.hpp:30-50,
flattened into level tables by :mod:`riptide_tpu_torch.ops.plan`)
decomposes cleanly: with ``m = S * m_local`` rows over ``S`` shards (S a
power of two), the first ``ceil(log2(m_local))`` levels only combine
rows within one shard — they ARE the m_local-row plan, run independently
per shard with no communication (``ops.ffa.ffa_transform_padded`` on
each shard's device) — and the top ``log2(S)`` levels combine rows
across shards. Each cross level gathers head and tail rows from other
shards' buffers (copied to the shard's device with ``.to``) and adds
them with the tail rolled, the arithmetic of ``ops.ffa``'s levels, so
the result is the same bits as :func:`riptide_tpu_torch.ops.ffa.ffa2`.

Two cross-level exchanges exist, as in the JAX package:

* all-gather (S < 8, or when a window check fails): every shard
  receives every shard's (m_local, p) buffer per level;
* windowed (S >= 8): each shard's output rows at a cross level read a
  contiguous ~m_local/2-row window of the head half and one of the tail
  half of its merge node, and the level tables bound both windows
  exactly on the host (:func:`_window_plan`). Each window spans at most
  two source shards, so each shard receives at most four buffers a
  level, however many shards there are.

The shard count must be a power of two: the FFA tree splits in halves,
so node boundaries align to shard boundaries only for power-of-two S
(m_local itself may be any size).
"""
from functools import lru_cache

import numpy as np
import torch

from ..ops.ffa import ffa2, ffa_transform_padded
from ..ops.plan import ffa_plan, num_levels
from .mesh import Mesh, _all_cards

__all__ = ["ffa2_seq", "seq_mesh"]


def seq_mesh(devices=None, axis_name="seq"):
    """1-D mesh over every card (or the given devices) for sequence
    parallelism."""
    if devices is None:
        devices = _all_cards()
    return Mesh(list(devices), (axis_name,))


def _cross_tables(m, S):
    """
    Per-shard slices of the global plan's cross-shard levels.

    Returns (h, t, shift) of shape (L_cross, S, m_local) int32. Row ids
    are global: 0..m-1 into the gathered buffer, m = the zero row.
    """
    m_local = m // S
    gplan = ffa_plan(m)
    L_local = num_levels(m_local)
    h = gplan.h[L_local:, :m]
    t = gplan.t[L_local:, :m]
    shift = gplan.shift[L_local:, :m]
    L_cross = h.shape[0]
    shape = (L_cross, S, m_local)
    return (
        np.ascontiguousarray(h.reshape(shape)),
        np.ascontiguousarray(t.reshape(shape)),
        np.ascontiguousarray(shift.reshape(shape)),
    )


def _merge_rows(buf, h, t, shift):
    """The merge arithmetic shared by both exchange forms: out =
    buf[h] + roll(buf[t], -shift) per output row."""
    P = buf.shape[1]
    head = buf[h]
    tail = buf[t]
    cols = torch.arange(P, dtype=torch.int64, device=buf.device)[None, :]
    idx = (cols + shift[:, None]) % P
    return head + torch.gather(tail, 1, idx)


@lru_cache(maxsize=64)
def _window_plan(m, S):
    """Static plan of the windowed exchange.

    For every cross level, computes from the ACTUAL level tables (no
    estimation) the <= 2 source shards of each destination shard's head
    window and tail window, and rewrites the global row ids into local
    indices of the per-shard receive buffer
    ``concat(recv_h0, recv_h1, recv_t0, recv_t1, zero_row)``.

    Returns a list over cross levels of
    ``(perms (4, S) int, hloc (S, m_local), tloc (S, m_local),
    shift (S, m_local))``, or None when some window spans more than two
    shards (m_local too small for the window bound) — callers then fall
    back to the all-gather form.
    """
    m_local = m // S
    gplan = ffa_plan(m)
    L_local = num_levels(m_local)
    h = gplan.h[L_local:, :m]
    t = gplan.t[L_local:, :m]
    shift = gplan.shift[L_local:, :m]
    Z = m  # the plan's zero-row id
    levels = []
    for lvl in range(h.shape[0]):
        hs = h[lvl].reshape(S, m_local)
        ts = t[lvl].reshape(S, m_local)
        sh = shift[lvl].reshape(S, m_local)
        perms = np.zeros((4, S), np.int32)
        hloc = np.zeros((S, m_local), np.int32)
        tloc = np.zeros((S, m_local), np.int32)
        for k in range(S):
            for w, (ids, out) in enumerate(((hs[k], hloc), (ts[k], tloc))):
                real = ids[ids != Z]
                if real.size == 0:
                    a0 = a1 = k  # nothing read; any legal source works
                else:
                    a0 = int(real.min()) // m_local
                    a1 = int(real.max()) // m_local
                    if a1 - a0 > 1:
                        return None
                perms[2 * w, k] = a0
                perms[2 * w + 1, k] = a1
                base = 2 * w * m_local
                out[k] = np.where(
                    ids == Z, 4 * m_local,
                    base + (ids // m_local - a0) * m_local + ids % m_local,
                )
        levels.append((perms, hloc, tloc, sh))
    return levels


def _tables(a, devs):
    """Per-shard int64 copies of an (L, S, m_local) table on each
    shard's device: ``out[k][lvl]``."""
    return [torch.from_numpy(np.ascontiguousarray(a[:, k])).to(torch.int64)
            .to(dev) for k, dev in enumerate(devs)]


def ffa2_seq(data, mesh=None, axis="seq"):
    """
    FFA transform of an (m, p) array with rows sharded over a mesh axis.

    The same bits as :func:`riptide_tpu_torch.ops.ffa.ffa2` — the
    reference ``libcpp.ffa2`` contract — but the fold container, every
    level and the output are distributed over the ``axis`` axis of
    ``mesh``. Requires ``m`` divisible by
    the axis size and the axis size to be a power of two (pick m
    accordingly; padding rows would change the transform's semantics).

    Returns the full (m, p) float32 result as numpy.
    """
    if mesh is None:
        mesh = seq_mesh()
    S = mesh.shape[axis]
    if S & (S - 1):
        raise ValueError(f"mesh axis {axis!r} size {S} must be a power of two")

    data = np.asarray(data, dtype=np.float32)
    if data.ndim != 2:
        raise ValueError("input data must be two-dimensional")
    m, p = data.shape
    if m % S:
        raise ValueError(f"rows ({m}) must be divisible by the mesh axis size ({S})")
    # Shard k on the first device of the mesh's k-th slice along ``axis``.
    devs = list(np.moveaxis(mesh.devices, mesh.axis_names.index(axis), 0)
                .reshape(S, -1)[:, 0])
    if S == 1 or m == 1:
        return ffa2(data, device=devs[0])
    m_local = m // S
    host = torch.from_numpy(data)
    ys = [ffa_transform_padded(host[k * m_local : (k + 1) * m_local].to(dev),
                               m_local, p) for k, dev in enumerate(devs)]
    wplan = _window_plan(m, S) if S >= 8 else None
    if wplan is not None:
        perms = [lv[0] for lv in wplan]
        hloc, tloc, shift = (_tables(np.stack([lv[i] for lv in wplan]), devs)
                             for i in (1, 2, 3))
        for lvl, pm in enumerate(perms):
            zero = [torch.zeros((1, p), dtype=torch.float32, device=dev)
                    for dev in devs]
            ys = [_merge_rows(
                torch.cat([ys[int(pm[i, k])].to(dev) for i in range(4)]
                          + [zero[k]]),
                hloc[k][lvl], tloc[k][lvl], shift[k][lvl])
                for k, dev in enumerate(devs)]
    else:
        h, t, shift = (_tables(a, devs) for a in _cross_tables(m, S))
        for lvl in range(h[0].shape[0]):
            ys = [_merge_rows(
                torch.cat([y.to(dev) for y in ys]
                          + [torch.zeros((1, p), dtype=torch.float32,
                                         device=dev)]),
                h[k][lvl], t[k][lvl], shift[k][lvl])
                for k, dev in enumerate(devs)]
    return torch.cat([y.cpu() for y in ys]).numpy()
