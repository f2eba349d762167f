"""
Host-side planning of the FFA transform (numpy).

The reference implements the FFA as a recursive divide-in-half of the row
axis (riptide/cpp/transforms.hpp:30-50). The port executes the same
computation *iteratively* as ``L = ceil(log2(m))`` data-parallel levels
over an (R, P) buffer: at each level, every output row is

    out[i] = buf[h[i]] + roll(buf[t[i]], -shift[i])

where (h, t, shift) are integer tables precomputed here on the host. The
CUDA level kernel (``csrc/ffa_stage.cu``) and the plain PyTorch
``ops.ffa.ffa_levels`` both execute these tables directly.

Scheduling: a tree node at depth d from the root performs its merge at
level ``L - d`` (levels are 1-indexed; level 1 runs first). Rows of nodes
that are already complete (single-row leaves) are carried unchanged
through intervening levels via identity entries that add a guaranteed
all-zero row: every plan assumes the working buffer has ``R >= m + 1``
rows with row ``R - 1`` ("Z") held at zero. Padding rows in [m, R-1) also
map to Z so they stay zero, which is what lets many differently-sized
problems share one container (see FFABatchPlan).

Row packing: a container may also hold a second, "guest" trial of the
same p from a later cascade stage in rows the host trial leaves dead,
from the guest's base row up (:func:`pair_bucket_bases`). The guest's
own tables are shifted up by its base, and its zero row is the
container's Z, so the two trials share every level launch and neither
reads the other's rows.

Segments: a node merges at its own level from rows inside the node, so
the leading levels whose nodes all fit a tile of shared memory never
read outside it. :func:`segment_plan` finds how many levels that is for
a container and cuts its rows into tiles; the CUDA segment kernel runs
those levels in shared memory, one block per tile, and the level kernel
runs the rest.
"""
from functools import lru_cache
import threading
from typing import NamedTuple

import numpy as np

from ..utils.exec_cache import count_warmth
from ..utils.limits import MAX_DYNAMIC_SMEM
from .reference import _merge_mapping

__all__ = ["ffa_plan", "FFAPlan", "FFABatchPlan", "batch_plans", "num_levels",
           "CONTRACT_PLANS", "contract_plan_params",
           "pair_bucket_bases", "SegmentPlan", "segment_plan"]



# Representative search plans whose launch contracts the port pins
# (``riptide_tpu_torch/analysis/launch_contract.py``,
# ``python -m riptide_tpu_torch.apps.rprove``,
# ``riptide_tpu_torch/analysis/plan_contracts.json``): the JAX package's
# set (``riptide_tpu/ops/plan.py::CONTRACT_PLANS``), the same three
# specs and tiers. ``path`` names the JAX package's formulation; the
# port's path follows from the wire (a quantised wire runs K1/K3, the
# float32 wire K2). The two tiny plans share one geometry; the
# ``slow`` tier adds a survey-shaped plan (``rprove --all``).
CONTRACT_PLANS = (
    {"name": "tiny-gather", "tier": "fast", "path": "gather",
     "wire": "float32", "size": 2048, "tsamp": 0.01, "widths": (1, 2),
     "period_min": 1.0, "period_max": 2.0, "bins_min": 16,
     "bins_max": 24},
    {"name": "tiny-fused", "tier": "fast", "path": "kernel",
     "wire": "uint6", "size": 2048, "tsamp": 0.01, "widths": (1, 2),
     "period_min": 1.0, "period_max": 2.0, "bins_min": 16,
     "bins_max": 24},
    {"name": "survey-fused", "tier": "slow", "path": "kernel",
     "wire": "uint6", "size": 16000, "tsamp": 1e-3,
     "widths": (1, 2, 3), "period_min": 0.3, "period_max": 1.2,
     "bins_min": 64, "bins_max": 71},
)


def contract_plan_params(names=None, tiers=("fast",)):
    """The contract plan specs: by ``names`` (an unknown name raises
    KeyError, so a stale list fails loudly), else by tier."""
    specs = [dict(s) for s in CONTRACT_PLANS]
    if names:
        wanted = set(names)
        unknown = wanted - {s["name"] for s in specs}
        if unknown:
            raise KeyError(
                f"unknown contract plan name(s) {sorted(unknown)}; "
                f"known: {[s['name'] for s in specs]}"
            )
        return [s for s in specs if s["name"] in wanted]
    return [s for s in specs if s["tier"] in tiers]

def num_levels(m):
    """Number of merge levels for an m-row transform: ceil(log2(m)), 0 for m=1."""
    if m <= 1:
        return 0
    return int(np.ceil(np.log2(m)))


def pair_bucket_bases(ms_host, ms_guest, L, rows, skip=()):
    """Per-trial guest base rows for embedding guest trial j
    (``ms_guest[j]`` rows) into host trial j's ``rows``-row container at
    depth ``L`` (:func:`~.slottables.guest_base`), or None if any needed
    trial has no feasible base or no trial needs one. Positions in
    ``skip`` (padding trials, trials with no evaluated rows) get None.
    The JAX package's ``ops/plan.py::pair_bucket_bases``."""
    from .slottables import guest_base

    bases = []
    for j, (mh, mg) in enumerate(zip(ms_host, ms_guest)):
        if j in skip:
            bases.append(None)
            continue
        gb = guest_base(mh, mg, L, rows)
        if gb is None:
            return None
        bases.append(gb)
    if not any(b is not None for b in bases):
        return None
    return tuple(bases)


@lru_cache(maxsize=4096)
def _merge_tables(mn):
    """:func:`_merge_mapping` of an mn-row node, cached by size (a tree
    has at most two node sizes per depth)."""
    return _merge_mapping(mn)


class FFAPlan:
    """
    Level tables for one m-row FFA transform.

    Attributes
    ----------
    m : int
        Number of rows of the transform.
    levels : int
        Number of merge levels, ceil(log2(m)).
    h, t, shift : ndarray of int32, shape (levels, m + 1)
        Per-level gather tables over an (m + 1)-row buffer whose last row
        is held at zero. Row i of level l output is
        ``buf[h[l, i]] + roll(buf[t[l, i]], -shift[l, i])``.
    """

    def __init__(self, m):
        m = int(m)
        L = num_levels(m)
        R = m + 1
        Z = m
        # Identity-carry default: out[i] = buf[i] + buf[Z] (zero row).
        h = np.tile(np.arange(R, dtype=np.int32), (L, 1))
        t = np.full((L, R), Z, dtype=np.int32)
        shift = np.zeros((L, R), dtype=np.int32)
        # The zero row must reproduce itself at every level.
        if L:
            h[:, Z] = Z

        def fill(r0, mn, level):
            # Merge of the node occupying buffer rows [r0, r0 + mn) happens
            # at `level` (1-based); its children merge one level earlier.
            if mn == 1:
                return
            mh = mn // 2
            fill(r0, mh, level - 1)
            fill(r0 + mh, mn - mh, level - 1)
            hh, tt, ss = _merge_tables(mn)
            l = level - 1
            h[l, r0 : r0 + mn] = r0 + hh
            t[l, r0 : r0 + mn] = r0 + mh + tt
            shift[l, r0 : r0 + mn] = ss

        fill(0, m, L)
        self.m = m
        self.levels = L
        self.h = h
        self.t = t
        self.shift = shift


@lru_cache(maxsize=512)
def ffa_plan(m):
    """Cached :class:`FFAPlan` for an m-row transform."""
    return FFAPlan(m)


class FFABatchPlan:
    """
    A batch of B differently-shaped FFA problems padded into one
    (B, R, P)-shaped container so they execute as one set of launches.

    Problem b folds ``m[b]`` rows of ``p[b]`` phase bins; the container has
    ``R >= max(m) + 1`` rows (last row zero) and ``P >= max(p)`` columns.
    Shallower plans are padded with identity levels at the end.

    ``guests`` (optional, one entry per problem): ``(m_guest, base)`` to
    fold a second ``m_guest``-row problem of the same p in rows
    ``[base, base + m_guest)`` of problem b's plane, or None. Needs
    ``base >= m[b]`` and ``base + m_guest <= R - 1``.

    Attributes (all numpy, ready to ship to the device):
    h, t, shift : (L, B, R) int32 level tables
    m, p : (B,) int32 problem dimensions
    gm, gbase : (B,) int32 guest rows and base row (0 and -1 for no
        guest); None without ``guests``
    """

    def __init__(self, ms, ps, R=None, P=None, L=None, guests=None):
        ms = [int(m) for m in ms]
        ps = [int(p) for p in ps]
        if len(ms) != len(ps):
            raise ValueError("ms and ps must have equal length")
        B = len(ms)
        Rmin = max(ms) + 1
        R = Rmin if R is None else int(R)
        if R < Rmin:
            raise ValueError("R must be >= max(m) + 1")
        P = max(ps) if P is None else int(P)
        if P < max(ps):
            raise ValueError("P must be >= max(p)")
        Lmin = max(num_levels(m) for m in ms)
        if guests is not None:
            if len(guests) != B:
                raise ValueError("guests must have one entry per problem")
            Lmin = max([Lmin] + [num_levels(g[0]) for g in guests if g])
        # Extra levels beyond a problem's own depth are identity carries.
        L = Lmin if L is None else int(L)
        if L < Lmin:
            raise ValueError("L must be >= the deepest problem's level count")
        Z = R - 1

        h = np.tile(np.arange(R, dtype=np.int32), (L, B, 1))
        t = np.full((L, B, R), Z, dtype=np.int32)
        shift = np.zeros((L, B, R), dtype=np.int32)
        for b, m in enumerate(ms):
            plan = ffa_plan(m)
            lb = plan.levels
            if lb:
                h[:lb, b, : m + 1] = plan.h
                t[:lb, b, : m + 1] = plan.t
                shift[:lb, b, : m + 1] = plan.shift
                # plan's zero row is index m; remap to the container's Z.
                h[:lb, b, : m + 1] = np.where(
                    h[:lb, b, : m + 1] == m, Z, h[:lb, b, : m + 1]
                )
                t[:lb, b, : m + 1] = np.where(
                    t[:lb, b, : m + 1] == m, Z, t[:lb, b, : m + 1]
                )
            # Padding rows [m, R) map to the zero row so they stay zero.
            h[:, b, m:] = Z
        gm = gbase = None
        if guests is not None:
            gm = np.zeros(B, np.int32)
            gbase = np.full(B, -1, np.int32)
            for b, g in enumerate(guests):
                if g is None:
                    continue
                mg, base = int(g[0]), int(g[1])
                if not (ms[b] <= base and base + mg <= Z):
                    raise ValueError(
                        f"guest of {mg} rows at base {base} does not fit "
                        f"between host rows {ms[b]} and the zero row {Z}")
                gm[b], gbase[b] = mg, base
                rows = slice(base, base + mg)
                # Identity carry for the guest's rows, then its own levels
                # shifted up by `base`; its zero row (index mg) is Z.
                h[:, b, rows] = np.arange(base, base + mg, dtype=np.int32)
                plan = ffa_plan(mg)
                lg = plan.levels
                if lg:
                    for tab, src in ((h, plan.h), (t, plan.t)):
                        src = src[:, :mg]
                        tab[:lg, b, rows] = np.where(src == mg, Z, src + base)
                    shift[:lg, b, rows] = plan.shift[:, :mg]

        self.B = B
        self.R = R
        self.P = P
        self.L = L
        self.h = h
        self.t = t
        self.shift = shift
        self.m = np.asarray(ms, dtype=np.int32)
        self.p = np.asarray(ps, dtype=np.int32)
        self.gm = gm
        self.gbase = gbase

    @property
    def segments(self):
        """This container's :class:`SegmentPlan` (:func:`segment_plan`),
        built once at first use (under concurrent job threads too) and
        kept; a build counts ``exec_cold_builds``, a reuse
        ``exec_warm_hits``."""
        with _SEGMENTS_LOCK:
            seg = getattr(self, "_segments", None)
            fresh = seg is None
            if fresh:
                seg = self._segments = segment_plan(self)
        count_warmth(fresh)
        return seg


def batch_plans(ms, ps, R=None, P=None):
    """Build an :class:`FFABatchPlan` for problems of shapes zip(ms, ps)."""
    return FFABatchPlan(ms, ps, R=R, P=P)


_SEGMENTS_LOCK = threading.Lock()


class SegmentPlan(NamedTuple):
    """How a container's levels split between the segment kernel and
    the level kernel.

    ``levels`` (Lloc): the leading levels that run tile by tile in
    shared memory; levels Lloc + 1 .. L run over the whole container.
    ``tiles`` (ntiles, 4) int32, one row per tile: plane b, first row,
    rows, and 1 for a tile of live rows (filled from the trial's data,
    then Lloc levels) or 0 for a run of dead rows (written zero). The
    tiles of each plane cover its R rows once, in order. ``smem``: the
    bytes of shared memory a block of live rows needs, two float32
    buffers of rows x p."""
    levels: int
    tiles: np.ndarray
    smem: int


def _live_rows(b):
    """(B, R) bool: the rows of each plane that hold a trial's data (the
    host's m rows and the guest's); the others stay zero."""
    rows = np.arange(b.R)
    live = rows < b.m[:, None]
    if b.gbase is not None:
        gb = b.gbase[:, None]
        live |= (gb >= 0) & (rows >= gb) & (rows < gb + b.gm[:, None])
    return live


def segment_plan(b):
    """The :class:`SegmentPlan` of :class:`FFABatchPlan` ``b``, derived
    from its level tables.

    A plane of phase width p fits tiles of ``cap = MAX_DYNAMIC_SMEM //
    (8 p)`` rows (two float32 buffers in an H100 block's opt-in shared
    memory). After l levels a row depends on the rows of its node; those
    spans are carried level by level through the tables (the zero row is
    no dependency), and Lloc is the last level at which every live row's
    span fits its plane's cap. The spans at Lloc are the closed nodes
    (segments); a tile takes as many whole segments of one run of live
    rows as fit the cap, and dead rows go in zero tiles of at most cap
    rows.

    Where some plane's cap is below two rows (p > 14,528), no level fits
    a tile: Lloc is 0, every row is a tile of its own (filled straight
    into the container by the segment kernel's direct form, no shared
    memory) and every level runs over the whole container."""
    L, B, R = b.h.shape
    Z = R - 1
    cap = MAX_DYNAMIC_SMEM // (8 * b.p.astype(np.int64))
    live = _live_rows(b)
    if (cap < 2).any():
        plane, row = np.divmod(np.arange(B * R), R)
        tiles = np.stack([plane, row, np.ones_like(row), live.ravel()], 1)
        return SegmentPlan(0, tiles.astype(np.int32), 0)
    rows = np.arange(R, dtype=np.int32)
    # Spans [lo, hi] of the rows each row depends on, flat over (B, R);
    # the zero row's span is empty (lo = R, hi = -1).
    base = (np.arange(B, dtype=np.int32) * R)[:, None]
    lo = np.broadcast_to(rows, (B, R)).copy()
    hi = lo.copy()
    lo[:, Z], hi[:, Z] = R, -1
    levels = 0
    for l in range(L):
        hl, tl = (b.h[l] + base).ravel(), (b.t[l] + base).ravel()
        nlo = np.minimum(lo.ravel()[hl], lo.ravel()[tl]).reshape(B, R)
        nhi = np.maximum(hi.ravel()[hl], hi.ravel()[tl]).reshape(B, R)
        nlo[:, Z], nhi[:, Z] = R, -1
        size = np.maximum(nhi, rows) - np.minimum(nlo, rows) + 1
        if (live & (size > cap[:, None])).any():
            break
        lo, hi, levels = nlo, nhi, l + 1
    first = np.minimum(lo, rows)
    size = np.maximum(hi, rows) - first + 1
    tiles, smem = [], 0
    for j in range(B):
        c, p = int(cap[j]), int(b.p[j])
        edges = np.flatnonzero(np.diff(np.concatenate(
            ([0], live[j].view(np.int8), [0]))))
        per = max(1, c // int(size[j][live[j]].max()))
        dead = 0
        for a, e in zip(edges[::2], edges[1::2]):
            tiles += [(j, r, min(c, a - r), 0) for r in range(dead, a, c)]
            starts = a + np.flatnonzero(first[j, a:e] == rows[a:e])
            cuts = np.append(starts[::per], e)
            tiles += [(j, r, n, 1) for r, n in zip(cuts[:-1].tolist(),
                                                  np.diff(cuts).tolist())]
            smem = max(smem, 8 * p * int(np.diff(cuts).max()))
            dead = e
        tiles += [(j, r, min(c, R - r), 0) for r in range(dead, R, c)]
    return SegmentPlan(levels, np.asarray(tiles, np.int32).reshape(-1, 4),
                       smem)
