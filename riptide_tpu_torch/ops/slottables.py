"""
Container heights and row-pack feasibility (numpy), copied from the JAX
package's ``ops/slotffa.py`` (:func:`node_sizes`) and
``ops/slottables.py`` (:func:`container_forms`, :func:`container_rows`,
:func:`guest_base`, ``NAT_LEVELS``).

The port's kernels run the (h, t, shift) tables of :mod:`.plan` directly
and need none of the TPU's slot layout. These functions stay because the
port makes the same container and pairing decisions as the JAX package:
the lane bucket heights the container flags select, and which later
stage's trials ride an earlier stage's dead container rows.
"""
import numpy as np

__all__ = ["node_sizes", "container_forms", "container_rows", "guest_base",
           "NAT_LEVELS"]

NAT_LEVELS = 3      # levels the TPU kernel runs in natural row layout


def _bitrev(k, d):
    """Reverse the low d bits of (array) k."""
    k = np.asarray(k)
    out = np.zeros_like(k)
    for i in range(d):
        out |= ((k >> i) & 1) << (d - 1 - i)
    return out


def node_sizes(m, d):
    """Row counts of all 2**d depth-d nodes of an m-row FFA tree, in slot
    order: size(d, k) = (m + bitrev_d(k)) >> d."""
    k = np.arange(1 << d, dtype=np.int64)
    return (m + _bitrev(k, d)) >> d


def container_forms(L, extended=False):
    """Legal container heights at bucket depth L, ascending: {2**L,
    3 * 2**(L-2)} (the latter from L >= 5), plus 5 and 7 * 2**(L-3)
    from L >= 6 when ``extended`` (the row-pack family)."""
    forms = []
    if extended and L >= 6:
        forms.append(5 << (L - 3))
    if L >= 5:
        forms.append(3 << (L - 2))
    if extended and L >= 6:
        forms.append(7 << (L - 3))
    forms.append(1 << L)
    return forms


def container_rows(m, L, extended=False):
    """Container height for an m-row problem at bucket depth L: the
    smallest form of :func:`container_forms` holding m rows."""
    for rows in container_forms(L, extended):
        if rows >= m:
            return rows
    return 1 << L


def guest_base(m_host, m_guest, L, rows):
    """Smallest base row at which an m_guest-row problem can share an
    m_host-row problem's ``rows``-row container at depth L, or None.

    The TPU kernel's slot layout puts the guest's depth-d nodes at
    offset ``base >> d`` inside the depth-d slots, so the base must
    clear the host's largest depth-d node at every depth the kernel
    spreads, and the guest's largest node must fit above it. The port
    keeps the rule so that it pairs exactly what the JAX package pairs;
    its own tables need only ``base >= m_host`` and ``base + m_guest <=
    rows``, which this implies."""
    m_host, m_guest, rows = int(m_host), int(m_guest), int(rows)
    if m_host < 1 or m_guest < 1:
        return None
    NL = min(L, NAT_LEVELS)
    D0 = L - NL
    base = m_host
    for d in range(D0 + 1):
        base = max(base, int(node_sizes(m_host, d).max()) << d)
    if base + m_guest > rows:
        return None
    for d in range(D0 + 1):
        if (base >> d) + int(node_sizes(m_guest, d).max()) > (rows >> d):
            return None
    return base
