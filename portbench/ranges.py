"""
A configuration's search ranges. riptide's pipeline searches every DM
trial over each range its configuration lists (``ranges`` in
``riptide/pipeline/config/example.yaml``), and a configuration file here
may list them too: ``"ranges"``, a list of objects, each holding
``name`` and :data:`RANGE_KEYS`. The series' keys (``nsamp``, ``tsamp``,
``wire``, ``compute``) stay at the top and every range shares them.

A configuration without ``ranges`` is one range, unnamed, built from its
top-level keys: it runs, and its compared numbers are named, as they
were before ranges existed.
"""

__all__ = ["RANGE_KEYS", "ranges"]

RANGE_KEYS = ("period_min", "period_max", "bins_min", "bins_max", "fpmin",
              "ducy_max", "wtsp", "find_peaks", "pulsar_period")


def ranges(cfg):
    """[(name, the range's configuration)] in the configuration's order:
    the top-level keys with the range's own in place of any of
    :data:`RANGE_KEYS`. The name is None for a configuration without
    ``ranges``, whose one range is ``cfg`` itself. KeyError where a
    range lacks a key, ValueError where two share a name."""
    if "ranges" not in cfg:
        return [(None, cfg)]
    names = [r["name"] for r in cfg["ranges"]]
    if not names or len(set(names)) != len(names):
        raise ValueError(f"ranges need distinct names: {names}")
    top = {k: v for k, v in cfg.items()
           if k != "ranges" and k not in RANGE_KEYS}
    return [(r["name"], dict(top, **{k: r[k] for k in RANGE_KEYS}))
            for r in cfg["ranges"]]
