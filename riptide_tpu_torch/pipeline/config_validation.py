"""
YAML pipeline configuration validation.

Same config surface and semantic checks as the reference
(riptide/pipeline/config_validation.py:19-198), implemented with a small
internal declarative validator instead of the external ``schema``
library (not available in this environment, and a ~60-line validator
covers everything the config needs: type coercion, predicates,
optional-with-None fields, nested dicts and lists).
"""

__all__ = [
    "InvalidSearchRange",
    "InvalidPipelineConfig",
    "validate_pipeline_config",
    "validate_range",
    "validate_ranges_contiguity",
    "validate_ranges",
]


class InvalidSearchRange(Exception):
    pass


class InvalidPipelineConfig(Exception):
    pass


# ----------------------------------------------------------------------------
# Mini declarative validator
# ----------------------------------------------------------------------------

class Field:
    """One config value: coercing type check + optional predicate.

    coerce : callable applied to the raw value (e.g. float accepts ints)
    pred : predicate on the coerced value
    optional : key may be absent (defaults to ``default``)
    nullable : explicit None/blank is accepted and kept as None
    """

    def __init__(self, coerce, pred=None, error="invalid value",
                 optional=False, nullable=False):
        self.coerce = coerce
        self.pred = pred
        self.error = error
        self.optional = optional
        self.nullable = nullable

    def validate(self, value, path):
        if value is None:
            if self.nullable:
                return None
            raise InvalidPipelineConfig(f"{path}: {self.error}")
        try:
            coerced = self.coerce(value)
        except (TypeError, ValueError):
            raise InvalidPipelineConfig(f"{path}: {self.error}") from None
        if self.pred is not None and not self.pred(coerced):
            raise InvalidPipelineConfig(f"{path}: {self.error}")
        return coerced


class Section:
    """An optional nested mapping with its own spec: absent -> omitted
    entirely (downstream code applies its own defaults), present ->
    validated like any required mapping."""

    def __init__(self, spec):
        self.spec = spec


def _strict_int(x):
    # bool is an int subclass; YAML ints must stay ints
    if isinstance(x, bool) or not isinstance(x, int):
        raise TypeError("not an int")
    return x


def _strict_bool(x):
    if not isinstance(x, bool):
        raise TypeError("not a bool")
    return x


def _number(x):
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        raise TypeError("not a number")
    return float(x)


def _validate_mapping(spec, conf, path=""):
    if not isinstance(conf, dict):
        raise InvalidPipelineConfig(f"{path or 'config'}: must be a mapping")
    out = {}
    for key, sub in spec.items():
        kpath = f"{path}.{key}" if path else key
        if key not in conf:
            # Optional keys are omitted entirely so downstream **kwargs
            # expansion picks up the function defaults (the reference's
            # schema.Optional has the same effect).
            if isinstance(sub, (Field, Section)) and \
                    getattr(sub, "optional", True):
                continue
            raise InvalidPipelineConfig(f"{kpath}: missing required key")
        val = conf[key]
        if isinstance(sub, Field):
            out[key] = sub.validate(val, kpath)
        elif isinstance(sub, Section):
            out[key] = _validate_mapping(sub.spec, val, kpath)
        elif isinstance(sub, dict):
            out[key] = _validate_mapping(sub, val, kpath)
        elif isinstance(sub, list):
            if not isinstance(val, list) or not val:
                raise InvalidPipelineConfig(f"{kpath}: must be a non-empty list")
            out[key] = [
                _validate_mapping(sub[0], item, f"{kpath}[{i}]")
                for i, item in enumerate(val)
            ]
        else:  # pragma: no cover
            raise AssertionError(f"bad spec node at {kpath}")
    unknown = set(conf) - set(spec)
    if unknown:
        raise InvalidPipelineConfig(
            f"{path or 'config'}: unknown key(s) {sorted(unknown)}"
        )
    return out


# ----------------------------------------------------------------------------
# The pipeline config schema (values and defaults mirror the reference)
# ----------------------------------------------------------------------------

VALID_FORMATS = ("presto", "sigproc")

_pos = lambda x: x > 0

SEARCH_RANGE_SPEC = {
    "name": Field(str, error="name must be a string"),
    "ffa_search": {
        "period_min": Field(_number, _pos, "period_min must be a number > 0"),
        "period_max": Field(_number, _pos, "period_max must be a number > 0"),
        "bins_min": Field(_strict_int, _pos, "bins_min must be an int > 0"),
        "bins_max": Field(_strict_int, _pos, "bins_max must be an int > 0"),
        "fpmin": Field(_strict_int, _pos, "fpmin must be an int > 0", optional=True),
        "wtsp": Field(_number, lambda x: x > 1, "wtsp must be a number > 1", optional=True),
        "ducy_max": Field(
            _number, lambda x: 0 < x < 1,
            "ducy_max must be strictly between 0 and 1", optional=True,
        ),
    },
    "find_peaks": {
        "smin": Field(_number, _pos, "smin must be a number > 0", optional=True),
        "segwidth": Field(_number, _pos, "segwidth must be a number > 0", optional=True),
        "nstd": Field(_number, _pos, "nstd must be a number > 0", optional=True),
        "minseg": Field(_strict_int, _pos, "minseg must be an int > 0", optional=True),
        "polydeg": Field(_strict_int, _pos, "polydeg must be an int > 0", optional=True),
        "clrad": Field(_number, _pos, "clrad must be a number > 0", optional=True, nullable=True),
    },
    "candidates": {
        "bins": Field(_strict_int, _pos, "candidates.bins must be an int > 0"),
        "subints": Field(_strict_int, _pos, "candidates.subints must be an int > 0"),
    },
}

PIPELINE_CONFIG_SPEC = {
    "processes": Field(_strict_int, _pos, "processes must be an int > 0"),
    "data": {
        "format": Field(
            str, lambda x: x in VALID_FORMATS,
            f"format must be one of {VALID_FORMATS}",
        ),
        "fmin": Field(_number, _pos, "fmin must be a number > 0 or null/blank", nullable=True),
        "fmax": Field(_number, _pos, "fmax must be a number > 0 or null/blank", nullable=True),
        "nchans": Field(_strict_int, _pos, "nchans must be an int > 0 or null/blank", nullable=True),
    },
    "dmselect": {
        "min": Field(_number, None, "Minimum DM must be a number or null/blank", nullable=True),
        "max": Field(_number, None, "Maximum DM must be a number or null/blank", nullable=True),
        "dmsinb_max": Field(
            _number, _pos, "dmsinb_max must be a number > 0 or null/blank", nullable=True
        ),
    },
    "dereddening": {
        "rmed_width": Field(_number, _pos, "rmed_width must be a number > 0"),
        "rmed_minpts": Field(_number, _pos, "rmed_minpts must be a number > 0"),
    },
    # Optional degraded-input handling (riptide_tpu_torch.quality); omitted
    # keys fall back to the DQConfig / BatchSearcher defaults.
    "data_quality": Section({
        "enabled": Field(_strict_bool, error="enabled must be a boolean",
                         optional=True),
        "max_masked_frac": Field(
            _number, lambda x: 0 <= x <= 1,
            "max_masked_frac must be a number in [0, 1]", optional=True,
        ),
        "ingest_policy": Field(
            str, lambda x: x in ("strict", "salvage", "skip"),
            "ingest_policy must be 'strict', 'salvage' or 'skip'",
            optional=True,
        ),
        "clip_run_min": Field(_strict_int, _pos,
                              "clip_run_min must be an int > 0", optional=True),
        "dead_run_min": Field(_strict_int, _pos,
                              "dead_run_min must be an int > 0", optional=True),
        "dc_block": Field(_strict_int, _pos,
                          "dc_block must be an int > 0", optional=True),
        "dc_nstd": Field(_number, _pos,
                         "dc_nstd must be a number > 0 or null/blank",
                         optional=True, nullable=True),
        "oom_floor": Field(_strict_int, _pos,
                           "oom_floor must be an int > 0", optional=True),
    }),
    # Optional liveness layer (the JAX package's survey.liveness): watchdog
    # deadlines around chunk dispatch, a total retry budget and a
    # circuit breaker that parks persistently failing chunks. Omitted
    # keys fall back to the ChunkWatchdog / RetryPolicy /
    # CircuitBreaker defaults; the section only takes effect for
    # journaled (--journal) runs, which are the long-lived ones.
    "liveness": Section({
        "enabled": Field(_strict_bool, error="enabled must be a boolean",
                         optional=True),
        "watchdog_k": Field(_number, lambda x: x > 1,
                            "watchdog_k must be a number > 1",
                            optional=True),
        "watchdog_floor_s": Field(_number, _pos,
                                  "watchdog_floor_s must be a number > 0",
                                  optional=True),
        "watchdog_cap_s": Field(_number, _pos,
                                "watchdog_cap_s must be a number > 0",
                                optional=True),
        "watchdog_initial_s": Field(
            _number, _pos,
            "watchdog_initial_s must be a number > 0 or null/blank",
            optional=True, nullable=True,
        ),
        "retry_deadline_s": Field(
            _number, _pos,
            "retry_deadline_s must be a number > 0 or null/blank",
            optional=True, nullable=True,
        ),
        "breaker_threshold": Field(
            _strict_int, _pos, "breaker_threshold must be an int > 0",
            optional=True,
        ),
        "breaker_cooldown_s": Field(
            _number, _pos, "breaker_cooldown_s must be a number > 0",
            optional=True,
        ),
    }),
    "ranges": [SEARCH_RANGE_SPEC],
    "clustering": {
        "radius": Field(_number, _pos, "clustering radius must be a number > 0"),
    },
    "harmonic_flagging": {
        "denom_max": Field(_strict_int, _pos, "denom_max must be an int > 0"),
        "phase_distance_max": Field(_number, _pos, "phase_distance_max must be a number > 0"),
        "dm_distance_max": Field(_number, _pos, "dm_distance_max must be a number > 0"),
        "snr_distance_max": Field(_number, _pos, "snr_distance_max must be a number > 0"),
    },
    "candidate_filters": {
        "dm_min": Field(_number, None, "Candidate dm_min must be a number or null/blank", nullable=True),
        "snr_min": Field(_number, None, "Candidate snr_min must be a number or null/blank", nullable=True),
        "remove_harmonics": Field(
            _strict_bool, None, "remove_harmonics must be a boolean or null/blank", nullable=True
        ),
        "max_number": Field(
            _strict_int, _pos, "Candidate max_number must be an int > 0 or null/blank", nullable=True
        ),
    },
    "plot_candidates": Field(_strict_bool, error="plot_candidates must be a boolean"),
}


# ----------------------------------------------------------------------------
# Semantic checks against the actual data
# ----------------------------------------------------------------------------

def validate_range(rg, tsamp_max):
    """Fail fast on ranges the data cannot support
    (riptide/pipeline/config_validation.py:117-137)."""
    period_min = rg["ffa_search"]["period_min"]
    period_max = rg["ffa_search"]["period_max"]
    bins_min = rg["ffa_search"]["bins_min"]
    cand_bins = rg["candidates"]["bins"]

    if bins_min * tsamp_max > period_min:
        raise InvalidSearchRange(
            f"Search range {period_min:.3e} to {period_max:.3e} seconds: requested "
            "phase resolution is too high w.r.t. coarsest input time series "
            f"(tsamp = {tsamp_max:.3e} seconds). Use smaller bins_min or larger period_min."
        )
    if cand_bins * tsamp_max > period_min:
        raise InvalidSearchRange(
            f"Search range {period_min:.3e} to {period_max:.3e} seconds: cannot fold "
            f"candidates with {cand_bins:d} bins; the coarsest input time series "
            f"(tsamp = {tsamp_max:.3e} seconds) does not allow it."
        )


def validate_ranges_contiguity(ranges):
    """Ranges must be ordered by period and partition a contiguous span
    (riptide/pipeline/config_validation.py:140-148)."""
    for a, b in zip(ranges[:-1], ranges[1:]):
        pmax_a = a["ffa_search"]["period_max"]
        pmin_b = b["ffa_search"]["period_min"]
        if pmax_a != pmin_b:
            raise InvalidSearchRange(
                "Search ranges are either non-contiguous or not ordered by "
                f"increasing trial period (period_max ({pmax_a:.6e}) != "
                f"next period_min ({pmin_b:.6e}))"
            )


def validate_ranges(ranges, tsamp_max):
    """Check all search ranges against the coarsest input sampling time."""
    for rg in ranges:
        validate_range(rg, tsamp_max)
    validate_ranges_contiguity(ranges)


def validate_pipeline_config(conf):
    """
    Validate the configuration dict (format and types only; semantic checks
    against the data happen in :func:`validate_ranges`). Returns the
    validated dict with numeric coercions applied.
    """
    return _validate_mapping(PIPELINE_CONFIG_SPEC, conf)
