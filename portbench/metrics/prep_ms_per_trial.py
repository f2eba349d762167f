"""Host wire prep: milliseconds of ``prepare_stage_data`` a DM trial,
over the ring's chunks prepared in set-up (harness timer)."""


def read(rec):
    host = rec["host"]
    if not host["prep_s"] or not host["prep_trials"]:
        return None
    return 1e3 * sum(host["prep_s"]) / host["prep_trials"]
