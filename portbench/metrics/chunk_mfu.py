"""The whole chunk's share of the card's peak: the plan's operations of
every chunk of the window (``portbench/roofline.py``) over the window's
wall time and the float32 peak, in %. It bounds what the window's
search does, whichever kernels do it."""
from portbench.roofline import PEAK_OPS_PER_S


def read(rec):
    if not rec["chunks"] or rec["window_s"] <= 0:
        return None
    return (100.0 * rec["chunks"] * rec["work"]["ops"]
            / (PEAK_OPS_PER_S * rec["window_s"]))
