"""mfu_pct.fit: the products of the window's fit units
(``counts/bcpnn.py``: every product's 2·M·N·K over genuine rows) over
the window's host time, as a share of the card's dense TF32 peak, %."""
from counts import peaks


def read(r):
    units = [u for u in r.units if "flops" in u]
    if not units:
        return None
    flops = sum(u["flops"] for u in units)
    return 100.0 * flops / r.window_s / peaks.PEAK_TF32_FLOP_S
