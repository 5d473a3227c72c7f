"""The model work of the window's ticks and queries (work.py's formulas
from the cell's shapes) over the window's length times the card's
published float32 peak, in percent.  The port runs float32 with TF32 off;
the card's power limit is reported beside it in the result's device."""


def read(run):
    if not run.ticks or run.flops <= 0:
        return None
    return 100.0 * run.flops / (run.window_s * run.work.PEAK_F32_FLOPS)
