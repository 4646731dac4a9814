"""Model step: the model FLOPs the window's prefill and decode calls
needed (benchlib/counts.py, from the configuration's sizes and the
batches' shapes), over their summed wall time times the card's dense
bf16 peak, in %."""
from benchlib.counts import PEAK_OPS_S
from benchlib.readers import step_mfu


def read(run):
    return step_mfu(run, PEAK_OPS_S["bfloat16"])
