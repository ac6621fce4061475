"""The chains' least time on the card (work/demod.py: int16 samples read
once, int8 I, Q, valid and lock bytes written once a symbol, the FIR's
multiply-adds, OPS_PER_FIRE a fire) over the union of device time in them."""
from lrpt_bench.layer_metrics._common import roofline_pct
from lrpt_bench.work.demod import counts


def read(ctx):
    w = ctx["window"]
    return roofline_pct(ctx, counts(ctx["run"].cfg, w["samples"],
                                    w["symbols"], 4))
