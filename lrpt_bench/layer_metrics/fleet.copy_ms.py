"""Device ms of host<->card copies (the kernel map's `copy` layer) a chain."""
from lrpt_bench.layer_metrics._common import per_call


def read(ctx):
    v = per_call(ctx, "copy")
    return float(v.mean() * 1e3) if len(v) and v.sum() > 0 else None
