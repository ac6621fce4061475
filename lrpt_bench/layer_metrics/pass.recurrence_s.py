"""Device s of the recurrence kernels (the `recurrence` layer) a pass."""
from lrpt_bench.layer_metrics._common import per_call


def read(ctx):
    v = per_call(ctx, "recurrence")
    return float(v.mean()) if len(v) and v.sum() > 0 else None
