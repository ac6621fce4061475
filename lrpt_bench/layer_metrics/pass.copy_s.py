"""Device s of host<->card copies (the `copy` layer) a pass."""
from lrpt_bench.layer_metrics._common import per_call


def read(ctx):
    v = per_call(ctx, "copy")
    return float(v.mean()) if len(v) and v.sum() > 0 else None
