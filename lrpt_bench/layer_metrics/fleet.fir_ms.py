"""Device ms of the matched filter's kernels (the `fir` layer) a block."""
from lrpt_bench.layer_metrics._common import per_call


def read(ctx):
    v = per_call(ctx, "fir")
    if not len(v) or v.sum() <= 0:
        return None
    return float(v.mean() * 1e3 / ctx["run"].mix["chain_blocks"])
