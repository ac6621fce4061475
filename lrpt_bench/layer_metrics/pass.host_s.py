"""Host time of a pass (CLI, ingest, writer, turbo's host work): each
pass's wall time less the union of device intervals inside it, mean s."""
from lrpt_bench.layer_metrics._common import per_call, walls


def read(ctx):
    if not ctx["calls"]:
        return None
    return float((walls(ctx) - per_call(ctx)).mean())
