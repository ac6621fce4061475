"""Host time serial with the card in a fleet chain: each chain's wall time
less the union of device intervals inside it, mean ms a chain."""
from lrpt_bench.layer_metrics._common import per_call, walls


def read(ctx):
    if not ctx["calls"]:
        return None
    return float((walls(ctx) - per_call(ctx)).mean() * 1e3)
