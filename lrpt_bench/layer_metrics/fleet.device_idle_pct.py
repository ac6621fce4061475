"""Share of the traced chains' wall time with no kernel or copy on the card."""
from lrpt_bench.layer_metrics._common import idle_pct


def read(ctx):
    return idle_pct(ctx)
