"""The card's idle s a pass in none of the program's stage spans
(_spans.PASS_STAGES): cli.main's own time, the harness."""
from lrpt_bench.layer_metrics._spans import PASS_STAGES, unattributed_idle


def read(ctx):
    return unattributed_idle(
        ctx, tuple(n for names in PASS_STAGES.values() for n in names))
