"""The card's idle s a pass inside the program's span turbo.assemble
(demod/turbo.py: the lanes' readback and their assembly in stream order)."""
from lrpt_bench.layer_metrics._spans import PASS_STAGES, stage_idle


def read(ctx):
    return stage_idle(ctx, PASS_STAGES["assemble"])
