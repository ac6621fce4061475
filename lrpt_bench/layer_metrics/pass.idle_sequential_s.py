"""The card's idle s a pass inside the program's span turbo.sequential
(demod/turbo.py _sequential_from: the fallback, the tail or a whole redo,
its stream.* spans included)."""
from lrpt_bench.layer_metrics._spans import PASS_STAGES, stage_idle


def read(ctx):
    return stage_idle(ctx, PASS_STAGES["sequential"])
