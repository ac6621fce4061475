"""The card's idle s a pass inside the program's spans cli.quantize and
cli.write (cli.py _run_turbo: the .s bytes and their writing)."""
from lrpt_bench.layer_metrics._spans import PASS_STAGES, stage_idle


def read(ctx):
    return stage_idle(ctx, PASS_STAGES["output"])
