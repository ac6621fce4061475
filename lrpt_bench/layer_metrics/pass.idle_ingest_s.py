"""The card's idle s a pass inside the program's spans cli.read and
cli.decode (cli.py _run_turbo: the WAV read and its decode)."""
from lrpt_bench.layer_metrics._spans import PASS_STAGES, stage_idle


def read(ctx):
    return stage_idle(ctx, PASS_STAGES["ingest"])
