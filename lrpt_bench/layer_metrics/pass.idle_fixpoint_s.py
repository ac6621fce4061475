"""The card's idle s a pass inside the program's spans turbo.prepare,
turbo.warmup and turbo.pass (demod/turbo.py: the upload and tails, the
warm-up pass, each fixpoint pass with its host gauge work)."""
from lrpt_bench.layer_metrics._spans import PASS_STAGES, stage_idle


def read(ctx):
    return stage_idle(ctx, PASS_STAGES["fixpoint"])
