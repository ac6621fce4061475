"""Turbo's fixpoint passes a CLI run in the window (TurboResult.passes, the
program's counter turbo.passes; the warm-up pass not counted), mean."""
from lrpt_bench.layer_metrics._spans import call_records


def read(ctx):
    recs = call_records(ctx)
    if not recs:
        return None
    return sum(r.get("turbo.passes", 0) for r in recs) / len(recs)
