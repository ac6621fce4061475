"""Share of the samples turbo was given that it handed to the sequential
path (fallback, tail, redo) over the window's CLI runs, %: the program's
counters turbo.sequential_samples over turbo.samples."""
from lrpt_bench.layer_metrics._spans import call_records


def read(ctx):
    recs = call_records(ctx)
    if recs is None:
        return None
    given = sum(r.get("turbo.samples", 0) for r in recs)
    if given <= 0:
        return None
    return 100.0 * sum(r.get("turbo.sequential_samples", 0)
                       for r in recs) / given
