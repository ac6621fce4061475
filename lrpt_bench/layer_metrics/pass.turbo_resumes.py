"""Turbo's resume rounds a CLI run in the window (the program's counter
turbo.resumes: fixpoint rounds over the lanes the first fixpoint left
unverified), mean. A program that keeps no such counter gives None."""
from lrpt_bench.layer_metrics._spans import call_records


def read(ctx):
    recs = call_records(ctx)
    if not recs or not any("turbo.resumes" in r for r in recs):
        return None
    return sum(r.get("turbo.resumes", 0) for r in recs) / len(recs)
