"""The card's idle ms inside FleetDemodulator's span fleet.upload a chain
(parallel/mesh.py FleetDemodulator._dispatch)."""
from lrpt_bench.layer_metrics._spans import stage_idle


def read(ctx):
    v = stage_idle(ctx, ("fleet.upload",))
    return None if v is None else v * 1e3
