"""The card's idle ms a chain in none of fleet.upload, fleet.launch and
fleet.readback: process_blocks' own time, fleet.recover, the harness."""
from lrpt_bench.layer_metrics._spans import FLEET_STAGES, unattributed_idle


def read(ctx):
    v = unattributed_idle(ctx, FLEET_STAGES)
    return None if v is None else v * 1e3
