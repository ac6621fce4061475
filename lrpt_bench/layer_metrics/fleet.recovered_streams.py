"""Streams the fleet driver recomputed on the host (a flagged dispatch
replayed by its oracle) over the window: FleetDemodulator.recovered_streams."""


def read(ctx):
    return float(ctx["window"]["recovered_streams"])
