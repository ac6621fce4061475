"""The tail of the fleet's chains: the 95th percentile of the wall time of
every process_blocks call in the window, ms, by the host's clock."""
import sys

import numpy as np


def read(ctx):
    t = np.asarray(ctx["window"]["chain_s"]) * 1e3
    if not len(t):
        return None
    print(f"fleet.chain_p95_ms: {len(t)} chains, median {np.median(t):.3f}"
          f" ms", file=sys.stderr)
    return float(np.percentile(t, 95))
