"""The .s byte math and the writer's lock gate (main.c:305-316).

A soft component becomes clamp(x / 2, +-127) truncated toward zero. The
writer emits symbols in rings of 512; a full ring is written only if the
loop had locked by its last symbol, and the last partial ring is written
at the end as it is.
"""

from __future__ import annotations

import numpy as np

from .params import RING_SYMBOLS

F32 = np.float32


def quantize(x: np.ndarray) -> np.ndarray:
    return np.trunc(np.clip(np.asarray(x, F32) * F32(0.5), -127.0, 127.0)
                    ).astype(np.int8)


def first_written_ring(locked_once: np.ndarray) -> int | None:
    """The index of the first ring the writer emits, from the locked_once
    flag after each symbol of a stream started at its first symbol: the
    ring that holds the first locked symbol. None if none locked."""
    hit = np.nonzero(locked_once)[0]
    if not len(hit):
        return None
    return int(hit[0]) // RING_SYMBOLS
