"""Lock-gated soft-symbol writer with reference ring semantics.

The reference buffers int8 symbol pairs in a 1024-byte ring; each time the
ring fills it is written out only if the PLL has locked at least once
(main.c:305-316) — pre-lock rings are silently discarded. At EOF the partial
ring is flushed unconditionally (main.c:321-322; the reference's flush has a
size/nmemb swap that duplicates stale bytes — we write the sane 2*count
bytes instead, which is what downstream decoders expect).

Because locked_once is monotone (pll.c:120), the per-ring gate reduces to:
a complete ring is emitted iff its last symbol index is >= the first-lock
index — which lets us process symbol batches vectorized instead of
per-symbol.
"""

from __future__ import annotations

from typing import BinaryIO

import numpy as np

from ..constants import RING_SYMBOLS


class SymbolWriter:
    def __init__(self, f: BinaryIO):
        self._f = f
        self._ring = np.zeros(2 * RING_SYMBOLS, dtype=np.int8)
        self._fill = 0            # symbols currently in the ring
        self.bytes_out = 0
        # Constellation tap: last full ring content, for the TUI
        # (main.c:238 reads the shared ring).
        self.last_ring = np.zeros(2 * RING_SYMBOLS, dtype=np.int8)

    def feed(self, iq_bytes: np.ndarray, locked_once: np.ndarray) -> None:
        """iq_bytes: interleaved int8, length 2*n; locked_once: (n,) int32,
        the locked_once state after each symbol."""
        n = len(iq_bytes) // 2
        if n == 0:
            return
        pos = 0
        while pos < n:
            take = min(RING_SYMBOLS - self._fill, n - pos)
            self._ring[2 * self._fill:2 * (self._fill + take)] = \
                iq_bytes[2 * pos:2 * (pos + take)]
            self._fill += take
            pos += take
            if self._fill == RING_SYMBOLS:
                self.last_ring[:] = self._ring
                if locked_once[pos - 1]:
                    self._f.write(self._ring.tobytes())
                    self.bytes_out += 2 * RING_SYMBOLS
                self._fill = 0

    def flush_partial(self) -> None:
        """EOF flush of the partial ring (main.c:321-322)."""
        if self._fill:
            self._f.write(self._ring[:2 * self._fill].tobytes())
            self.bytes_out += 2 * self._fill
            self._fill = 0
