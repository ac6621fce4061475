"""Sequence (time) parallelism for the FIR: one stream split along time.

The reference's matched filter is an overlap-save delay line over one
strictly sequential stream (filter.c:41-42). Its FIR has no feedback, so a
long recording splits along time: each device filters its own time shard,
with the last taps-1 samples of its left neighbour as its delay line (shard 0
keeps the zero delay line, filter.c:15). The N shards' outputs, in time
order, are the one-device output: the same per-sample dot products.

The JAX package's make_sharded_fir exchanges those tails between devices
with a collective permute; here they are sliced from the host's copy of the
samples, and each shard is one dsp/fir.py polyphase_fir_block call on its
device, with no collective. The feedback loops stay sequential; for
throughput the stream axis (parallel/mesh.py) is the primary one.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..config import DemodConfig
from ..dsp.fir import make_fir_banks, polyphase_fir_block
from ..utils import make_mesh, to_device


def make_sharded_fir(cfg: DemodConfig, mesh=None) -> Callable:
    """Build fir(x) -> [Ft of each time shard] over the devices of `mesh`
    (a device list, or None / "auto": utils.make_mesh).

    x: (n_dev * L, 2) float32 samples of one stream, or (B, n_dev * L, 2)
    of B streams, as numpy. Shard i is samples [i*L, (i+1)*L) on device i,
    filtered from a zero delay line (i = 0) or its left neighbour's last
    taps-1 samples. Returns the shards' tick-major outputs in time order,
    each (L * interp, 2, B) on its device (B = 1 for one stream), as
    polyphase_fir_block gives them; together they equal the one-call
    overlap-save FIR of the whole stream from a zero delay line."""
    devices = make_mesh(mesh)
    banks_np = make_fir_banks(cfg)
    banks = {d: torch.as_tensor(banks_np, device=d) for d in set(devices)}
    taps = cfg.taps
    n_dev = len(devices)

    def fir(x: np.ndarray) -> list:
        x = np.asarray(x, dtype=np.float32)
        x = x[None] if x.ndim == 2 else x
        B, N = x.shape[:2]
        if N % n_dev != 0:
            raise ValueError(f"{N} samples do not split into {n_dev} "
                             f"equal time shards")
        L = N // n_dev
        if L < taps - 1:
            raise ValueError(f"a time shard of {L} samples is shorter than "
                             f"the {taps - 1}-sample delay line")
        zero = np.zeros((B, taps - 1, 2), np.float32)
        out = []
        for i, dev in enumerate(devices):
            at = i * L
            tail = zero if i == 0 else x[:, at - (taps - 1):at]
            Ft, _ = polyphase_fir_block(
                to_device(np.ascontiguousarray(x[:, at:at + L]), dev),
                to_device(np.ascontiguousarray(tail), dev), banks[dev])
            out.append(Ft)
        return out

    return fir
