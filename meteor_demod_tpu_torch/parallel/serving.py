"""ServingFleet: a fleet larger than one dispatch, served in groups.

A card serves fleets far wider than one dispatch group, so a production
fleet is n_groups x group_size streams, each group a FleetDemodulator
dispatched in turn. Stream identity is preserved: inputs are routed
group-wise through a fixed stream -> (group, lane) assignment and outputs
return in the caller's stream order.

The JAX package's ServingFleet also sorts streams by their predicted
first-fire tick into tau0-banded groups (predict_tau0, _sort_groups, `band`)
and drains parked streams' deferred rows into a stream-keyed store before it
renumbers them. Sorting serves the TPU kernel's candidate windows, which this
port leaves out (parallel/mesh.py), so the assignment here never changes by
itself; a loaded JAX capture's assignment (group_of / lane_of, sorted or not)
is kept, and so are its stream-keyed deferred rows, delivered through
parked_output. `band`, `sorted_once` and `_resort_wanted` are the JAX fields,
kept only to be written back (io/checkpoint.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import DemodConfig
from ..utils import mesh_devices
from .mesh import FleetDemodulator, deliver_rows


class ServingFleet:
    """n_streams = n_groups x group_size, each group a FleetDemodulator built
    with `fleet_kw` on `device`, or sharded over `mesh` (a device list, or
    "auto"; group_size divisible by its length); with neither, over every
    visible card (utils.make_mesh())."""

    def __init__(self, cfg: DemodConfig, n_streams: int,
                 group_size: int = 128, device=None, mesh=None, **fleet_kw):
        cfg.validate()
        if n_streams % group_size != 0:
            raise ValueError(
                f"n_streams {n_streams} not divisible by group {group_size}")
        self.cfg = cfg
        self.group_size = group_size
        self.n_streams = n_streams
        self.n_groups = n_streams // group_size
        self.mesh = mesh_devices(device, mesh)
        self.device = self.mesh[0]
        self.groups = [FleetDemodulator(cfg, group_size, mesh=self.mesh,
                                        **fleet_kw)
                       for _ in range(self.n_groups)]
        # assign[stream] = (group, lane), kept as flat arrays.
        self._group_of = np.repeat(np.arange(self.n_groups), group_size)
        self._lane_of = np.tile(np.arange(group_size), self.n_groups)
        # The JAX ServingFleet's banding fields, at its defaults; a serving
        # host sets `band` from its flag.
        self.band = 8
        self.sorted_once = False
        self._resort_wanted = False
        # A loaded JAX capture's deferred rows, keyed by caller stream.
        self._deferred: dict[int, list] = {}

    def _slots(self) -> np.ndarray:
        """Flat slot index (group*group_size + lane) per caller stream."""
        return self._group_of * self.group_size + self._lane_of

    def process_blocks(self, blocks: np.ndarray):
        """One dispatch span per stream (caller order, the shapes and dtypes
        FleetDemodulator.process_blocks takes) -> per-stream output leaves
        stacked back into caller order."""
        blocks = np.asarray(blocks)
        if blocks.shape[0] != self.n_streams:
            raise ValueError(
                f"expected {self.n_streams} streams, got {blocks.shape[0]}")
        slots = self._slots()
        # The initial assignment is the identity: no copy into slot order
        # and back (a span of 256 streams x 16 blocks is 268 MB).
        identity = np.array_equal(slots, np.arange(self.n_streams))
        if identity:
            flat = blocks
        else:
            flat = np.empty_like(blocks)
            flat[slots] = blocks
        outs = [f.process_blocks(flat[g * self.group_size:
                                      (g + 1) * self.group_size])
                for g, f in enumerate(self.groups)]
        cols = (np.concatenate(col)
                for col in zip(*(dataclasses.astuple(o) for o in outs)))
        return type(outs[0])(*(c if identity else c[slots] for c in cols))

    def parked_output(self, stream: int) -> dict:
        """Drain the deferred rows of caller stream `stream` (see
        FleetDemodulator.parked_output): those the capture kept by stream,
        then those its group kept by lane, once."""
        g, lane = int(self._group_of[stream]), int(self._lane_of[stream])
        rows = (self._deferred.pop(int(stream), [])
                + self.groups[g].take_deferred(lane))
        return deliver_rows(rows, self.groups[g].packed_output)

    def assignment(self) -> list[tuple[int, int]]:
        """(group, lane) per stream in caller order."""
        return [(int(self._group_of[s]), int(self._lane_of[s]))
                for s in range(self.n_streams)]
