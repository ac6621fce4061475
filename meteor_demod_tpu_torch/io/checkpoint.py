"""Checkpoint / resume: serialize the demodulator state mid-stream.

The reference has no checkpointing; its closest analogue is the partial-ring
flush at EOF (main.c:321-322). Here the carry (FIR delay-line tail, PLL
phase/freq/err/locked, timing phase/freq/prev, AGC gain/bias, OQPSK
inphase/slot) is a complete, exact checkpoint: demodulation resumed from a
saved carry is sample-for-sample identical to an uninterrupted run. This
module serializes that carry, plus the host-side state around it, to a single
.npz file, for a StreamDemodulator, a FleetDemodulator and a ServingFleet.

The layout is the JAX package's (format version 1), so a file it wrote loads
here as long as it holds no parked stream: its parking, program-switch and
banding fields are ignored, its configuration's window fields dropped, and
its backend name replaced by this port's default.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..config import DemodConfig
from ..demod.backend import BACKENDS
from ..demod.pipeline import _SYM_DTYPE, StreamDemodulator
from ..demod.state import CARRY_FIELDS, carry_from_numpy, carry_to_numpy

_FORMAT_VERSION = 1
_CFG_FIELDS = tuple(f.name for f in dataclasses.fields(DemodConfig))


def _savez(path: str, **arrays) -> None:
    """np.savez to the exact path given: np.savez(str) appends .npz to names
    lacking the suffix (so save('ck.0') would write 'ck.0.npz' and the
    matching load would not find it); writing through an open handle keeps
    save and load paths symmetric."""
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def _meta_array(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def _read_meta(z) -> dict:
    return json.loads(bytes(z["meta"].tobytes()).decode())


def _cfg_from_meta(d: dict) -> DemodConfig:
    """The saved configuration; the candidate-window fields of a file the
    JAX package wrote have no counterpart here and are dropped."""
    return DemodConfig(**{k: d[k] for k in _CFG_FIELDS if k in d})


def save_checkpoint(path: str, demod: StreamDemodulator) -> None:
    """Serialize a StreamDemodulator's complete state to `path` (.npz).

    Drains the dispatch pipeline first (demod.sync()) so the carry is
    flag-verified and the in-flight blocks' symbols are not lost: they are
    returned by the next process()/finish() call, also after a resume."""
    demod.sync()
    carry = {f"carry_{k}": v for k, v in carry_to_numpy(demod._carry).items()}
    backlog = (np.concatenate(demod._backlog) if demod._backlog
               else np.zeros(0, dtype=_SYM_DTYPE))
    meta = dict(version=_FORMAT_VERSION,
                cfg=dataclasses.asdict(demod.cfg),
                symbols_out=demod.symbols_out,
                fallback_blocks=demod.fallback_blocks)
    _savez(path, meta=_meta_array(meta), pending=demod._pending,
           backlog_re=backlog["re"], backlog_im=backlog["im"],
           backlog_lo=backlog["locked_once"], **carry)


def load_checkpoint(path: str, device=None) -> StreamDemodulator:
    """Reconstruct a StreamDemodulator exactly as saved, on `device` (None:
    the card; utils.select_device)."""
    with np.load(path) as z:
        meta = _read_meta(z)
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {meta['version']}")
        if "kind" in meta:
            raise ValueError(
                f"{meta['kind']} checkpoint; use load_{meta['kind']}"
                "_checkpoint, not the single-stream loader")
        d = StreamDemodulator(_cfg_from_meta(meta["cfg"]), device)
        leaves = {k: np.asarray(z[f"carry_{k}"]) for k in CARRY_FIELDS}
        if leaves["t_phase"].ndim == 0:
            # The JAX package's stream carry has no batch axis.
            leaves = {k: v[None] for k, v in leaves.items()}
        d._carry = carry_from_numpy(leaves, d.device)
        d._pending = np.asarray(z["pending"], dtype=np.complex64)
        if "backlog_re" in z.files and len(z["backlog_re"]):
            backlog = np.zeros(len(z["backlog_re"]), dtype=_SYM_DTYPE)
            backlog["re"] = z["backlog_re"]
            backlog["im"] = z["backlog_im"]
            backlog["locked_once"] = z["backlog_lo"]
            d._backlog = [backlog]
        d.symbols_out = int(meta["symbols_out"])
        d.fallback_blocks = int(meta["fallback_blocks"])
        d._publish_telemetry()
    return d


def _fleet_ctor_kw(meta: dict) -> dict:
    """Constructor kwargs for a FleetDemodulator matching a state_dict
    capture (restore_state re-applies the policy params afterwards). A
    backend name of the JAX package becomes this port's default."""
    backend = meta.get("backend", "auto")
    return dict(backend=backend if backend in BACKENDS else "auto",
                recover_flagged=meta["recover_flagged"],
                telemetry_every=meta["telemetry_every"],
                sweep_rescue_s=meta.get("sweep_rescue_s", 0.0),
                chain_blocks=meta.get("chain_blocks", 1),
                ingest=meta.get("ingest", "f32"),
                packed_output=meta.get("packed_output", False))


def save_fleet_checkpoint(path: str, fleet) -> None:
    """Serialize a FleetDemodulator (device carry and host-side policy
    state, via FleetDemodulator.state_dict) to `path` (.npz). Resuming from
    the file is bit-identical to continuing the original."""
    meta, arrays = fleet.state_dict()
    meta = dict(version=_FORMAT_VERSION, kind="fleet", fleet=meta)
    _savez(path, meta=_meta_array(meta), **arrays)


def load_fleet_checkpoint(path: str, device=None):
    """Reconstruct a FleetDemodulator exactly as saved, on `device` (None:
    the card)."""
    from ..parallel.mesh import FleetDemodulator
    with np.load(path) as z:
        meta = _read_meta(z)
        if meta["version"] != _FORMAT_VERSION or meta.get("kind") != "fleet":
            raise ValueError("not a fleet checkpoint")
        fm = meta["fleet"]
        fleet = FleetDemodulator(_cfg_from_meta(fm["cfg"]), fm["n_streams"],
                                 device, **_fleet_ctor_kw(fm))
        fleet.restore_state(fm, z)
    return fleet


def save_serving_checkpoint(path: str, serving) -> None:
    """Serialize a ServingFleet: every group's fleet state plus the
    stream->(group, lane) assignment."""
    arrays = {}
    groups_meta = []
    for g, f in enumerate(serving.groups):
        gm, ga = f.state_dict()
        groups_meta.append(gm)
        for k, v in ga.items():
            arrays[f"g{g}_{k}"] = v
    arrays["group_of"] = serving._group_of
    arrays["lane_of"] = serving._lane_of
    meta = dict(version=_FORMAT_VERSION, kind="serving",
                cfg=dataclasses.asdict(serving.cfg),
                n_streams=serving.n_streams,
                group_size=serving.group_size,
                groups=groups_meta)
    _savez(path, meta=_meta_array(meta), **arrays)


def load_serving_checkpoint(path: str, device=None):
    """Reconstruct a ServingFleet exactly as saved, on `device` (None: the
    card). Group state is restored into the constructor-built
    FleetDemodulators."""
    from ..parallel.serving import ServingFleet
    with np.load(path) as z:
        meta = _read_meta(z)
        if (meta["version"] != _FORMAT_VERSION
                or meta.get("kind") != "serving"):
            raise ValueError("not a serving checkpoint")
        if meta.get("deferred"):
            raise ValueError(
                "the checkpoint holds parked streams' deferred symbols; "
                "this port has no straggler parking and cannot resume them")
        fleet_kw = (_fleet_ctor_kw(meta["groups"][0])
                    if meta["groups"] else {})
        serving = ServingFleet(_cfg_from_meta(meta["cfg"]),
                               meta["n_streams"],
                               group_size=meta["group_size"], device=device,
                               **fleet_kw)
        for g, gm in enumerate(meta["groups"]):
            serving.groups[g].restore_state(gm, z, prefix=f"g{g}_")
        serving._group_of = np.asarray(z["group_of"]).copy()
        serving._lane_of = np.asarray(z["lane_of"]).copy()
    return serving
