"""Checkpoint / resume: serialize the demodulator state mid-stream.

The reference has no checkpointing; its closest analogue is the partial-ring
flush at EOF (main.c:321-322). Here the carry (FIR delay-line tail, PLL
phase/freq/err/locked, timing phase/freq/prev, AGC gain/bias, OQPSK
inphase/slot) is a complete, exact checkpoint: demodulation resumed from a
saved carry is sample-for-sample identical to an uninterrupted run. This
module serializes that carry, plus the host-side state around it, to a single
.npz file, for a StreamDemodulator, a FleetDemodulator, a ServingFleet and
one process's part of a MultiHostFleet.

The layout is the JAX package's (format version 1), in both directions:

- a file the JAX package wrote loads here, parked, retired and deferred rows
  included: a parked stream's host carry goes back onto its lane at load
  (parallel/mesh.py), its configuration's window fields are dropped and its
  backend name becomes this port's default;
- a file written here holds every field the JAX package's loader reads
  (JAX_FIELDS), so it resumes there: the JAX-only policy parameters as they
  were read, or at the JAX constructor's defaults for a fleet made here, and
  the JAX policy counters as zeros.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json

import numpy as np

from ..config import DemodConfig
from ..demod.backend import BACKENDS
from ..demod.pipeline import _SYM_DTYPE, StreamDemodulator
from ..demod.state import CARRY_FIELDS, carry_from_numpy, carry_to_numpy
from ..parallel.serialize import ROW_KEYS, pack_rows, unpack_rows

_FORMAT_VERSION = 1
_CFG_FIELDS = tuple(f.name for f in dataclasses.fields(DemodConfig))

# What the JAX package's loaders read from each kind of file (io/checkpoint.py
# and the restore_state methods there), per kind: the meta's keys as dotted
# paths ("[]" every entry of a list, "*" every value of a mapping) and the
# arrays' names ("{g}" a group, "{i}" a lane with parked or retired rows,
# "{s}" a caller stream with deferred rows). Every saver here writes all of
# them; jax_fields_missing checks a file against it, and the CPU tests hold it
# against the JAX loaders themselves.
_CARRY = tuple(f"carry_{k}" for k in CARRY_FIELDS)
_ROWS = tuple(f"rows_{k}" for k in ROW_KEYS)
_FLEET_STATE = (
    "axis_name", "backend", "recover_flagged", "telemetry_every", "park",
    "park_after", "unpark_after", "park_max", "flap_park", "sweep_rescue_s",
    "chain_blocks", "ingest", "packed_output", "telemetry", "tick_idx",
    "block_idx", "active_locked", "wide_latch", "use_banded", "banded_cfg",
    "recovered_streams", "parked", "retired",
    *(f"parked.*.{k}" for k in ("locked", "locked_streak", "blocks_fed",
                                "blocks_done", "kick_wanted",
                                "last_kick_fed")))
_FLEET_ARRAYS = (
    *_CARRY, "unlock_streak", "flap_count", "rescue_streak",
    "last_locked_vec", "lonce_vec", "agc_vec", "stream_flags",
    *(f"parked_{{i}}_{c}" for c in _CARRY + _ROWS),
    *(f"retired_{{i}}_{r}" for r in _ROWS))
JAX_FIELDS = {
    "stream": (("version", "cfg", "symbols_out", "fallback_blocks"),
               (*_CARRY, "pending", "backlog_re", "backlog_im",
                "backlog_lo")),
    "fleet": (("version", "kind", "fleet", "fleet.cfg", "fleet.n_streams",
               *(f"fleet.{k}" for k in _FLEET_STATE)), _FLEET_ARRAYS),
    "serving": (("version", "kind", "cfg", "n_streams", "group_size", "band",
                 "sorted_once", "resort_wanted", "deferred", "groups",
                 *(f"groups.[].{k}" for k in _FLEET_STATE)),
                (*(f"g{{g}}_{a}" for a in _FLEET_ARRAYS), "group_of",
                 "lane_of", *(f"deferred_{{s}}_{r}" for r in _ROWS))),
    "multihost": (("version", "kind", "fleet",
                   *(f"fleet.{k}" for k in (
                       "cfg", "streams_per_device", "axis_name", "backend",
                       "recover_flagged", "telemetry_every", "n_local",
                       "n_streams", "block_idx", "recovered_streams",
                       "telemetry"))),
                  (*_CARRY, "local_stream_flags")),
}


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


@contextlib.contextmanager
def _fields(path: str):
    """A field a loader needs and the file lacks: ValueError naming it."""
    try:
        yield
    except KeyError as e:
        name = str(e.args[0]).split(" is not a file")[0]     # np.load's
        raise ValueError(f"{path}: the checkpoint has no field {name!r}"
                         ) from None


def _cfg_from_meta(d: dict) -> DemodConfig:
    """The saved configuration; the candidate-window fields of a file the
    JAX package wrote have no counterpart here and are dropped."""
    return DemodConfig(**{k: d[k] for k in _CFG_FIELDS if k in d})


def _port_backend(meta: dict) -> str:
    """This port's backend for a fleet capture: the one that wrote it, else
    the default in place of a JAX package's backend name."""
    backend = meta.get("port_backend", meta.get("backend", "auto"))
    return backend if backend in BACKENDS else "auto"


def save_checkpoint(path: str, demod: StreamDemodulator) -> None:
    """Serialize a StreamDemodulator's complete state to `path` (.npz).

    Drains the dispatch pipeline first (demod.sync()) so the carry is
    flag-verified and the in-flight blocks' symbols are not lost: they are
    returned by the next process()/finish() call, also after a resume."""
    demod.sync()
    # The JAX package's stream carry has no batch axis.
    carry = {f"carry_{k}": v[0]
             for k, v in carry_to_numpy(demod._carry).items()}
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
    with np.load(path) as z, _fields(path):
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
            # Files of either package since the layout was shared have no
            # batch axis; this port's earlier files have one.
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
    capture (restore_state re-applies the policy params afterwards)."""
    return dict(backend=_port_backend(meta),
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


def load_fleet_checkpoint(path: str, device=None, mesh=None):
    """Reconstruct a FleetDemodulator exactly as saved, on `device` or over
    `mesh` (FleetDemodulator's meaning: with neither, every visible card).
    The file holds its rows in stream order, so any device list whose
    length divides the stream count loads it, whatever list saved it."""
    from ..parallel.mesh import FleetDemodulator
    with np.load(path) as z, _fields(path):
        meta = _read_meta(z)
        if meta["version"] != _FORMAT_VERSION or meta.get("kind") != "fleet":
            raise ValueError("not a fleet checkpoint")
        fm = meta["fleet"]
        fleet = FleetDemodulator(_cfg_from_meta(fm["cfg"]), fm["n_streams"],
                                 device, mesh=mesh, **_fleet_ctor_kw(fm))
        fleet.restore_state(fm, z)
    return fleet


def save_serving_checkpoint(path: str, serving) -> None:
    """Serialize a ServingFleet: every group's fleet state, the
    stream->(group, lane) assignment, the JAX ServingFleet's banding fields
    and the stream-keyed deferred rows."""
    arrays = {}
    groups_meta = []
    for g, f in enumerate(serving.groups):
        gm, ga = f.state_dict()
        groups_meta.append(gm)
        for k, v in ga.items():
            arrays[f"g{g}_{k}"] = v
    arrays["group_of"] = serving._group_of
    arrays["lane_of"] = serving._lane_of
    for s, rows in serving._deferred.items():
        pack_rows(rows, arrays, f"deferred_{s}_rows_")
    meta = dict(version=_FORMAT_VERSION, kind="serving",
                cfg=dataclasses.asdict(serving.cfg),
                n_streams=serving.n_streams,
                group_size=serving.group_size, band=serving.band,
                sorted_once=bool(serving.sorted_once),
                resort_wanted=bool(serving._resort_wanted),
                deferred=sorted(int(s) for s in serving._deferred),
                groups=groups_meta)
    _savez(path, meta=_meta_array(meta), **arrays)


def load_serving_checkpoint(path: str, device=None, mesh=None):
    """Reconstruct a ServingFleet exactly as saved, on `device` or over
    `mesh` (ServingFleet's meaning), whatever device list saved it. Group
    state is restored into the constructor-built FleetDemodulators. A JAX
    file's per-group banded_cfg is kept only to be written back: the CUDA
    kernels read every fired tick, so a tau0 band changes nothing here."""
    from ..parallel.serving import ServingFleet
    with np.load(path) as z, _fields(path):
        meta = _read_meta(z)
        if (meta["version"] != _FORMAT_VERSION
                or meta.get("kind") != "serving"):
            raise ValueError("not a serving checkpoint")
        fleet_kw = (_fleet_ctor_kw(meta["groups"][0])
                    if meta["groups"] else {})
        serving = ServingFleet(_cfg_from_meta(meta["cfg"]),
                               meta["n_streams"],
                               group_size=meta["group_size"], device=device,
                               mesh=mesh, **fleet_kw)
        for g, gm in enumerate(meta["groups"]):
            serving.groups[g].restore_state(gm, z, prefix=f"g{g}_")
        serving._group_of = np.asarray(z["group_of"]).copy()
        serving._lane_of = np.asarray(z["lane_of"]).copy()
        serving.band = int(meta.get("band", serving.band))
        serving.sorted_once = bool(meta.get("sorted_once", False))
        serving._resort_wanted = bool(meta.get("resort_wanted", False))
        for s in meta.get("deferred", ()):
            rows = unpack_rows(z, f"deferred_{s}_rows_")
            if rows:
                serving._deferred[int(s)] = rows
    return serving


def save_multihost_checkpoint(path: str, fleet) -> None:
    """Serialize THIS PROCESS's part of a MultiHostFleet (its local rows and
    the fleet-global telemetry). In a job of several processes every
    process calls this with its own path (e.g. suffixed with its rank)."""
    meta, arrays = fleet.state_dict()
    meta = dict(version=_FORMAT_VERSION, kind="multihost", fleet=meta)
    _savez(path, meta=_meta_array(meta), **arrays)


def load_multihost_checkpoint(path: str, mesh=None):
    """Reconstruct this process's MultiHostFleet from its own file (this
    port's or the JAX package's), over its device list `mesh` (None: every
    visible card); the job must have the save-time topology, else
    ValueError."""
    from ..parallel.multihost import MultiHostFleet
    with np.load(path) as z, _fields(path):
        meta = _read_meta(z)
        if (meta["version"] != _FORMAT_VERSION
                or meta.get("kind") != "multihost"):
            raise ValueError("not a multihost checkpoint")
        fm = meta["fleet"]
        fleet = MultiHostFleet(
            _cfg_from_meta(fm["cfg"]), fm["streams_per_device"],
            backend=_port_backend(fm), recover_flagged=fm["recover_flagged"],
            telemetry_every=fm["telemetry_every"], mesh=mesh)
        fleet.restore_state(fm, z)
    return fleet


# ------------------------------------------------- the JAX package's fields

def _has_path(node, parts: list) -> bool:
    if not parts:
        return True
    head, rest = parts[0], parts[1:]
    if head == "[]":
        return isinstance(node, list) and all(_has_path(e, rest)
                                              for e in node)
    if head == "*":
        return isinstance(node, dict) and all(_has_path(v, rest)
                                              for v in node.values())
    return isinstance(node, dict) and head in node and _has_path(node[head],
                                                                  rest)


def _array_names(pattern: str, meta: dict) -> list:
    """The names a JAX_FIELDS array pattern stands for in a file of meta
    `meta` (a group's own meta for the part after "g{g}_")."""
    if pattern.startswith("g{g}_"):
        return [f"g{g}_{n}" for g, gm in enumerate(meta["groups"])
                for n in _array_names(pattern[len("g{g}_"):], gm)]
    if "{s}" in pattern:
        return [pattern.replace("{s}", str(s)) for s in meta["deferred"]]
    if "{i}" in pattern:
        fm = meta.get("fleet", meta)
        ids = fm["parked" if pattern.startswith("parked_") else "retired"]
        return [pattern.replace("{i}", str(i)) for i in ids]
    return [pattern]


def jax_fields_missing(path: str) -> list:
    """The fields of JAX_FIELDS that the checkpoint at `path` lacks (none
    for a file that the JAX package's loader can resume), as "meta:<path>"
    and "array:<name>"; a pattern with "*", "[]" or a placeholder is
    checked over the file's own entries. Arrays read only once a fleet has
    dispatched (stream_flags) are expected: check a file saved after one."""
    with np.load(path) as z:
        meta = _read_meta(z)
        files = set(z.files)
    meta_paths, arrays = JAX_FIELDS[meta.get("kind", "stream")]
    missing = [f"meta:{p}" for p in meta_paths
               if not _has_path(meta, p.split("."))]
    missing += [f"array:{n}" for a in arrays for n in _array_names(a, meta)
                if n not in files]
    return missing


def write_parked_form(src: str, dst: str, streams) -> None:
    """Rewrite the fleet or serving checkpoint `src` into `dst` with the
    caller streams `streams` parked, in the layout the JAX package's
    state_dict has for a stream at the tick it parked it (its mesh.py
    _maybe_park): the lane's carry moves to parked_{i}_carry_*, the lane
    takes a copy of the carry of its group's first lane not parked (the
    donor), the stream's parked entry is fresh (nothing fed, no kick) with
    empty rows, and its unlock and flap counts are 0. Loading dst here is
    loading src, since the load puts each parked carry back on its lane;
    the JAX package's loader resumes it with those streams on its host
    path."""
    with np.load(src) as z:
        meta = _read_meta(z)
        arrays = {k: np.array(z[k]) for k in z.files if k != "meta"}
    streams = [int(s) for s in streams]
    if meta.get("kind") == "fleet":
        groups = [("", meta["fleet"], streams)]
    elif meta.get("kind") == "serving":
        group_of, lane_of = arrays["group_of"], arrays["lane_of"]
        groups = [(f"g{g}_", gm, [int(lane_of[s]) for s in streams
                                   if group_of[s] == g])
                  for g, gm in enumerate(meta["groups"])]
    else:
        raise ValueError(f"{src}: not a fleet or serving checkpoint")
    for p, fm, lanes in groups:
        if not lanes:
            continue
        donors = [i for i in range(fm["n_streams"]) if i not in lanes]
        if not donors:
            raise ValueError(f"{src}: every lane of a group would park")
        for i in lanes:
            for k in CARRY_FIELDS:
                carry = arrays[f"{p}carry_{k}"]
                arrays[f"{p}parked_{i}_carry_{k}"] = carry[i].copy()
                carry[i] = carry[donors[0]]
            pack_rows([], arrays, f"{p}parked_{i}_rows_")
            arrays[f"{p}unlock_streak"][i] = 0
            arrays[f"{p}flap_count"][i] = 0
            fm["parked"][str(i)] = dict(
                locked=bool(arrays[f"{p}parked_{i}_carry_locked"]),
                locked_streak=0, blocks_fed=0, blocks_done=0,
                kick_wanted=False, last_kick_fed=0)
    _savez(dst, meta=_meta_array(meta), **arrays)
