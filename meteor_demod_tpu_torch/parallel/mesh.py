"""Fleet demodulation: many independent streams per dispatch, on one device
or over a list of them.

The reference is a single-process, single-stream program; a station fleet
runs N of them. Here the N streams are the batch axis of one block
demodulator (demod/backend.py): each stream's carry and sample blocks get a
leading `streams` axis, and a dispatch runs `chain_blocks` consecutive
blocks between one upload and one readback. Streams never exchange data;
the only reductions are the five fleet telemetry values, read back on
telemetry ticks as the reference's UI thread polls its DSP getters
(main.c:231-237) without touching the hot path.

Several devices (`mesh=`, a device list as utils.make_mesh gives it; the JAX
package's shard_map over its `streams` axis): the stream rows split into
equal contiguous shards, one per list entry, each with its own step and
carry on its device (Shards). Every shard's upload, step and readback is
queued before the host waits for any readback, so several cards work at
once, and shards that share a card each run on a CUDA stream of their own.
A shard's program and shapes do not depend on the shard count or on the
stream it runs on, so every stream's output is bitwise its one-device
output. The telemetry combines on the host as psum / pmean
would: the four counts add and mean_agc_gain is the mean of the shard
means. No collective runs inside one process; parallel/multihost.py adds
the one across processes.

Left out of the JAX package's mesh.py on purpose, three TPU-era policies:

- straggler parking (a host side-path for never-locking streams, its worker
  thread and deferred output): it existed so that the wide<->locked program
  switch could ignore dead streams, and outputs are the same without it;
- the wide<->locked program switch and its demotion latch: the CUDA kernels
  read each fired tick directly and have one program;
- tau0-banded groups (`banded_cfg`, `use_banded`): window economy of the
  TPU kernel.

So there are no `park*` constructor arguments. Their saved state is read and
written all the same, so that a fleet moves between the two packages in both
directions (io/checkpoint.py): a parked stream of a JAX capture goes back
onto its lane at load, as the JAX package's unpark splice would put it, and
its deferred rows are delivered through parked_output; the policy parameters
(`jax_policy`) are written back as they were read, at the JAX constructor's
defaults for a fleet made here, and its counters are written as zeros.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

from ..config import DemodConfig
from ..constants import SWEEP_STEP
from ..demod.backend import make_batch_demod
from ..demod.pipeline import (numpy_carry_to_scalar_state, oracle_replay,
                              quantize, scalar_state_to_numpy_carry)
from ..demod.state import (CARRY_FIELDS, BlockOutput, DemodCarry,
                           PackedOutput, batch_carry, carry_from_numpy,
                           carry_to_numpy)
from ..dsp.fir import f32_to_iq, iq_to_f32
from ..profiling import span
from ..utils import mesh_devices, select_device, to_device, to_host_async
from .serialize import ROW_KEYS, pack_rows, unpack_rows

INGESTS = {"f32": np.float32, "i16": np.int16, "u8": np.uint8}

# The JAX package's backend names; its captures name one of them.
JAX_BACKENDS = ("auto", "scan", "pallas")
# The JAX FleetDemodulator's policy parameters, which this port keeps only to
# write them back (see the module docstring).
JAX_POLICY = ("axis_name", "backend", "park", "park_after", "unpark_after",
              "park_max", "flap_park", "banded_cfg")


def jax_policy_defaults(n_streams: int) -> dict:
    """The JAX FleetDemodulator's policy parameters at its constructor's
    defaults (meteor_demod_tpu/parallel/mesh.py FleetDemodulator.__init__)."""
    return dict(axis_name="streams", backend="auto", park=True, park_after=6,
                unpark_after=2, park_max=max(1, n_streams // 16), flap_park=6,
                banded_cfg=None)


def jax_policy_of(meta: dict, n_streams: int) -> dict:
    """The policy parameters of a fleet capture of either package; those it
    lacks (a capture of this port before it wrote them) at the defaults."""
    pol = jax_policy_defaults(n_streams)
    pol.update({k: meta[k] for k in JAX_POLICY if k in meta})
    if pol["backend"] not in JAX_BACKENDS:
        pol["backend"] = "auto"
    return pol


def deliver_rows(rows: list, packed: bool) -> dict:
    """Deferred symbol rows (float32 sym_re / sym_im, int32 valid /
    locked_once: what the JAX package's host program wrote) -> one dict of
    their concatenation, the JAX parked_output's result. With `packed`,
    sym_re and sym_im are int8, the .s byte values (pipeline.quantize, the
    math the JAX serving host quantizes them with). No rows: empty arrays of
    the JAX's dtypes."""
    if not rows:
        z = np.zeros(0, np.float32)
        return dict(sym_re=z, sym_im=z, valid=np.zeros(0, np.int32),
                    locked_once=np.zeros(0, np.int32))
    out = {k: np.concatenate([np.asarray(r[k]) for r in rows])
           for k in ROW_KEYS}
    if packed:
        for k in ("sym_re", "sym_im"):
            out[k] = quantize(out[k].astype(np.float32)).astype(np.int8)
    return out



def make_fleet_demod(cfg: DemodConfig, n_streams: int, device=None,
                     backend: str = "auto", telemetry: bool = True,
                     chain: int = 1, ingest: str = "f32",
                     packed: bool = False) -> Callable:
    """Build the fleet step: (carry, blocks) -> (carry', outs, telemetry),
    all tensors on `device` (None: the card; utils.select_device).

    blocks is (n_streams, chain*block_len, 2) in the ingest's dtype. Raw
    ingest ("i16", "u8") uploads the SDR's integer samples and decodes them
    on the device with io/wav.py decode_iq's exact math (i16: float cast;
    u8: float - 128), a half or a quarter of the float32 upload.

    chain=K runs K consecutive blocks of the batch demodulator between one
    upload and one readback; the outputs come back step-concatenated,
    (n_streams, K*S) (K*(S+1) for OQPSK, row 0 of each block its pre-fire),
    so consumers see one wider block. carry.flags is OR-sticky across the
    chain: an excursion in any block shows in the flags read after it, and
    the oracle recovery replays the stream's whole K-block span.

    packed=True quantizes the symbols on the device (pipeline.quantize) and
    returns a PackedOutput of int8 leaves, a quarter of the readback.

    telemetry=True adds five 0-d device tensors (locked_streams,
    locked_once_streams, symbols, mean_agc_gain, flags); telemetry=False
    returns an empty dict and computes none of them."""
    if chain < 1:
        raise ValueError("chain must be >= 1")
    if ingest not in INGESTS:
        raise ValueError(f"unsupported ingest {ingest!r}")
    device = select_device(device)
    demod = make_batch_demod(cfg, n_streams, device, backend)
    L = cfg.block_len

    def step(carry: DemodCarry, blocks: torch.Tensor):
        if ingest == "i16":
            blocks = blocks.float()
        elif ingest == "u8":
            blocks = blocks.float() - 128.0
        if chain == 1:
            carry, outs = demod(carry, blocks)
        else:
            per_block = []
            for k in range(chain):
                carry, o = demod(carry, blocks[:, k * L:(k + 1) * L])
                per_block.append(dataclasses.astuple(o))
            outs = BlockOutput(*(torch.cat(col, dim=1)
                                 for col in zip(*per_block)))
        valid = outs.valid
        if packed:
            outs = PackedOutput(
                sym_i=quantize(outs.sym_re).to(torch.int8),
                sym_q=quantize(outs.sym_im).to(torch.int8),
                valid=outs.valid.to(torch.int8),
                locked_once=outs.locked_once.to(torch.int8))
        if not telemetry:
            return carry, outs, {}
        tel = {
            "locked_streams": carry.locked.sum(),
            "locked_once_streams": carry.locked_once.sum(),
            "symbols": valid.sum(),
            "mean_agc_gain": carry.agc_gain.mean(),
            "flags": carry.flags.sum(),
        }
        return carry, outs, tel

    return step


# The fleet telemetry, in the order the step returns it.
TELEMETRY = ("locked_streams", "locked_once_streams", "symbols",
             "mean_agc_gain", "flags")


def _telemetry_values(tel: dict) -> dict:
    """Telemetry in its host form: np.float32 mean_agc_gain, np.int32 sums."""
    return {k: (np.float32(v) if k == "mean_agc_gain" else np.int32(v))
            for k, v in tel.items()}


def combine_telemetry(parts: list) -> dict:
    """Telemetry of equal shards (host values) -> the whole fleet's, as the
    JAX step's psum / pmean: the four counts add and mean_agc_gain is the
    float32 mean of the shard means."""
    out = {k: sum(int(p[k]) for p in parts) for k in TELEMETRY
           if k != "mean_agc_gain"}
    out["mean_agc_gain"] = np.mean(
        np.array([p["mean_agc_gain"] for p in parts], dtype=np.float32))
    return _telemetry_values({k: out[k] for k in TELEMETRY})


def _cat(parts: list) -> np.ndarray:
    """Shards' rows in order; one shard's array is returned as it is."""
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


class Shards:
    """Equal contiguous row shards of a batch of n_rows, one per entry of
    `devices` (repeats allowed): shard i holds rows[i] on devices[i].

    Streams. A shard that is its card's only one works on the card's
    current stream, the caller's. Shards that share a card each get a CUDA
    stream of their own (own_stream; made at first use, kept for the
    Shards' life), so that they run at once on it, as shards on several
    cards do. A CPU shard has no stream. A shard's work is queued inside
    on(i), and its readback by to_host / carry_to_numpy, each on its
    stream after its work, so no readback can overtake the work it reads.

    Why that is safe: on(i) first makes the shard's stream wait for the
    caller's current stream, so whatever the caller queued before (an
    upload, a carry it built or edited in place) is done before the shard
    reads it; and the tensors the shard reads that the caller's stream
    allocated are marked with record_stream, so torch's caching allocator
    hands their memory out again only when the shard's stream is done with
    them, whenever the caller frees them. Tensors the shard allocates stay
    on its stream: the caller reads them only through to_host, which waits
    for their copies on the host. A shard's program and shapes do not
    depend on the stream it runs on, so its rows are bitwise the
    one-device rows."""

    def __init__(self, devices, n_rows: int, what: str = "n_streams"):
        self.devices = list(devices)
        n = len(self.devices)
        if n_rows % n != 0:
            raise ValueError(
                f"{what} {n_rows} must be divisible by mesh size {n}")
        self.per = n_rows // n
        self.rows = [slice(i * self.per, (i + 1) * self.per)
                     for i in range(n)]
        self.own_stream = [d.type == "cuda" and self.devices.count(d) > 1
                           for d in self.devices]
        self._streams = {}

    def __len__(self) -> int:
        return len(self.devices)

    @contextlib.contextmanager
    def on(self, i: int, reads=()):
        """Queue shard i's work inside this block: on its own stream, which
        first waits for the caller's current stream of its card, when
        own_stream[i]; else where the caller's work goes. `reads`: the
        tensors the work reads that the caller made (a carry's leaves, an
        upload), marked as in use on the shard's stream."""
        if not self.own_stream[i]:
            yield
            return
        dev = self.devices[i]
        if i not in self._streams:
            self._streams[i] = torch.cuda.Stream(dev)
        stream = self._streams[i]
        stream.wait_stream(torch.cuda.current_stream(dev))
        for t in reads:
            t.record_stream(stream)
        with torch.cuda.stream(stream):
            yield

    def carry_from_numpy(self, leaves: dict) -> list:
        """Global numpy carry leaves -> one DemodCarry per shard."""
        return [carry_from_numpy(
            {k: np.asarray(leaves[k])[r] for k in CARRY_FIELDS}, dev)
            for dev, r in zip(self.devices, self.rows)]

    def to_host(self, per_shard: list, copy: bool = True) -> list:
        """[shard i's tensors] -> [shard i's numpy arrays]: each shard's
        copies queued on its stream (on(i)), then all waited for."""
        waits = []
        for i, tensors in enumerate(per_shard):
            with self.on(i):
                waits.append(to_host_async(tensors))
        return [wait(copy) for wait in waits]

    def carry_to_numpy(self, carries: list) -> dict:
        """One DemodCarry per shard -> the global numpy carry leaves."""
        host = self.to_host([carry_leaves(c) for c in carries])
        return {k: _cat([h[j] for h in host])
                for j, k in enumerate(CARRY_FIELDS)}


def carry_leaves(carry: DemodCarry) -> list:
    """The carry's leaves in CARRY_FIELDS order."""
    return [getattr(carry, k) for k in CARRY_FIELDS]


class FleetDemodulator:
    """Demodulate a fleet of independent IQ streams on one device or over a
    list of them.

    The equivalent of running n_streams reference processes: feed aligned
    (n_streams, chain_blocks*block_len) blocks, collect per-stream symbols
    and fleet telemetry. device= runs on one device; mesh= (a device list,
    or "auto") shards the streams over it, n_streams divisible by its
    length; giving both raises. With neither, every visible card
    (utils.make_mesh()): one card is the one-device fleet.
    """

    def __init__(self, cfg: DemodConfig, n_streams: int, device=None,
                 backend: str = "auto", recover_flagged: bool = True,
                 telemetry_every: int = 1, sweep_rescue_s: float = 0.0,
                 chain_blocks: int = 1, ingest: str = "f32",
                 packed_output: bool = False, mesh=None):
        cfg.validate()
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        if telemetry_every < 1:
            raise ValueError("telemetry_every must be >= 1")
        if chain_blocks < 1:
            raise ValueError("chain_blocks must be >= 1")
        if ingest not in INGESTS:
            raise ValueError(f"unsupported ingest {ingest!r}")
        self.cfg = cfg
        self.n_streams = n_streams
        self.mesh = mesh_devices(device, mesh)
        self._shards = Shards(self.mesh, n_streams)
        self.device = self.mesh[0]
        self._backend = backend
        # Raw integer ingest and device-side output quantization: see
        # make_fleet_demod. The oracle recovery decodes and quantizes on the
        # host with the identical math.
        self.ingest = ingest
        self.packed_output = bool(packed_output)
        # Chained dispatch: chain_blocks consecutive blocks per device call.
        # Policy ticks (telemetry, rescue) then advance once per chain.
        self.chain_blocks = int(chain_blocks)
        # Sweep rescue (opt-in; 0 = off = exact reference acquisition): see
        # set_sweep_rescue.
        self.set_sweep_rescue(sweep_rescue_s)
        self._rescue_streak = np.zeros(n_streams, np.int64)
        # Telemetry amortization: the fleet values are computed and read
        # back every telemetry_every-th dispatch, as the reference polls its
        # getters at the UI refresh interval and not per buffer. In between,
        # self.telemetry holds the last tick's values; per-stream outputs
        # and safety flags are read every dispatch regardless.
        self.telemetry_every = telemetry_every
        self._block_idx = 0
        self._fns = {}
        self._get_fns(telemetry=True)        # checks backend and device now
        self._carries = [batch_carry(cfg, self._shards.per, dev)
                         for dev in self.mesh]
        self.telemetry = None
        self.stream_flags = None
        # When True (default), a stream whose dispatch trips a safety flag is
        # re-demodulated through the exact scalar oracle from its
        # pre-dispatch carry and its outputs and carry are spliced back: the
        # fleet then has StreamDemodulator's always-exact contract.
        self.recover_flagged = recover_flagged
        self.recovered_streams = 0
        # The JAX package's policy parameters (written back by state_dict)
        # and the deferred rows of a loaded JAX capture's parked and retired
        # streams, by lane, until parked_output drains them.
        self.jax_policy = jax_policy_defaults(n_streams)
        self._deferred_rows: dict[int, list] = {}

    @property
    def carry(self) -> DemodCarry:
        """Every stream's carry in order: with one shard the carry itself,
        with several a copy gathered onto the first device. Assigning a
        carry splits it into the shards."""
        if len(self._shards) == 1:
            return self._carries[0]
        return carry_from_numpy(self._shards.carry_to_numpy(self._carries),
                                self.device)

    @carry.setter
    def carry(self, carry: DemodCarry) -> None:
        if len(self._shards) == 1:
            self._carries = [carry]
        else:
            self._carries = self._shards.carry_from_numpy(
                carry_to_numpy(carry))

    def set_sweep_rescue(self, seconds: float) -> None:
        """(Re)configure the sweep rescue: `seconds` of unlocked signal
        before a stream's carry is kicked onto the downward escape sweep
        (p_freq=+fmax, updown=-1; the reference's upward-first sweep never
        captures small negative carrier offsets, pll.c:109-130); 0 disables.
        Also derives the post-kick cooldown: a full downward pass takes
        2*fmax/SWEEP_STEP symbols, and a kick before it completes would
        reset the sweep forever, so a kicked stream's counter goes negative
        and the next kick waits transit + budget."""
        cfg = self.cfg
        self.sweep_rescue_s = float(seconds)
        self._rescue_blocks = (
            0 if seconds <= 0 else
            max(1, int(round(seconds * cfg.samplerate / cfg.block_len))))
        self._rescue_transit_blocks = int(
            2.0 * float(cfg.pll_fmax) / SWEEP_STEP
            * cfg.samplerate / cfg.symrate / cfg.block_len) + 1

    def _get_fns(self, telemetry: bool) -> list:
        """Each shard's step; shards on one device share theirs."""
        if telemetry not in self._fns:
            steps = {}
            for dev in self.mesh:
                if dev not in steps:
                    steps[dev] = make_fleet_demod(
                        self.cfg, self._shards.per, dev, self._backend,
                        telemetry=telemetry, chain=self.chain_blocks,
                        ingest=self.ingest, packed=self.packed_output)
            self._fns[telemetry] = [steps[dev] for dev in self.mesh]
        return self._fns[telemetry]

    def _feed(self, blocks: np.ndarray) -> np.ndarray:
        """The caller's blocks as the ingest's sample pairs, shape checked."""
        feed_dtype = INGESTS[self.ingest]
        if self.ingest == "f32":
            if np.iscomplexobj(blocks):
                blocks = iq_to_f32(blocks)
        elif blocks.dtype != feed_dtype:
            raise ValueError(
                f"ingest {self.ingest!r} expects {np.dtype(feed_dtype)} raw "
                f"sample pairs, got {blocks.dtype}")
        want = (self.n_streams, self.chain_blocks * self.cfg.block_len, 2)
        if blocks.shape != want:
            raise ValueError(f"expected {want}, got {blocks.shape}")
        # Not made contiguous: a column slice of a longer capture goes
        # straight into the pinned staging (utils.to_device), one copy.
        return np.asarray(blocks, dtype=feed_dtype)

    def process_blocks(self, blocks: np.ndarray):
        """blocks: (n_streams, chain_blocks*block_len) complex64 or
        (..., 2) float32 for ingest "f32", (..., 2) int16 / uint8 raw sample
        pairs for "i16" / "u8" -> per-stream BlockOutput (PackedOutput with
        packed_output) of numpy arrays; with chain_blocks=K the rows are the
        K blocks' step-concatenation."""
        with span("fleet.process_blocks"):
            blocks = self._feed(blocks)
            prev, outs, tel_tick, locked_vec = self._dispatch(blocks)
            if self.recover_flagged and np.any(self.stream_flags):
                outs = self._recover(prev, blocks, outs,
                                     update_telemetry=tel_tick,
                                     locked_vec=locked_vec)
            if tel_tick and self._rescue_blocks:
                self._rescue_streak[locked_vec == 0] += 1
                self._rescue_streak[locked_vec != 0] = 0
                self._maybe_rescue()
            return outs

    def _dispatch(self, blocks: np.ndarray):
        """One step of every shard on checked blocks: every shard's upload,
        step and readback are queued, each on its shard's stream, before the
        host waits for the readbacks. Sets stream_flags, and the
        telemetry on a telemetry tick. Returns (the pre-dispatch carries,
        which stay on their devices and are fetched only if a stream flags;
        the outputs as numpy in stream order; whether this was a tick; the
        locked vector on a tick, else None)."""
        sh = self._shards
        prev = list(self._carries)
        tel_tick = (self._block_idx % self.telemetry_every) == 0
        self._block_idx += 1
        fns = self._get_fns(tel_tick)
        waits = []
        for i, rows in enumerate(sh.rows):
            with sh.on(i, carry_leaves(self._carries[i])):
                with span("fleet.upload"):
                    x = to_device(blocks[rows], sh.devices[i])
                with span("fleet.launch"):
                    self._carries[i], outs, tel = fns[i](self._carries[i], x)
                with span("fleet.readback"):
                    want = list(dataclasses.astuple(outs)) + [
                        self._carries[i].flags]
                    if tel_tick:
                        want += [self._carries[i].locked] + [
                            tel[k] for k in TELEMETRY]
                    waits.append(to_host_async(want))
        with span("fleet.readback"):
            host = [wait() for wait in waits]
            col = lambda j: _cat([h[j] for h in host])
            n_out = len(dataclasses.astuple(outs))
            outs = type(outs)(*(col(j) for j in range(n_out)))
            self.stream_flags = np.array(col(n_out))
            if not tel_tick:
                return prev, outs, False, None
            self.telemetry = combine_telemetry(
                [dict(zip(TELEMETRY, h[n_out + 2:])) for h in host])
            return prev, outs, True, np.array(col(n_out + 1))

    def _maybe_rescue(self) -> None:
        """Kick long-unlocked streams onto the downward escape sweep (see
        set_sweep_rescue): their lanes of p_freq and updown are rewritten on
        their shards' devices."""
        blocks_per_tick = self.telemetry_every * self.chain_blocks
        kick_ticks = -(-self._rescue_blocks // blocks_per_tick)
        lanes = np.nonzero(self._rescue_streak >= kick_ticks)[0]
        if not len(lanes):
            return
        sh = self._shards
        for i, rows in enumerate(sh.rows):
            local = lanes[(lanes >= rows.start) & (lanes < rows.stop)]
            if not len(local):
                continue
            c = self._carries[i]
            idx = torch.as_tensor(local - rows.start, device=sh.devices[i])
            p_freq, updown = c.p_freq.clone(), c.updown.clone()
            p_freq[idx] = float(self.cfg.pll_fmax)
            updown[idx] = -1.0
            self._carries[i] = dataclasses.replace(c, p_freq=p_freq,
                                                   updown=updown)
        self._rescue_streak[lanes] = -(self._rescue_transit_blocks
                                       // blocks_per_tick)

    def _decode_rows(self, rows: np.ndarray) -> np.ndarray:
        """Raw-ingest rows -> f32 (decode_iq's math) for the host oracle."""
        if self.ingest == "i16":
            return rows.astype(np.float32)
        if self.ingest == "u8":
            return rows.astype(np.float32) - np.float32(128.0)
        return rows

    def _recover(self, prev: list, blocks: np.ndarray, outs,
                 update_telemetry: bool = True, locked_vec=None):
        """Re-demodulate every flagged stream's whole dispatch span with the
        exact scalar oracle from the pre-dispatch carries `prev` (one a
        shard), block by block (pipeline.oracle_replay), splice the
        corrected symbols into `outs` (left-justified in the step slots:
        chronological order, which is all consumers rely on), and write the
        corrected carry back to the shards that hold a flagged stream; the
        other shards are left alone. Flags are cleared: a nonzero
        stream_flags entry always refers to the dispatch just processed."""
        with span("fleet.recover"):
            sh = self._shards
            flagged = np.nonzero(self.stream_flags)[0]
            prev_np = sh.carry_to_numpy(prev)
            cur = {k: np.array(v)
                   for k, v in sh.carry_to_numpy(self._carries).items()}
            outs = type(outs)(*(np.array(v)
                                for v in dataclasses.astuple(outs)))
            a, b = (("sym_i", "sym_q") if self.packed_output
                    else ("sym_re", "sym_im"))
            slots = outs.valid.shape[1]
            for i in flagged:
                st = numpy_carry_to_scalar_state(
                    self.cfg, {k: v[i] for k, v in prev_np.items()})
                sym, st = oracle_replay(
                    self.cfg, f32_to_iq(self._decode_rows(blocks[i])), st)
                n = len(sym)
                if n > slots:
                    raise RuntimeError(
                        f"stream {i}: oracle produced {n} symbols > {slots} "
                        f"slots")
                for k, v in scalar_state_to_numpy_carry(self.cfg, st).items():
                    cur[k][i] = v
                re, im = sym["re"], sym["im"]
                if self.packed_output:
                    re, im = quantize(re), quantize(im)
                getattr(outs, a)[i] = 0
                getattr(outs, b)[i] = 0
                outs.valid[i] = 0
                getattr(outs, a)[i, :n] = re
                getattr(outs, b)[i, :n] = im
                outs.valid[i, :n] = 1
                outs.locked_once[i, :n] = sym["locked_once"]
                outs.locked_once[i, n:] = st["locked_once"]
            self.recovered_streams += len(flagged)
            if locked_vec is not None:
                locked_vec[flagged] = cur["locked"][flagged]
            for j in sorted({int(i) // sh.per for i in flagged}):
                self._carries[j] = carry_from_numpy(
                    {k: v[sh.rows[j]] for k, v in cur.items()}, sh.devices[j])
            if update_telemetry:
                # Re-derive the fleet telemetry from the corrected host state
                # (the device values were taken before the splice). Between
                # ticks self.telemetry keeps the last tick's values.
                self.telemetry = self.telemetry_of(cur, outs.valid)
            return outs

    def telemetry_of(self, leaves: dict, valid: np.ndarray) -> dict:
        """The fleet telemetry of host carry leaves and a valid array (both
        in stream order), combined over the shards as the step's is; flags
        0, as after a recovery."""
        return combine_telemetry([dict(
            locked_streams=leaves["locked"][r].sum(),
            locked_once_streams=leaves["locked_once"][r].sum(),
            symbols=valid[r].sum(),
            mean_agc_gain=leaves["agc_gain"][r].mean(),
            flags=0) for r in self._shards.rows])

    def flagged_streams(self) -> np.ndarray:
        """Indices of streams that tripped a safety flag in the last
        dispatch. With recover_flagged (the default) they have already been
        re-demodulated exactly and their carry and output corrected; the
        indices are reported for observability. With recover_flagged=False
        the flags are sticky and the stream's output is suspect from the
        flagged dispatch onward."""
        if self.stream_flags is None:
            return np.zeros(0, dtype=np.int64)
        return np.nonzero(self.stream_flags)[0]

    # -- the JAX package's parking interface ---------------------------------
    #
    # No stream parks here (the module docstring). These keep the JAX
    # FleetDemodulator's calls working for a caller that moves between the
    # packages, and deliver the rows a loaded JAX capture deferred.

    def parked_streams(self) -> np.ndarray:
        """Indices of parked streams: always none; a parked stream of a
        loaded JAX capture is back on its lane."""
        return np.zeros(0, dtype=np.int64)

    def parked_output(self, i: int) -> dict:
        """Drain stream i's deferred rows: those a loaded JAX capture held
        for it (its retired rows, then its parked rows), once, as
        deliver_rows gives them; after that, empty arrays. The lane's own
        rows come out of process_blocks like every other lane's."""
        return deliver_rows(self.take_deferred(i), self.packed_output)

    def take_deferred(self, i: int) -> list:
        """Pop stream i's deferred rows as stored (float32 symbols)."""
        return self._deferred_rows.pop(int(i), [])

    def wait_parked_drained(self, timeout_s: float = 60.0) -> None:
        """The JAX package's wait for its park worker. Nothing is parked
        here, so it returns at once."""

    # -- checkpoint state (io/checkpoint.py wraps these in .npz files) ------
    #
    # The serialization mirror lives here, next to the state it mirrors: a
    # new fleet state field is added to __init__ and to state_dict /
    # restore_state in the same edit. Rows are in stream order whatever the
    # shard count, so a capture taken on one device list restores on any
    # other that divides n_streams.

    def state_dict(self) -> tuple[dict, dict]:
        """(json-able meta, numpy arrays) capturing this fleet exactly, in
        the JAX package's fleet layout: every field its restore_state reads.
        Its policy parameters are jax_policy; its parking, flap and program
        switch counters are zeros, as in a fleet that never parked; rows not
        yet drained by parked_output go in as a retired stream's. Does not
        change the fleet."""
        leaves = self._shards.carry_to_numpy(self._carries)
        arrays = {f"carry_{k}": v for k, v in leaves.items()}
        arrays["rescue_streak"] = self._rescue_streak.copy()
        if self.stream_flags is not None:
            arrays["stream_flags"] = np.array(self.stream_flags)
        arrays["unlock_streak"] = np.zeros(self.n_streams, np.int64)
        arrays["flap_count"] = np.zeros(self.n_streams, np.int64)
        # The JAX fleet's per-lane readbacks of its last tick, from the
        # carry.
        arrays["last_locked_vec"] = leaves["locked"].copy()
        arrays["lonce_vec"] = leaves["locked_once"].copy()
        arrays["agc_vec"] = leaves["agc_gain"].copy()
        for i, rows in self._deferred_rows.items():
            pack_rows(rows, arrays, f"retired_{i}_rows_")
        meta = dict(
            cfg=dataclasses.asdict(self.cfg),
            n_streams=self.n_streams,
            **self.jax_policy,
            port_backend=self._backend,
            recover_flagged=self.recover_flagged,
            telemetry_every=self.telemetry_every,
            sweep_rescue_s=self.sweep_rescue_s,
            chain_blocks=self.chain_blocks,
            ingest=self.ingest,
            packed_output=self.packed_output,
            tick_idx=0, block_idx=self._block_idx,
            active_locked=None, wide_latch=False, use_banded=False,
            recovered_streams=int(self.recovered_streams),
            telemetry=(None if self.telemetry is None else
                       {k: float(v) for k, v in self.telemetry.items()}),
            parked={},
            retired=sorted(self._deferred_rows))
        return meta, arrays

    def restore_state(self, meta: dict, z, prefix: str = "") -> None:
        """Overwrite this fleet's state from a state_dict capture of either
        package (`z` is any mapping of the arrays with key list `z.files`,
        e.g. an open npz). The fleet must have been constructed with the
        same cfg and n_streams; policy parameters are re-applied from meta
        so a default-constructed fleet becomes exact. A JAX capture's
        parked streams go back onto their lanes (_unpark_saved), and their
        deferred rows and those of its retired streams wait for
        parked_output. The JAX policy parameters are kept for state_dict;
        its counters, program switch and banding are ignored. A capture that
        cannot be resumed exactly raises ValueError naming why (a field it
        lacks raises KeyError, which the loaders of io/checkpoint.py turn
        into ValueError)."""
        p = prefix
        self.recover_flagged = bool(meta["recover_flagged"])
        self.telemetry_every = int(meta["telemetry_every"])
        new_chain = int(meta.get("chain_blocks", 1))
        new_ingest = meta.get("ingest", "f32")
        new_packed = bool(meta.get("packed_output", False))
        if (new_chain != self.chain_blocks or new_ingest != self.ingest
                or new_packed != self.packed_output):
            # Structural: the built steps have the wrong shape.
            self.chain_blocks = new_chain
            self.ingest = new_ingest
            self.packed_output = new_packed
            self._fns = {}
        self.set_sweep_rescue(float(meta.get("sweep_rescue_s", 0.0)))
        self.jax_policy = jax_policy_of(meta, self.n_streams)
        leaves = {k: np.array(z[f"{p}carry_{k}"]) for k in CARRY_FIELDS}
        if leaves["t_phase"].shape != (self.n_streams,):
            raise ValueError(
                f"checkpoint carry has {leaves['t_phase'].shape} "
                f"streams, the fleet {self.n_streams}")
        if f"{p}rescue_streak" in z.files:
            self._rescue_streak = np.asarray(z[f"{p}rescue_streak"]).copy()
        self._deferred_rows = {}
        for i in meta.get("retired", ()):
            rows = unpack_rows(z, f"{p}retired_{int(i)}_rows_")
            if rows:
                self._deferred_rows[int(i)] = rows
        for i, pm in meta.get("parked", {}).items():
            self._unpark_saved(int(i), pm, z, p, leaves)
        self._carries = self._shards.carry_from_numpy(leaves)
        if f"{p}stream_flags" in z.files:
            self.stream_flags = np.asarray(z[f"{p}stream_flags"]).copy()
        if meta["telemetry"] is not None:
            self.telemetry = _telemetry_values(meta["telemetry"])
        self._block_idx = int(meta["block_idx"])
        self.recovered_streams = int(meta["recovered_streams"])

    def _unpark_saved(self, i: int, pm: dict, z, p: str,
                      leaves: dict) -> None:
        """Put parked stream i of a JAX capture back on its lane, in
        `leaves`, as the JAX package's unpark splice would: its exact host
        carry replaces the lane's (a donor's copy, fed the donor's data);
        a sweep kick it asked for is applied as the JAX park worker applies
        it before its next block; its rescue count goes on from the blocks
        fed since its last kick; its deferred rows queue after any retired
        ones."""
        if not 0 <= i < self.n_streams:
            raise ValueError(f"parked stream {i} is not a lane of "
                             f"{self.n_streams}")
        if int(pm["blocks_done"]) != int(pm["blocks_fed"]):
            raise ValueError(
                f"parked stream {i}: blocks_done {pm['blocks_done']} != "
                f"blocks_fed {pm['blocks_fed']}, so its host carry is not "
                f"the state after its last block")
        for k in CARRY_FIELDS:
            key = f"{p}parked_{i}_carry_{k}"
            v = np.asarray(z[key])
            if v.shape != leaves[k].shape[1:]:
                raise ValueError(f"{key} has shape {v.shape}, a lane's "
                                 f"{leaves[k].shape[1:]}")
            leaves[k][i] = v
        if pm.get("kick_wanted", False) and not pm["locked"]:
            leaves["p_freq"][i] = np.float32(self.cfg.pll_fmax)
            leaves["updown"][i] = np.float32(-1.0)
        since_kick = int(pm["blocks_fed"]) - int(pm.get("last_kick_fed", 0))
        self._rescue_streak[i] = since_kick // (self.telemetry_every
                                                * self.chain_blocks)
        rows = unpack_rows(z, f"{p}parked_{i}_rows_")
        if rows:
            self._deferred_rows.setdefault(i, []).extend(rows)
