"""Fleet demodulation on one GPU: many independent streams per dispatch.

The reference is a single-process, single-stream program; a station fleet
runs N of them. Here the N streams are the batch axis of one block
demodulator (demod/backend.py) on one card: each stream's carry and sample
blocks get a leading `streams` axis, and a dispatch runs `chain_blocks`
consecutive blocks between one upload and one readback. Streams never
exchange data; the only reductions are the five fleet telemetry sums, read
back on telemetry ticks as the reference's UI thread polls its DSP getters
(main.c:231-237) without touching the hot path.

This is the JAX package's parallel/mesh.py without its device mesh (one card;
sharding over several is a later slice) and without three TPU-era policies
that the port leaves out on purpose:

- straggler parking (a host side-path for never-locking streams, its worker
  thread and deferred output): it existed so that the wide<->locked program
  switch could ignore dead streams, and outputs are the same without it;
- the wide<->locked program switch and its demotion latch: the CUDA kernels
  read each fired tick directly and have one program;
- tau0-banded groups (`banded_cfg`, `use_banded`): window economy of the
  TPU kernel.

So there are no `park*` constructor arguments, and a checkpoint that holds
parked streams is refused (io/checkpoint.py).
"""

from __future__ import annotations

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
from ..utils import select_device

INGESTS = {"f32": np.float32, "i16": np.int16, "u8": np.uint8}


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


def _telemetry_values(tel: dict) -> dict:
    """Telemetry in its host form: np.float32 mean_agc_gain, np.int32 sums."""
    return {k: (np.float32(v) if k == "mean_agc_gain" else np.int32(v))
            for k, v in tel.items()}


class FleetDemodulator:
    """Demodulate a fleet of independent IQ streams on one device.

    The equivalent of running n_streams reference processes: feed aligned
    (n_streams, chain_blocks*block_len) blocks, collect per-stream symbols
    and fleet telemetry. device=None is the CUDA card (utils.select_device).
    """

    def __init__(self, cfg: DemodConfig, n_streams: int, device=None,
                 backend: str = "auto", recover_flagged: bool = True,
                 telemetry_every: int = 1, sweep_rescue_s: float = 0.0,
                 chain_blocks: int = 1, ingest: str = "f32",
                 packed_output: bool = False):
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
        self.device = select_device(device)
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
        # Telemetry amortization: the fleet sums are computed and read back
        # every telemetry_every-th dispatch, as the reference polls its
        # getters at the UI refresh interval and not per buffer. In between,
        # self.telemetry holds the last tick's values; per-stream outputs
        # and safety flags are read every dispatch regardless.
        self.telemetry_every = telemetry_every
        self._block_idx = 0
        self._fns = {}
        self._stage_in = self._stage_out = None    # pinned, made on first use
        self._get_fn(telemetry=True)         # checks backend and device now
        self.carry = batch_carry(cfg, n_streams, self.device)
        self.telemetry = None
        self.stream_flags = None
        # When True (default), a stream whose dispatch trips a safety flag is
        # re-demodulated through the exact scalar oracle from its
        # pre-dispatch carry and its outputs and carry are spliced back: the
        # fleet then has StreamDemodulator's always-exact contract.
        self.recover_flagged = recover_flagged
        self.recovered_streams = 0

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

    def _get_fn(self, telemetry: bool) -> Callable:
        if telemetry not in self._fns:
            self._fns[telemetry] = make_fleet_demod(
                self.cfg, self.n_streams, self.device, self._backend,
                telemetry=telemetry, chain=self.chain_blocks,
                ingest=self.ingest, packed=self.packed_output)
        return self._fns[telemetry]

    def process_blocks(self, blocks: np.ndarray):
        """blocks: (n_streams, chain_blocks*block_len) complex64 or
        (..., 2) float32 for ingest "f32", (..., 2) int16 / uint8 raw sample
        pairs for "i16" / "u8" -> per-stream BlockOutput (PackedOutput with
        packed_output) of numpy arrays; with chain_blocks=K the rows are the
        K blocks' step-concatenation."""
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
        blocks = np.asarray(blocks, dtype=feed_dtype)
        # The pre-dispatch carry stays on the device (the step returns new
        # tensors); it is fetched only if a stream flags.
        prev_carry = self.carry
        x = self._upload(blocks)
        tel_tick = (self._block_idx % self.telemetry_every) == 0
        self._block_idx += 1
        self.carry, outs, tel = self._get_fn(tel_tick)(self.carry, x)
        outs = type(outs)(*self._download(dataclasses.astuple(outs)))
        self.stream_flags = np.array(self.carry.flags.cpu().numpy())
        locked_vec = None
        if tel_tick:
            self.telemetry = _telemetry_values(
                {k: v.item() for k, v in tel.items()})
            locked_vec = np.array(self.carry.locked.cpu().numpy())
        if self.recover_flagged and np.any(self.stream_flags):
            outs = self._recover(prev_carry, blocks, outs,
                                 update_telemetry=tel_tick,
                                 locked_vec=locked_vec)
        if tel_tick and self._rescue_blocks:
            self._rescue_streak[locked_vec == 0] += 1
            self._rescue_streak[locked_vec != 0] = 0
            self._maybe_rescue()
        return outs

    # Host <-> card copies go through pinned staging buffers, kept from
    # dispatch to dispatch: a copy from or to pageable memory ran at under
    # 1 GB/s on an H100's host and was a quarter of a chain's wall time
    # (PERF.md section 6). On the CPU the arrays are used where they lie.

    def _upload(self, blocks: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(blocks)
        if self.device.type != "cuda":
            return src
        if self._stage_in is None:
            self._stage_in = torch.empty(src.shape, dtype=src.dtype,
                                         pin_memory=True)
        self._stage_in.copy_(src)
        # The dispatch ends in a synchronous readback, so the buffer is
        # free again before the next dispatch writes it.
        return self._stage_in.to(self.device, non_blocking=True)

    def _download(self, tensors) -> list[np.ndarray]:
        if self.device.type != "cuda":
            return [t.numpy() for t in tensors]
        if self._stage_out is None:
            self._stage_out = [torch.empty(t.shape, dtype=t.dtype,
                                           pin_memory=True) for t in tensors]
        for dst, t in zip(self._stage_out, tensors):
            dst.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return [dst.numpy().copy() for dst in self._stage_out]

    def _maybe_rescue(self) -> None:
        """Kick long-unlocked streams onto the downward escape sweep (see
        set_sweep_rescue): their lanes of p_freq and updown are rewritten on
        the device."""
        blocks_per_tick = self.telemetry_every * self.chain_blocks
        kick_ticks = -(-self._rescue_blocks // blocks_per_tick)
        lanes = np.nonzero(self._rescue_streak >= kick_ticks)[0]
        if not len(lanes):
            return
        idx = torch.as_tensor(lanes, device=self.device)
        p_freq, updown = self.carry.p_freq.clone(), self.carry.updown.clone()
        p_freq[idx] = float(self.cfg.pll_fmax)
        updown[idx] = -1.0
        self.carry = dataclasses.replace(self.carry, p_freq=p_freq,
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

    def _recover(self, prev_carry: DemodCarry, blocks: np.ndarray, outs,
                 update_telemetry: bool = True, locked_vec=None):
        """Re-demodulate every flagged stream's whole dispatch span with the
        exact scalar oracle from the pre-dispatch carry, block by block
        (pipeline.oracle_replay), splice the corrected symbols into `outs`
        (left-justified in the step slots: chronological order, which is all
        consumers rely on), and write the corrected carry back to the
        device. Flags are cleared: a nonzero stream_flags entry always
        refers to the dispatch just processed."""
        flagged = np.nonzero(self.stream_flags)[0]
        prev_np = carry_to_numpy(prev_carry)
        cur = {k: np.array(v) for k, v in carry_to_numpy(self.carry).items()}
        outs = type(outs)(*(np.array(v) for v in dataclasses.astuple(outs)))
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
        self.carry = carry_from_numpy(cur, self.device)
        if update_telemetry:
            # Re-derive the fleet telemetry from the corrected host state
            # (the device sums were taken before the splice). Between ticks
            # self.telemetry keeps the last tick's values.
            self.telemetry = _telemetry_values({
                "locked_streams": cur["locked"].sum(),
                "locked_once_streams": cur["locked_once"].sum(),
                "symbols": outs.valid.sum(),
                "mean_agc_gain": cur["agc_gain"].mean(),
                "flags": 0})
        return outs

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

    # -- checkpoint state (io/checkpoint.py wraps these in .npz files) ------
    #
    # The serialization mirror lives here, next to the state it mirrors: a
    # new fleet state field is added to __init__ and to state_dict /
    # restore_state in the same edit.

    def state_dict(self) -> tuple[dict, dict]:
        """(json-able meta, numpy arrays) capturing this fleet exactly, in
        the JAX package's fleet layout less its parked, retired and banded
        fields. Does not change the fleet."""
        arrays = {f"carry_{k}": v
                  for k, v in carry_to_numpy(self.carry).items()}
        arrays["rescue_streak"] = self._rescue_streak.copy()
        if self.stream_flags is not None:
            arrays["stream_flags"] = np.array(self.stream_flags)
        meta = dict(
            cfg=dataclasses.asdict(self.cfg),
            n_streams=self.n_streams,
            backend=self._backend,
            recover_flagged=self.recover_flagged,
            telemetry_every=self.telemetry_every,
            sweep_rescue_s=self.sweep_rescue_s,
            chain_blocks=self.chain_blocks,
            ingest=self.ingest,
            packed_output=self.packed_output,
            block_idx=self._block_idx,
            recovered_streams=int(self.recovered_streams),
            telemetry=(None if self.telemetry is None else
                       {k: float(v) for k, v in self.telemetry.items()}))
        return meta, arrays

    def restore_state(self, meta: dict, z, prefix: str = "") -> None:
        """Overwrite this fleet's state from a state_dict capture of either
        package (`z` is any mapping of the arrays with key list `z.files`,
        e.g. an open npz). The fleet must have been constructed with the
        same cfg and n_streams; policy parameters are re-applied from meta
        so a default-constructed fleet becomes exact. Parking, program
        switch and banding fields of a JAX capture are ignored; a capture
        that holds parked streams is refused."""
        p = prefix
        if meta.get("parked") or meta.get("retired"):
            raise ValueError(
                "the checkpoint holds parked streams (host-side carries and "
                "deferred symbols); this port has no straggler parking and "
                "cannot resume them")
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
            self._stage_in = self._stage_out = None
        self.set_sweep_rescue(float(meta.get("sweep_rescue_s", 0.0)))
        self.carry = carry_from_numpy(
            {k: z[f"{p}carry_{k}"] for k in CARRY_FIELDS}, self.device)
        if self.carry.t_phase.shape != (self.n_streams,):
            raise ValueError(
                f"checkpoint carry has {tuple(self.carry.t_phase.shape)} "
                f"streams, the fleet {self.n_streams}")
        if f"{p}rescue_streak" in z.files:
            self._rescue_streak = np.asarray(z[f"{p}rescue_streak"]).copy()
        if f"{p}stream_flags" in z.files:
            self.stream_flags = np.asarray(z[f"{p}stream_flags"]).copy()
        if meta["telemetry"] is not None:
            self.telemetry = _telemetry_values(meta["telemetry"])
        self._block_idx = int(meta["block_idx"])
        self.recovered_streams = int(meta["recovered_streams"])
