"""Host-side streaming demodulator: blocks in, soft symbols out.

Feeds fixed-size sample blocks through the batch-1 block demodulator
(demod/backend.py), carries state across blocks, watches the safety flags,
and falls back to the exact scalar oracle for any flagged block and for the
sub-block tail at EOF. The result is sample-exact regardless of block size
or how the input was chunked.

On a CUDA device the calls are asynchronous: up to `lookahead` single
blocks are in flight before their results are fetched, and `chain_blocks`
buffered blocks are dispatched back to back with one fetch at the end.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DemodConfig
from ..constants import SWEEP_STEP
from ..dsp.fir import f32_to_iq, iq_to_f32
from .backend import make_batch_demod
from .state import BlockOutput, DemodCarry, batch_carry, carry_to_numpy
from . import scalar

_SYM_DTYPE = [("re", np.float32), ("im", np.float32), ("locked_once", np.int32)]
_TELEMETRY = ("p_freq", "t_freq", "locked", "locked_once", "agc_gain")


def numpy_carry_to_scalar_state(cfg: DemodConfig, c: dict) -> dict:
    """Numpy carry leaves of one stream (0-d) -> scalar oracle state."""
    return dict(
        t_phase=np.float32(c["t_phase"]), t_freq=np.float32(c["t_freq"]),
        t_prev=np.float32(c["t_prev"]),
        p_phase=np.float32(c["p_phase"]), p_freq=np.float32(c["p_freq"]),
        p_err=np.float32(c["p_err"]),
        locked=int(c["locked"]), locked_once=int(c["locked_once"]),
        updown=np.float32(c["updown"]),
        agc_gain=np.float32(c["agc_gain"]),
        agc_bias=np.complex64(complex(c["agc_bias_re"], c["agc_bias_im"])),
        inphase=np.float32(c["inphase"]), slot=int(c["slot"]),
        fir_tail=f32_to_iq(np.asarray(c["fir_tail"], dtype=np.float32)),
    )


def carry_to_scalar_state(cfg: DemodConfig, carry: DemodCarry) -> dict:
    """Batch-1 carry -> scalar oracle state."""
    return numpy_carry_to_scalar_state(
        cfg, {k: v[0] for k, v in carry_to_numpy(carry).items()})


def scalar_state_to_numpy_carry(cfg: DemodConfig, st: dict) -> dict:
    """Scalar oracle state -> dict of unbatched numpy DemodCarry leaves
    (tick reset, flags cleared — the oracle result is exact)."""
    bias = np.complex64(st["agc_bias"])
    return dict(
        t_phase=np.float32(st["t_phase"]), t_freq=np.float32(st["t_freq"]),
        t_prev=np.float32(st["t_prev"]),
        p_phase=np.float32(st["p_phase"]), p_freq=np.float32(st["p_freq"]),
        p_err=np.float32(st["p_err"]),
        locked=np.int32(st["locked"]), locked_once=np.int32(st["locked_once"]),
        updown=np.float32(st["updown"]), agc_gain=np.float32(st["agc_gain"]),
        agc_bias_re=np.float32(bias.real), agc_bias_im=np.float32(bias.imag),
        inphase=np.float32(st["inphase"]), slot=np.int32(st["slot"]),
        tick=np.int32(0),
        fir_tail=iq_to_f32(np.asarray(st["fir_tail"], dtype=np.complex64)),
        flags=np.int32(0),
    )


def scalar_state_to_carry(cfg: DemodConfig, st: dict, device) -> DemodCarry:
    """Scalar oracle state -> batch-1 carry on `device`."""
    leaves = scalar_state_to_numpy_carry(cfg, st)
    return DemodCarry(**{
        k: torch.as_tensor(np.asarray(v)[None], device=device)
        for k, v in leaves.items()})


def _fetch(carry: DemodCarry, outs) -> tuple[dict, BlockOutput]:
    """Device -> host: the flags and telemetry leaves of a batch-1 carry and
    the BlockOutput (or list of them, concatenated in order)."""
    if isinstance(outs, list):
        outs = BlockOutput(*(torch.cat(col, dim=1) for col in
                             zip(*(dataclasses.astuple(o) for o in outs))))
    tel = {k: getattr(carry, k)[0].item() for k in ("flags",) + _TELEMETRY}
    host = BlockOutput(*(a.cpu().numpy() for a in dataclasses.astuple(outs)))
    return tel, host


def _outputs_to_symbols(outs: BlockOutput) -> np.ndarray:
    """outs: numpy BlockOutput of one stream, (1, S) leaves."""
    valid = np.asarray(outs.valid).astype(bool)
    symbols = np.zeros(int(valid.sum()), dtype=_SYM_DTYPE)
    symbols["re"] = outs.sym_re[valid]
    symbols["im"] = outs.sym_im[valid]
    symbols["locked_once"] = outs.locked_once[valid]
    return symbols


class StreamDemodulator:
    """Stateful streaming demodulator over arbitrary-size input chunks.

    Mirrors the reference worker thread's contract (main.c:284-329): feed IQ
    samples in, get soft symbols out, with telemetry getters for the UI
    (pll.c:46-48, timing.c:29, agc.c:27-31).

    `fallback_blocks` counts this instance's blocks recomputed by the scalar
    oracle after a safety flag; the class attribute `replayed_blocks` counts
    them over every instance, so a caller that only reaches the CLI can tell
    whether any output came from the host replay. The EOF tail, which always
    goes through the oracle, is not counted.
    """

    replayed_blocks = 0

    def __init__(self, cfg: DemodConfig, device="cpu",
                 sweep_rescue_s: float = 0.0):
        cfg.validate()
        self.cfg = cfg
        self.device = torch.device(device)
        self._fn = make_batch_demod(cfg, 1, self.device)
        self._carry = batch_carry(cfg, 1, self.device)
        self._pending = np.zeros(0, dtype=np.complex64)
        self.fallback_blocks = 0
        self.symbols_out = 0
        # Dispatch pipeline: up to `lookahead` blocks are in flight before
        # their results are fetched, hiding the device->host wait behind
        # the next block's compute. Entries: (prev_carry, block_np, carry,
        # outs).
        self.lookahead = 2
        self._inflight = []
        self._backlog = []
        # When this many blocks are buffered, they are dispatched back to
        # back with one upload and one fetch — the fast path for file
        # inputs and bursty streams.
        self.chain_blocks = 8
        # Host-side telemetry snapshot, refreshed by the processing thread
        # after each fetch. UI threads read these plain floats and never
        # touch the device.
        self._telemetry = dict(
            p_freq=0.0, t_freq=float(cfg.timing_freq), locked=False,
            locked_once=False, agc_gain=1.0)
        # Sweep rescue (opt-in; 0 = off = exact reference acquisition): the
        # reference's upward-first sweep has a dead zone for small-negative
        # carrier offsets (a stable false equilibrium near 0 Hz that -195 Hz
        # @ 25 dB never escapes; pll.c:109-130). After sweep_rescue_s
        # seconds of unlocked signal the carry is kicked onto the downward
        # escape pass (p_freq=+fmax, updown=-1), which captures every
        # in-range carrier. CLI: --sweep-rescue.
        self.sweep_rescue_s = float(sweep_rescue_s)
        self._rescue_pending_samples = 0
        # Post-kick cooldown: a full downward pass takes 2*fmax/SWEEP_STEP
        # symbols; re-kicking before the pass completes would reset the
        # sweep forever. The counter goes negative after a kick so the next
        # one waits transit + budget.
        self._rescue_transit_samples = int(
            2.0 * float(cfg.pll_fmax) / SWEEP_STEP
            * cfg.samplerate / cfg.symrate)

    def _set_telemetry(self, tel: dict) -> None:
        self._telemetry = dict(
            p_freq=float(tel["p_freq"]), t_freq=float(tel["t_freq"]),
            locked=bool(tel["locked"]), locked_once=bool(tel["locked_once"]),
            agc_gain=float(tel["agc_gain"]))

    def _publish_telemetry(self) -> None:
        self._set_telemetry({k: getattr(self._carry, k)[0].item()
                             for k in _TELEMETRY})

    # -- telemetry (reference getter parity) --------------------------------
    @property
    def pll_freq(self) -> float:
        return self._telemetry["p_freq"]

    @property
    def pll_locked(self) -> bool:
        return self._telemetry["locked"]

    @property
    def pll_locked_once(self) -> bool:
        return self._telemetry["locked_once"]

    @property
    def mm_omega(self) -> float:
        return self._telemetry["t_freq"]

    @property
    def agc_gain(self) -> float:
        return self._telemetry["agc_gain"]

    def carrier_freq_hz(self) -> float:
        """Estimated carrier offset in Hz (main.c:231 conversion)."""
        mult = 2 if self.cfg.oqpsk else 1
        return self.pll_freq * self.cfg.symrate / (2 * np.pi) * mult

    def symbol_rate_hz(self) -> float:
        """Estimated symbol rate in Hz (main.c:232 conversion)."""
        return (self.mm_omega * self.cfg.samplerate * self.cfg.interp
                / (2 * np.pi))

    # -- processing ----------------------------------------------------------
    def process(self, samples: np.ndarray) -> np.ndarray:
        """Feed samples (any length, complex64); returns produced symbols."""
        self._pending = np.concatenate(
            [self._pending, np.asarray(samples, dtype=np.complex64)])
        chunks, self._backlog = self._backlog, []
        self._drain_blocks(chunks)
        if self.sweep_rescue_s > 0:
            self._maybe_sweep_kick(len(samples))
        if chunks:
            out = np.concatenate(chunks)
            self.symbols_out += len(out)
            return out
        return np.zeros(0, dtype=_SYM_DTYPE)

    def _maybe_sweep_kick(self, n_samples: int) -> None:
        """Count unlocked signal; kick the carry onto the downward escape
        sweep when the budget is exceeded (see __init__)."""
        if self._telemetry["locked"]:
            self._rescue_pending_samples = 0
            return
        self._rescue_pending_samples += n_samples
        if (self._rescue_pending_samples
                < self.sweep_rescue_s * self.cfg.samplerate):
            return
        self.sync()
        if int(self._carry.locked[0].item()):   # locked since the last refresh
            self._rescue_pending_samples = 0
            return
        self._carry = dataclasses.replace(
            self._carry,
            p_freq=torch.full_like(self._carry.p_freq, float(self.cfg.pll_fmax)),
            updown=torch.full_like(self._carry.updown, -1.0))
        self._publish_telemetry()
        self._rescue_pending_samples = -self._rescue_transit_samples

    def _drain_blocks(self, chunks: list) -> None:
        """Drain _pending through the chained / single-block device paths
        down to a sub-block tail, appending symbol arrays to `chunks`."""
        L = self.cfg.block_len
        while len(self._pending) >= self.chain_blocks * L:
            # Drain in-flight singles first and FLUSH their symbols into the
            # output now — emitting them later would reorder the stream.
            self.sync()
            chunks.extend(self._backlog)
            self._backlog = []
            span = self._pending[:self.chain_blocks * L]
            self._pending = self._pending[self.chain_blocks * L:]
            chunks.append(self._run_chained(span))
        while len(self._pending) >= L:
            block, self._pending = self._pending[:L], self._pending[L:]
            chunks.append(self._run_block(block))

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(iq_to_f32(x), device=self.device)

    def _oracle(self, x: np.ndarray, prev_carry: DemodCarry) -> np.ndarray:
        """Recompute x exactly with the scalar oracle from prev_carry, block
        by block (so the timing-gate rounding at block boundaries matches
        the block path), and install the resulting carry."""
        L = self.cfg.block_len
        st = carry_to_scalar_state(self.cfg, prev_carry)
        parts = []
        for i in range(0, len(x), L):
            sym, st = scalar.demod_stream_np(self.cfg, x[i:i + L], st)
            parts.append(sym)
        self._carry = scalar_state_to_carry(self.cfg, st, self.device)
        self._publish_telemetry()
        return np.concatenate(parts)

    def _count_replay(self, n_blocks: int) -> None:
        self.fallback_blocks += n_blocks
        StreamDemodulator.replayed_blocks += n_blocks

    def _run_chained(self, span: np.ndarray) -> np.ndarray:
        """Demodulate chain_blocks consecutive blocks with one upload and
        one fetch."""
        k = self.chain_blocks
        L = self.cfg.block_len
        prev_carry = self._carry
        blocks = self._upload(span).view(k, 1, L, 2)
        carry, outs = prev_carry, []
        for i in range(k):
            carry, o = self._fn(carry, blocks[i])
            outs.append(o)
        tel, outs_np = _fetch(carry, outs)
        if tel["flags"] != 0:
            # Safety net: recompute the span with the scalar oracle.
            self._count_replay(k)
            return self._oracle(span, prev_carry)
        self._carry = carry
        self._set_telemetry(tel)
        return _outputs_to_symbols(outs_np)

    def _run_block(self, block: np.ndarray) -> np.ndarray:
        prev_carry = self._carry
        carry, outs = self._fn(prev_carry, self._upload(block)[None])
        self._inflight.append((prev_carry, block, carry, outs))
        self._carry = carry
        if len(self._inflight) > self.lookahead:
            return self._drain_one()
        return np.zeros(0, dtype=_SYM_DTYPE)

    def _drain_one(self) -> np.ndarray:
        """Fetch the oldest in-flight block's results (flags, telemetry,
        symbols); on a safety flag, recompute it with the scalar oracle and
        replay every younger in-flight block from the corrected carry."""
        prev_carry, block, carry, outs = self._inflight.pop(0)
        tel, outs_np = _fetch(carry, outs)
        if tel["flags"] != 0:
            self._count_replay(1)
            symbols = self._oracle(block, prev_carry)
            replay = [b for (_, b, _, _) in self._inflight]
            self._inflight = []
            for b in replay:
                pc = self._carry
                c2, o2 = self._fn(pc, self._upload(b)[None])
                self._inflight.append((pc, b, c2, o2))
                self._carry = c2
            return symbols
        self._set_telemetry(tel)
        return _outputs_to_symbols(outs_np)

    def sync(self) -> None:
        """Drain the dispatch pipeline, buffering its symbols for the next
        process()/finish() return. Leaves _carry/_pending authoritative."""
        while self._inflight:
            self._backlog.append(self._drain_one())

    def finish(self) -> np.ndarray:
        """Drain the dispatch pipeline and any buffered full blocks, then
        process the remaining sub-block tail with the exact oracle."""
        self.sync()
        chunks, self._backlog = self._backlog, []
        self._drain_blocks(chunks)
        self.sync()
        chunks.extend(self._backlog)
        self._backlog = []
        if len(self._pending):
            chunks.append(self._oracle(self._pending, self._carry))
            self._pending = np.zeros(0, dtype=np.complex64)
        out = (np.concatenate(chunks) if chunks
               else np.zeros(0, dtype=_SYM_DTYPE))
        self.symbols_out += len(out)
        return out


def demod_array(cfg: DemodConfig, x: np.ndarray, device="cpu") -> np.ndarray:
    """One-shot demodulation of a full array (tests / offline use)."""
    d = StreamDemodulator(cfg, device)
    out = [d.process(x), d.finish()]
    return np.concatenate(out)


def quantize_symbols(symbols: np.ndarray) -> np.ndarray:
    """Soft symbols -> interleaved int8 bytes (main.c:305-306 semantics:
    component/2, clamped to +-127, truncated toward zero)."""
    out = np.empty(2 * len(symbols), dtype=np.int8)
    re = np.trunc(np.clip(symbols["re"] * np.float32(0.5), -127.0, 127.0))
    im = np.trunc(np.clip(symbols["im"] * np.float32(0.5), -127.0, 127.0))
    out[0::2] = re.astype(np.int8)
    out[1::2] = im.astype(np.int8)
    return out
