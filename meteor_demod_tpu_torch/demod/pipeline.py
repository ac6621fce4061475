"""Host-side streaming demodulator: blocks in, soft symbols out.

Feeds fixed-size sample blocks through the batch-1 block demodulator
(demod/backend.py), carries state across blocks, watches the safety flags,
and falls back to the exact scalar oracle for any flagged block and for the
sub-block tail at EOF. The result is sample-exact regardless of block size
or how the input was chunked.

On a CUDA device the calls are asynchronous: up to `lookahead` single
blocks are in flight before their results are fetched, and `chain_blocks`
buffered blocks are dispatched back to back with one fetch at the end.

Span mode (span_turbo=True, the CLI's -T on stdin) buffers whole spans and
demodulates each across the block demodulator's lanes (demod/turbo.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DemodConfig
from ..constants import SWEEP_STEP
from ..dsp.fir import f32_to_iq, iq_to_f32
from .. import profiling
from ..io import native
from ..utils import select_device
from .backend import make_batch_demod
from .state import (CARRY_FIELDS, BlockOutput, DemodCarry, batch_carry,
                    carry_from_numpy, carry_to_numpy)
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


def oracle_replay(cfg: DemodConfig, x: np.ndarray, st: dict
                  ) -> tuple[np.ndarray, dict]:
    """Recompute x (complex64, whole blocks or a tail) exactly with the
    scalar oracle from state st, block by block, so that the timing gate's
    rounding at block boundaries matches the block path. Returns the symbols
    and the state after x."""
    L = cfg.block_len
    parts = []
    for i in range(0, len(x), L):
        sym, st = scalar.demod_stream_np(cfg, x[i:i + L], st)
        parts.append(sym)
    return (np.concatenate(parts) if parts
            else np.zeros(0, dtype=_SYM_DTYPE)), st


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

    def __init__(self, cfg: DemodConfig, device=None,
                 sweep_rescue_s: float = 0.0, span_turbo: bool = False,
                 span_chunks: int = 32, span_blocks: int = 16):
        cfg.validate()
        self.cfg = cfg
        # None: the CUDA card, or the CPU under METEOR_DEMOD_PLATFORM=cpu.
        self.device = select_device(device)
        # Speculative span mode: when a full span of input is buffered
        # (file-backed or bursty streams), demodulate it chunk-parallel
        # across span_chunks batch lanes with the gauge fixpoint
        # (demod/turbo.py span_submit) instead of the sequential block
        # chain, under the strict-turbo acceptance contract (verified lane
        # prefix, decision-final by induction; OQPSK additionally shrunk to
        # an even-gauge boundary; anything unverified stays buffered or
        # falls to the sequential path). Opt-in: the CLI's -T enables it
        # for stdin/live inputs.
        self.span_turbo = bool(span_turbo)
        self.span_chunks = span_chunks
        self.span_blocks = span_blocks
        self.spans_run = 0
        self.span_fallbacks = 0
        # Span mode's small feeds wait here and join _pending only when a
        # span is due (or at sync()), so that buffering a span of 8192-sample
        # reads does not copy the buffer once per read.
        self._feeds = []
        self._feeds_len = 0
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
    def set_carry(self, leaves: dict) -> None:
        """Install a carry given as numpy leaves of ONE stream (0-d, or with
        a leading axis of 1; carry_to_numpy's keys) on this demodulator's
        device, and refresh the telemetry from it: how turbo continues a
        stream from a chunk's exit carry."""
        self._carry = carry_from_numpy(
            {k: np.asarray(leaves[k]).reshape(
                (1, self.cfg.taps - 1, 2) if k == "fir_tail" else (1,))
             for k in CARRY_FIELDS}, self.device)
        self._publish_telemetry()

    def process(self, samples: np.ndarray) -> np.ndarray:
        """Feed samples (any length, complex64); returns produced symbols.

        Span mode BUFFERS sub-span input instead of draining it through the
        sequential paths: per-chunk feeding (the CLI's stdin loop delivers
        ~8k-sample pieces) must still accumulate the
        span_chunks*span_blocks*block_len samples a span needs, so the drain
        loops only run in non-span mode (and in finish()). The cost is
        latency: span mode emits nothing until a full span has buffered
        (~18 s of live 230 ksps input at the CLI defaults), the documented
        -T trade (cli.py)."""
        samples = np.asarray(samples, dtype=np.complex64)
        chunks, self._backlog = self._backlog, []
        if self.span_turbo:
            self._feeds.append(samples)
            self._feeds_len += len(samples)
            span_n = self.span_chunks * self.span_blocks * self.cfg.block_len
            if len(self._pending) + self._feeds_len >= span_n:
                self._join_feeds()
                self._drain_spans(chunks)
        else:
            self._pending = np.concatenate([self._pending, samples])
            self._drain_blocks(chunks)
        if self.sweep_rescue_s > 0:
            self._maybe_sweep_kick(len(samples))
        if chunks:
            with profiling.span("stream.collect"):
                out = np.concatenate(chunks)
            self.symbols_out += len(out)
            return out
        return np.zeros(0, dtype=_SYM_DTYPE)

    def _maybe_sweep_kick(self, n_samples: int) -> None:
        """Count unlocked signal; kick the carry onto the downward escape
        sweep when the budget is exceeded (see __init__)."""
        if self.span_turbo:
            # Span mode buffers a whole span before any device work: the
            # budget would count buffered (undemodulated) samples and kick
            # a carry that has seen no signal.
            return
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

    def _join_feeds(self) -> None:
        if self._feeds:
            self._pending = np.concatenate([self._pending, *self._feeds])
            self._feeds, self._feeds_len = [], 0

    def _drain_spans(self, chunks: list) -> None:
        """Drain _pending span by span, appending symbol arrays to `chunks`.

        Pipelined: span k+1 is SUBMITTED from span k's exit carry (final at
        submit time, turbo.SpanPending) before span k's bulk symbol payload
        is fetched and assembled."""
        L = self.cfg.block_len
        span_n = self.span_chunks * self.span_blocks * L
        span_pend = None
        while len(self._pending) >= span_n:
            self.sync()
            chunks.extend(self._backlog)
            self._backlog = []
            pend = self._submit_span(self._pending[:span_n])
            if pend is None:
                # Unverified span: bounded sequential progress (one chained
                # dispatch) so the buffer cannot grow without bound, then
                # retry the span path on the shifted buffer. Never wrong
                # output, worst case one redundant pass over the consumed
                # prefix. The earlier span's symbols go out first.
                if span_pend is not None:
                    chunks.append(self._finish_span(span_pend))
                    span_pend = None
                take = min(self.chain_blocks * L, span_n)
                seq, self._pending = (self._pending[:take],
                                      self._pending[take:])
                chunks.append(self._run_chained(seq))
                continue
            if span_pend is not None:
                chunks.append(self._finish_span(span_pend))
            span_pend = pend
        if span_pend is not None:
            chunks.append(self._finish_span(span_pend))

    def _submit_span(self, span: np.ndarray):
        """Run a buffered span chunk-parallel (turbo.span_submit).

        Consumes the verified prefix from _pending and installs its exit
        carry immediately (acceptance is decided by the small fetch alone);
        returns the SpanPending whose symbols _finish_span retrieves, or
        None when nothing verified (the caller falls through to the
        sequential chained path)."""
        from .turbo import span_submit
        with profiling.span("stream.span_submit"):
            carry0 = {k: v[0]
                      for k, v in carry_to_numpy(self._carry).items()}
            pend = span_submit(self.cfg, carry0, iq_to_f32(span),
                               chunks=self.span_chunks, device=self.device)
            self.spans_run += 1
            if pend.consumed == 0:
                self.span_fallbacks += 1
                return None
            self._pending = self._pending[pend.consumed:]
            self.set_carry(pend.exit_carry)
            return pend

    def _finish_span(self, pend) -> np.ndarray:
        """Fetch and assemble a submitted span's symbols
        (turbo.span_finish)."""
        from .turbo import span_finish
        with profiling.span("stream.span_finish"):
            return span_finish(self.cfg, pend).symbols

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
        # At most chain_blocks blocks (512 KiB): a plain copy. Through
        # utils.to_device's pinned staging the stream read 1.32 against 1.19
        # ms a QPSK block on an H100 (chip_measure.py --sections stream,
        # trees in turns, PERF.md section 6); that pays from megabytes up.
        return torch.as_tensor(iq_to_f32(x), device=self.device)

    def _oracle(self, x: np.ndarray, prev_carry: DemodCarry) -> np.ndarray:
        """Recompute x exactly with the scalar oracle from prev_carry
        (oracle_replay) and install the resulting carry."""
        with profiling.span("stream.oracle"):
            symbols, st = oracle_replay(
                self.cfg, x, carry_to_scalar_state(self.cfg, prev_carry))
            self._carry = scalar_state_to_carry(self.cfg, st, self.device)
            self._publish_telemetry()
            return symbols

    def _count_replay(self, n_blocks: int) -> None:
        self.fallback_blocks += n_blocks
        StreamDemodulator.replayed_blocks += n_blocks

    def _run_chained(self, span: np.ndarray) -> np.ndarray:
        """Demodulate a whole number of consecutive blocks (chain_blocks of
        them, or a short span's all) with one upload and one fetch."""
        L = self.cfg.block_len
        k = len(span) // L
        prev_carry = self._carry
        with profiling.span("stream.upload"):
            blocks = self._upload(span).view(k, 1, L, 2)
        with profiling.span("stream.launch"):
            carry, outs = prev_carry, []
            for i in range(k):
                carry, o = self._fn(carry, blocks[i])
                outs.append(o)
        with profiling.span("stream.fetch"):
            tel, outs_np = _fetch(carry, outs)
            symbols = _outputs_to_symbols(outs_np)
        if tel["flags"] != 0:
            # Safety net: recompute the span with the scalar oracle.
            self._count_replay(k)
            return self._oracle(span, prev_carry)
        self._carry = carry
        self._set_telemetry(tel)
        return symbols

    def _run_block(self, block: np.ndarray) -> np.ndarray:
        prev_carry = self._carry
        with profiling.span("stream.upload"):
            x = self._upload(block)[None]
        with profiling.span("stream.launch"):
            carry, outs = self._fn(prev_carry, x)
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
        with profiling.span("stream.fetch"):
            tel, outs_np = _fetch(carry, outs)
            symbols = _outputs_to_symbols(outs_np)
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
        return symbols

    def sync(self) -> None:
        """Drain the dispatch pipeline, buffering its symbols for the next
        process()/finish() return. Leaves _carry/_pending authoritative."""
        self._join_feeds()
        while self._inflight:
            self._backlog.append(self._drain_one())

    def finish(self) -> np.ndarray:
        """Drain the dispatch pipeline and any buffered full blocks (span
        mode can hold up to a whole span), then process the remaining
        sub-block tail with the exact oracle."""
        self.sync()
        chunks, self._backlog = self._backlog, []
        self._drain_blocks(chunks)
        self.sync()
        chunks.extend(self._backlog)
        self._backlog = []
        if len(self._pending):
            chunks.append(self._oracle(self._pending, self._carry))
            self._pending = np.zeros(0, dtype=np.complex64)
        with profiling.span("stream.collect"):
            out = (np.concatenate(chunks) if chunks
                   else np.zeros(0, dtype=_SYM_DTYPE))
        self.symbols_out += len(out)
        return out


def demod_array(cfg: DemodConfig, x: np.ndarray, device=None) -> np.ndarray:
    """One-shot demodulation of a full array (tests / offline use) on
    `device` (None: the card, as StreamDemodulator)."""
    d = StreamDemodulator(cfg, device)
    out = [d.process(x), d.finish()]
    return np.concatenate(out)


def quantize(x):
    """The .s byte math of one soft component (main.c:305-306): x/2, clamped
    to +-127, truncated toward zero. One rounding per operation, the same on
    a float32 torch tensor (any device) and a float32 numpy array; the
    caller casts to int8."""
    if isinstance(x, torch.Tensor):
        return torch.trunc(torch.clamp(x * 0.5, -127.0, 127.0))
    return np.trunc(np.clip(x * np.float32(0.5), -127.0, 127.0))


def quantize_symbols(symbols: np.ndarray) -> np.ndarray:
    """Soft symbols -> interleaved int8 bytes (quantize each component):
    the C++ quantizer of native/meteor_io.cc when it is built
    (io/native.py), numpy otherwise, the same bytes either way."""
    out = native.quantize_soft(symbols["re"], symbols["im"])
    if out is not None:
        return out
    out = np.empty(2 * len(symbols), dtype=np.int8)
    out[0::2] = quantize(symbols["re"]).astype(np.int8)
    out[1::2] = quantize(symbols["im"]).astype(np.int8)
    return out
