"""The per-symbol demod recurrence over one block, for a batch of streams.

Two implementations of one function, block(cfg, carry, Ft) -> (carry',
BlockOutput), with Ft the (T, 2, B) tick-major FIR output of the block
(dsp/fir.py polyphase_fir_block):

- block_demod_torch: the plain torch version, a Python loop over the
  cfg.steps_per_block steps, batched over the B streams. QPSK ports the JAX
  package's demod/scan.py _make_symbol_step / make_block_demod; OQPSK
  (block_demod_oqpsk_torch) ports _make_paired_step and make_block_demod's
  block-entry completion pre-fire. The fired tick is read directly as
  Ft[tau] (as demod/scalar.py reads it) instead of through candidate
  windows.
- block_demod: the wrapper of the CUDA kernels in csrc/block_demod.cu, the
  port of the Pallas kernels in meteor_demod_tpu/kernels/block_demod.py
  (QPSK body _make_step; OQPSK bodies _make_paired_step_tiles and
  _kernel_prefire, through block_demod_oqpsk). A CUDA Ft launches the
  kernel or raises; a CPU Ft runs the plain version, because a CPU tensor
  cannot reach a CUDA kernel.

Each fire evaluates the closed-form timing gate, reads the fired tick, runs
the AGC and the NCO mix through fast_sin; each symbol then runs the M&M
retime and the Costas/lock/sweep update. Rows of the outputs are gate
evaluations, not symbols: `valid` marks the rows that produced a symbol.
QPSK has (B, S) rows, one fire per step. OQPSK has (B, S+1) rows: row 0 is
the block-entry pre-fire (the Q fire of a symbol split across the block
boundary, carry slot == 2; zeros and valid 0 where no symbol was split),
then one row per paired step (the I half-fire, then the Q fire). Every
float operation is a single rounding (separate multiply, then add: no
addcmul, lerp or compile), in the numpy oracle's order, so the plain
version, the kernel and demod/scalar.py agree bitwise when fed the same Ft.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import constants as C
from ..demod.state import (BlockOutput, DemodCarry, FLAG_UNCONSUMED,
                           FLAG_WINDOW_MISS)
from ..dsp.loops import TANH_TABLE, lut_tanh
from ..dsp.sincos import HALF_PI, _INV_Q, _PHASE_SCALE, fast_cos, fast_sin
from . import _build

_F32 = np.float32
# Packed carry rows of the kernels (csrc/block_demod.cu enums).
_F_LEAVES = ("t_phase", "t_freq", "t_prev", "p_phase", "p_freq", "p_err",
             "updown", "agc_gain", "agc_bias_re", "agc_bias_im", "inphase")
_I_LEAVES = ("locked", "locked_once", "slot", "tick", "flags")


def _params(cfg) -> dict:
    """Float constants of the recurrence, each exactly a float32 value, in
    the order of the kernel's Params struct."""
    a_t, b_t = cfg.timing_gains
    a_p, b_p = cfg.pll_gains
    vals = dict(
        a_t=a_t, b_t=b_t, a_p=a_p, b_p=b_p,
        t_center=cfg.timing_freq, t_dev=cfg.timing_dev_max, fmax=cfg.pll_fmax,
        bias_keep=_F32(1.0 - C.AGC_BIAS_POLE), bias_pole=_F32(C.AGC_BIAS_POLE),
        gain_pole=_F32(C.AGC_GAIN_POLE), agc_target=_F32(C.AGC_TARGET),
        err_keep=_F32(1.0 - C.ERR_POLE), err_pole=_F32(C.ERR_POLE),
        sweep=_F32(C.SWEEP_STEP), lock_th=_F32(C.LOCK_THRESH),
        unlock_th=_F32(C.UNLOCK_THRESH), two_pi=_F32(2 * np.pi),
        half_pi=HALF_PI, phase_scale=_PHASE_SCALE, inv_q=_INV_Q)
    return {k: float(_F32(v)) for k, v in vals.items()}


def _check(cfg, carry: DemodCarry, Ft: torch.Tensor) -> int:
    if Ft.dtype != torch.float32 or Ft.dim() != 3 or Ft.shape[:2] != (
            cfg.block_ticks, 2):
        raise ValueError(f"Ft must be float32 ({cfg.block_ticks}, 2, B), "
                         f"got {Ft.dtype} {tuple(Ft.shape)}")
    B = Ft.shape[2]
    if carry.t_phase.shape != (B,):
        raise ValueError(f"carry leaves must be ({B},), got "
                         f"{tuple(carry.t_phase.shape)}")
    return B


def _where(mask: torch.Tensor, new: dict, old: dict) -> dict:
    return {k: torch.where(mask, v, old[k]) for k, v in new.items()}


class _Plain:
    """The plain recurrence's building blocks for one block of Ft, each in
    demod/scalar.py's operation order. `st` is a dict of (B,) carry leaves."""

    def __init__(self, cfg, Ft: torch.Tensor):
        self.p = _params(cfg)
        self.K = cfg.gate_candidates
        self.T = cfg.block_ticks
        dev = Ft.device
        self.ks = torch.arange(1, self.K + 1, dtype=torch.float32,
                               device=dev)[:, None]
        self.kiota = torch.arange(self.K, dtype=torch.int32, device=dev)[:, None]
        self.table = torch.as_tensor(TANH_TABLE, device=dev)
        self.lanes = torch.arange(Ft.shape[2], device=dev)
        self.f_re, self.f_im = Ft[:, 0, :], Ft[:, 1, :]

    def gate(self, tp, tf, thresh, t):
        """Closed-form timing gate (demod/scalar.py gate_fire_np): fires at
        k* = min{k <= min(K, rem) : fl(k*tf) >= fl(thresh - tp)}; a non-fire
        consumes min(rem, K) ticks. Returns (fired, k-1, the selected
        product fl(k*tf) the phase advances by, rem)."""
        diff = thresh - tp
        rem = self.T - t
        prod = self.ks * tf                                    # (K, B)
        ok = (prod >= diff) & (self.ks <= rem.to(torch.float32))
        k_min = torch.where(ok, self.kiota, self.K).amin(0)
        fired = k_min < self.K
        k_idx = torch.where(fired, k_min, torch.clamp(rem, max=self.K) - 1)
        # The phase advances by the SELECTED product: one add, no fresh mul.
        prod_sel = torch.where(
            k_idx >= 0,
            prod.gather(0, k_idx.clamp(min=0).long()[None])[0], 0.0)
        return fired, k_idx, prod_sel, rem

    def tick(self, fired, tau):
        """The fired tick's FIR output, read directly (0 when not fired)."""
        tau = tau.clamp(0, self.T - 1)
        return (torch.where(fired, self.f_re[tau, self.lanes], 0.0),
                torch.where(fired, self.f_im[tau, self.lanes], 0.0))

    def agc(self, z_re, z_im, st):
        """AGC (agc.c:12-25): the new bias and gain leaves, and the
        corrected sample (zr, zi)."""
        p = self.p
        bre = st["agc_bias_re"] * p["bias_keep"] + p["bias_pole"] * z_re
        bim = st["agc_bias_im"] * p["bias_keep"] + p["bias_pole"] * z_im
        zr = (z_re - bre) * st["agc_gain"]
        zi = (z_im - bim) * st["agc_gain"]
        # IEEE sqrt: torch's float32 CPU sqrt is not correctly rounded
        # (~0.6% of inputs off by 1 ulp); a float64 sqrt rounded to
        # float32 is, on every device.
        mag = torch.sqrt((zr * zr + zi * zi).double()).float()
        g = st["agc_gain"] + p["gain_pole"] * (p["agc_target"] - mag)
        return dict(agc_bias_re=bre, agc_bias_im=bim,
                    agc_gain=torch.where(g > 0.0, g, 0.0)), zr, zi

    def mix(self, zr, zi, pp):
        """PLL mix (pll.c:50-97): (zr + j zi) rotated by -pp."""
        sn = fast_sin(-pp)
        cs = fast_cos(-pp)
        return zr * cs - zi * sn, zr * sn + zi * cs

    def advance(self, pp, pf):
        """One NCO phase advance per fire, wrapped below 2*pi."""
        two_pi = self.p["two_pi"]
        pp = pp + pf
        return torch.where(pp >= two_pi, pp - two_pi, pp)

    def update(self, sym_re, sym_im, st, tp, pp):
        """The per-symbol loop update on the completed symbol: M&M retime
        (timing.c:59-95) from the gate-advanced timing phase tp, and the
        Costas/lock/sweep update (pll.c:99-130) from the fire-advanced NCO
        phase pp. Returns the updated leaves (written where a symbol was
        produced)."""
        p = self.p
        two_pi, fmax, t_dev = p["two_pi"], p["fmax"], p["t_dev"]
        prev = st["t_prev"]
        sgn_prev = torch.where(prev < 0.0, -1.0, 1.0)
        sgn_cur = torch.where(sym_im < 0.0, -1.0, 1.0)
        err_t = sgn_prev * sym_im - sgn_cur * prev
        tp_upd = tp - (two_pi + p["a_t"] * err_t)
        fd = (st["t_freq"] - p["t_center"]) - p["b_t"] * err_t
        fd = torch.where(fd < t_dev, fd, t_dev)
        fd = torch.where(fd > -t_dev, fd, -t_dev)
        tf_upd = p["t_center"] + fd

        e = (lut_tanh(sym_re, self.table) * sym_im
             - lut_tanh(sym_im, self.table) * sym_re)
        pp_upd = torch.fmod(pp + p["a_p"] * e, two_pi)
        pf = st["p_freq"] + p["b_p"] * e
        err = st["p_err"] * p["err_keep"] + torch.abs(e) * p["err_pole"]
        locked, updown = st["locked"], st["updown"]
        lock_now = (err < p["lock_th"]) & (locked == 0)
        unlock_now = (err > p["unlock_th"]) & (locked == 1)
        locked_upd = torch.where(lock_now, 1,
                                 torch.where(unlock_now, 0, locked))
        pf = torch.where(locked_upd == 0, pf + p["sweep"] * updown, pf)
        updown_upd = torch.where(pf >= fmax, -1.0,
                                 torch.where(pf <= -fmax, 1.0, updown))
        pf = torch.where(pf < fmax, pf, fmax)
        pf = torch.where(pf > -fmax, pf, -fmax)
        return dict(t_phase=tp_upd, t_freq=tf_upd, t_prev=sym_im,
                    p_phase=pp_upd, p_freq=pf, p_err=err, locked=locked_upd,
                    locked_once=torch.where(lock_now, 1, st["locked_once"]),
                    updown=updown_upd)


def _next_slot(slot: torch.Tensor) -> torch.Tensor:
    """The OQPSK timeslot after a fire: 1 -> 2, else 1 (demod.c:62-87)."""
    return torch.where(slot == 1, 2, 1).to(slot.dtype)


def _carry_leaves(carry: DemodCarry) -> dict:
    return {k: getattr(carry, k) for k in _F_LEAVES + _I_LEAVES
            if k != "tick"}


def _finish(cfg, carry: DemodCarry, st: dict, t: torch.Tensor, rows
            ) -> tuple[DemodCarry, BlockOutput]:
    """The carry after the block (tick reset to 0, FLAG_UNCONSUMED where the
    steps ran out before the block's ticks) and the (B, rows) outputs."""
    st["flags"] = st["flags"] | torch.where(
        t < cfg.block_ticks, FLAG_UNCONSUMED, 0).to(torch.int32)
    new = DemodCarry(tick=torch.zeros_like(t), fir_tail=carry.fir_tail, **st)
    out = BlockOutput(*(torch.stack(col, dim=1) for col in zip(*rows)))
    return new, out


def block_demod_torch(cfg, carry: DemodCarry, Ft: torch.Tensor
                      ) -> tuple[DemodCarry, BlockOutput]:
    """Plain torch recurrence over one block (see the module docstring).

    carry leaves are (B,) tensors on Ft's device; carry.fir_tail passes
    through unchanged (the FIR owns it). Returns the carry after the block
    (tick reset to 0, FLAG_UNCONSUMED set where the steps ran out before the
    block's ticks) and the outputs: (B, S) for QPSK, (B, S+1) for OQPSK
    (block_demod_oqpsk_torch)."""
    if cfg.oqpsk:
        return block_demod_oqpsk_torch(cfg, carry, Ft)
    _check(cfg, carry, Ft)
    c = _Plain(cfg, Ft)
    st = _carry_leaves(carry)
    t = torch.zeros_like(carry.tick)
    rows = []
    for _ in range(cfg.steps_per_block):
        fired, k_idx, prod_sel, _ = c.gate(st["t_phase"], st["t_freq"],
                                           c.p["two_pi"], t)
        tau = t + k_idx
        tp = st["t_phase"] + prod_sel
        t = t + k_idx + 1
        z_re, z_im = c.tick(fired, tau)
        agc, zr, zi = c.agc(z_re, z_im, st)
        mre, mim = c.mix(zr, zi, st["p_phase"])
        upd = c.update(mre, mim, st, tp, c.advance(st["p_phase"],
                                                   st["p_freq"]))
        st = {**st, **_where(fired, {**upd, **agc}, st),
              "t_phase": torch.where(fired, upd["t_phase"], tp)}
        rows.append((mre, mim, fired.to(torch.int32), st["locked_once"]))
    return _finish(cfg, carry, st, t, rows)


def block_demod_oqpsk_torch(cfg, carry: DemodCarry, Ft: torch.Tensor
                            ) -> tuple[DemodCarry, BlockOutput]:
    """Plain torch OQPSK recurrence over one block: the block-entry
    completion pre-fire (output row 0), then cfg.steps_per_block paired
    steps (rows 1..S), each the I half-fire (transaction A, threshold
    slot*pi) and then the Q fire (transaction B), with one loop update per
    completed symbol. Same contract as block_demod_torch; the block may
    change the carry's inphase and slot.

    Row rules of the JAX scan (demod/scan.py _make_paired_step), kept so the
    rows line up with it and with the Pallas kernel: when A does not fire, B
    is not attempted (it consumes no tick); B defers (FLAG_WINDOW_MISS) when
    it does not fire with more than K ticks left; the pre-fire runs only
    where the entry slot is 2, and a pre-fire that does not fire within K
    ticks flags FLAG_WINDOW_MISS. A flagged block breaks the pairing's
    alignment, so StreamDemodulator recomputes it with the numpy oracle.
    The pre-fire row is zeros where it did not run (as the Pallas kernel
    writes it; the JAX scan leaves its values unmasked)."""
    if not cfg.oqpsk:
        raise ValueError("block_demod_oqpsk_torch needs an OQPSK config")
    _check(cfg, carry, Ft)
    c = _Plain(cfg, Ft)
    pi = float(_F32(np.pi))
    st = _carry_leaves(carry)

    # ---- block-entry completion pre-fire: the Q fire of a split symbol ----
    pend = st["slot"] == 2
    fired, k_idx, prod_sel, _ = c.gate(st["t_phase"], st["t_freq"],
                                       c.p["two_pi"],
                                       torch.zeros_like(carry.tick))
    fire = fired & pend
    tp = st["t_phase"] + prod_sel
    t = torch.where(pend, k_idx + 1, 0)
    z_re, z_im = c.tick(fire, k_idx)
    agc, zr, zi = c.agc(z_re, z_im, st)
    _, mim = c.mix(zr, zi, st["p_phase"])
    upd = c.update(st["inphase"], mim, st, tp,
                   c.advance(st["p_phase"], st["p_freq"]))
    row0 = (torch.where(pend, st["inphase"], 0.0),
            torch.where(pend, mim, 0.0), fire.to(torch.int32))
    st = {**st, **_where(fire, {**upd, **agc,
                                "slot": torch.ones_like(st["slot"])}, st),
          "t_phase": torch.where(fire, upd["t_phase"],
                                 torch.where(pend, tp, st["t_phase"])),
          "flags": st["flags"] | torch.where(
              pend & ~fired, FLAG_WINDOW_MISS, 0).to(torch.int32)}
    rows = [row0 + (st["locked_once"],)]

    for _ in range(cfg.steps_per_block):
        slot = st["slot"]
        # ---- transaction A: the I half-fire --------------------------------
        firedA, kA, prodA, _ = c.gate(st["t_phase"], st["t_freq"],
                                      slot.to(torch.float32) * pi, t)
        tp1 = st["t_phase"] + prodA
        t1 = t + kA + 1
        zA_re, zA_im = c.tick(firedA, t + kA)
        agcA, zrA, ziA = c.agc(zA_re, zA_im, st)
        mreA, _ = c.mix(zrA, ziA, st["p_phase"])
        st1 = {**st, **_where(firedA, agcA, st)}           # gain1, bre1, bim1
        pp1 = torch.where(firedA, c.advance(st["p_phase"], st["p_freq"]),
                          st["p_phase"])
        is1A = slot == 1
        inphase1 = torch.where(firedA & is1A, mreA, st["inphase"])
        slotB = torch.where(firedA, _next_slot(slot), slot)

        # ---- transaction B: the Q fire, attempted only after A fired -------
        firedB, kB, prodB, remB = c.gate(tp1, st["t_freq"],
                                         slotB.to(torch.float32) * pi, t1)
        deferB = firedA & ~firedB & (remB > c.K)
        firedB = firedB & firedA
        kB = torch.where(firedA, kB, -1)
        tp2 = tp1 + torch.where(firedA, prodB, 0.0)
        t = t1 + kB + 1
        zB_re, zB_im = c.tick(firedB, t1 + kB)
        agcB, zrB, ziB = c.agc(zB_re, zB_im, st1)
        _, mimB = c.mix(zrB, ziB, pp1)
        st2 = _where(firedB, agcB, st1)                    # gain2, bre2, bim2
        pp2 = torch.where(firedB, c.advance(pp1, st["p_freq"]), pp1)
        slot_f = torch.where(firedB, _next_slot(slotB), slotB)

        # ---- the symbol and ONE loop update (Q fires of slot 2 only) -------
        do_update = firedB & (slotB == 2)
        upd = c.update(inphase1, mimB, st, tp2, pp2)
        st = {**st, **st2, **_where(do_update, upd, st),
              "t_phase": torch.where(do_update, upd["t_phase"], tp2),
              "p_phase": torch.where(do_update, upd["p_phase"], pp2),
              "inphase": inphase1, "slot": slot_f,
              "flags": st["flags"] | torch.where(
                  deferB, FLAG_WINDOW_MISS, 0).to(torch.int32)}
        rows.append((inphase1, mimB, do_update.to(torch.int32),
                     st["locked_once"]))
    return _finish(cfg, carry, st, t, rows)


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build (first use), load and bind csrc/block_demod.cu."""
    lib = _build.load("block_demod")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.block_demod_launch, lib.block_demod_oqpsk_launch):
        fn.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _packed_params(cfg) -> np.ndarray:
    """The kernel's Params struct as a host float32 array (read-only): the
    recurrence's constants, the tanh table, and fl(1 / t_center), by which
    the kernel's O(1) gate estimates the fired candidate."""
    params = np.array(list(_params(cfg).values()) + list(TANH_TABLE)
                      + [_F32(1.0) / cfg.timing_freq], dtype=np.float32)
    params.flags.writeable = False
    return params


def _launch(name: str, cfg, carry: DemodCarry, Ft: torch.Tensor, rows: int
            ) -> tuple[DemodCarry, BlockOutput]:
    """Check the inputs, launch the extern "C" launcher `name` of
    csrc/block_demod.cu on Ft's card and current stream (no
    synchronisation), and unpack its (rows, B) outputs and packed carry."""
    if Ft.device.type != "cuda":
        raise ValueError(f"no block_demod kernel for device {Ft.device}")
    B = _check(cfg, carry, Ft)
    if not Ft.is_contiguous():
        raise ValueError("Ft must be contiguous")
    for k in _F_LEAVES + _I_LEAVES:
        leaf = getattr(carry, k)
        want = torch.float32 if k in _F_LEAVES else torch.int32
        if leaf.device != Ft.device or leaf.dtype != want or leaf.shape != (B,):
            raise ValueError(f"carry.{k}: want {want} ({B},) on {Ft.device}, "
                             f"got {leaf.dtype} {tuple(leaf.shape)} on "
                             f"{leaf.device}")
    launcher = getattr(load_kernel(), name)
    params = _packed_params(cfg)
    fs_in = torch.stack([getattr(carry, k) for k in _F_LEAVES])
    is_in = torch.stack([getattr(carry, k) for k in _I_LEAVES])
    fs_out = torch.empty_like(fs_in)
    is_out = torch.empty_like(is_in)
    sym_re = torch.empty((rows, B), dtype=torch.float32, device=Ft.device)
    sym_im = torch.empty_like(sym_re)
    valid = torch.empty((rows, B), dtype=torch.int32, device=Ft.device)
    lonce = torch.empty_like(valid)
    # The launch goes to Ft's card: its current stream, with that card made
    # the current device only for the call.
    with torch.cuda.device(Ft.device):
        err = launcher(
            Ft.data_ptr(), fs_in.data_ptr(), is_in.data_ptr(),
            fs_out.data_ptr(), is_out.data_ptr(), sym_re.data_ptr(),
            sym_im.data_ptr(), valid.data_ptr(), lonce.data_ptr(),
            params.ctypes.data_as(ctypes.c_void_p), len(params), B,
            cfg.steps_per_block, cfg.block_ticks, cfg.gate_candidates,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")
    leaves = {k: fs_out[i] for i, k in enumerate(_F_LEAVES)}
    leaves.update({k: is_out[i] for i, k in enumerate(_I_LEAVES)})
    new = DemodCarry(fir_tail=carry.fir_tail, **leaves)
    return new, BlockOutput(sym_re.t(), sym_im.t(), valid.t(), lonce.t())


def block_demod(cfg, carry: DemodCarry, Ft: torch.Tensor
                ) -> tuple[DemodCarry, BlockOutput]:
    """The CUDA kernels' wrapper: same contract as block_demod_torch.

    An OQPSK config goes to block_demod_oqpsk. For QPSK, a CUDA Ft launches
    csrc/block_demod.cu's QPSK kernel on the current stream (no
    synchronisation) and adds one to block_demod.launches; a CPU Ft runs
    block_demod_torch. Any other device, dtype, shape or a failed launch
    raises."""
    if cfg.oqpsk:
        return block_demod_oqpsk(cfg, carry, Ft)
    if Ft.device.type == "cpu":
        return block_demod_torch(cfg, carry, Ft)
    out = _launch("block_demod_launch", cfg, carry, Ft, cfg.steps_per_block)
    block_demod.launches += 1
    return out


def block_demod_oqpsk(cfg, carry: DemodCarry, Ft: torch.Tensor
                      ) -> tuple[DemodCarry, BlockOutput]:
    """The OQPSK kernel's wrapper: same contract as block_demod_oqpsk_torch.

    A CUDA Ft launches csrc/block_demod.cu's OQPSK kernel (pre-fire and
    paired steps, (B, S+1) outputs) and adds one to
    block_demod_oqpsk.launches, a count of its own; a CPU Ft runs
    block_demod_oqpsk_torch. Any other device, dtype, shape or a failed
    launch raises."""
    if not cfg.oqpsk:
        raise ValueError("block_demod_oqpsk needs an OQPSK config")
    if Ft.device.type == "cpu":
        return block_demod_oqpsk_torch(cfg, carry, Ft)
    out = _launch("block_demod_oqpsk_launch", cfg, carry, Ft,
                  cfg.steps_per_block + 1)
    block_demod_oqpsk.launches += 1
    return out


block_demod.launches = 0
block_demod_oqpsk.launches = 0
