"""The per-symbol QPSK demod recurrence over one block, for a batch of streams.

Two implementations of one function, block(cfg, carry, Ft) -> (carry',
BlockOutput), with Ft the (T, 2, B) tick-major FIR output of the block
(dsp/fir.py polyphase_fir_block):

- block_demod_torch: the plain torch version, a Python loop over the
  cfg.steps_per_block steps, batched over the B streams. It is the port of
  the JAX package's demod/scan.py _make_symbol_step / make_block_demod with
  the fired tick read directly as Ft[tau] (as demod/scalar.py reads it)
  instead of through candidate windows.
- block_demod: the wrapper of the CUDA kernel csrc/block_demod.cu, the port
  of the Pallas kernels in meteor_demod_tpu/kernels/block_demod.py (QPSK body
  _make_step). A CUDA Ft launches the kernel or raises; a CPU Ft runs
  block_demod_torch, because a CPU tensor cannot reach a CUDA kernel.

Each step evaluates the closed-form timing gate, reads the fired tick, runs
the AGC, the NCO mix through fast_sin, the M&M retime and the Costas/lock/
sweep update. Rows of the (B, S) outputs are gate evaluations, not symbols:
`valid` marks the steps that fired. Every float operation is a single
rounding (separate multiply, then add: no addcmul, lerp or compile), in the
numpy oracle's order, so the plain version, the kernel and demod/scalar.py
agree bitwise when fed the same Ft.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import constants as C
from ..demod.state import BlockOutput, DemodCarry, FLAG_UNCONSUMED
from ..dsp.loops import TANH_TABLE, lut_tanh
from ..dsp.sincos import HALF_PI, _INV_Q, _PHASE_SCALE, fast_cos, fast_sin
from . import _build

_F32 = np.float32
# Packed carry rows of the kernel (csrc/block_demod.cu enums).
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


def _check_qpsk(cfg, carry: DemodCarry, Ft: torch.Tensor) -> int:
    if cfg.oqpsk:
        raise NotImplementedError("the OQPSK paired step is not ported yet")
    if Ft.dtype != torch.float32 or Ft.dim() != 3 or Ft.shape[:2] != (
            cfg.block_ticks, 2):
        raise ValueError(f"Ft must be float32 ({cfg.block_ticks}, 2, B), "
                         f"got {Ft.dtype} {tuple(Ft.shape)}")
    B = Ft.shape[2]
    if carry.t_phase.shape != (B,):
        raise ValueError(f"carry leaves must be ({B},), got "
                         f"{tuple(carry.t_phase.shape)}")
    return B


def block_demod_torch(cfg, carry: DemodCarry, Ft: torch.Tensor
                      ) -> tuple[DemodCarry, BlockOutput]:
    """Plain torch recurrence over one block (see the module docstring).

    carry leaves are (B,) tensors on Ft's device; carry.fir_tail passes
    through unchanged (the FIR owns it). Returns the carry after the block
    (tick reset to 0, FLAG_UNCONSUMED set where the steps ran out before the
    block's ticks) and the (B, S) outputs."""
    B = _check_qpsk(cfg, carry, Ft)
    dev = Ft.device
    p = _params(cfg)
    two_pi, t_center, t_dev, fmax = p["two_pi"], p["t_center"], p["t_dev"], p["fmax"]
    K = cfg.gate_candidates
    T = cfg.block_ticks
    ks = torch.arange(1, K + 1, dtype=torch.float32, device=dev)[:, None]
    kiota = torch.arange(K, dtype=torch.int32, device=dev)[:, None]
    table = torch.as_tensor(TANH_TABLE, device=dev)
    lanes = torch.arange(B, device=dev)
    f_re, f_im = Ft[:, 0, :], Ft[:, 1, :]

    tp, tf, prev = carry.t_phase, carry.t_freq, carry.t_prev
    pp, pf, perr = carry.p_phase, carry.p_freq, carry.p_err
    locked, lonce, updown = carry.locked, carry.locked_once, carry.updown
    gain, bre, bim = carry.agc_gain, carry.agc_bias_re, carry.agc_bias_im
    t = torch.zeros_like(carry.tick)
    rows = []
    for _ in range(cfg.steps_per_block):
        # ---- closed-form timing gate (demod/scalar.py gate_fire_np) -------
        diff = two_pi - tp
        rem = T - t
        prod = ks * tf                                         # (K, B)
        ok = (prod >= diff) & (ks <= rem.to(torch.float32))
        k_min = torch.where(ok, kiota, K).amin(0)
        fired = k_min < K
        k_idx = torch.where(fired, k_min, torch.clamp(rem, max=K) - 1)
        # The phase advances by the SELECTED product: one add, no fresh mul.
        prod_sel = torch.where(
            k_idx >= 0, prod.gather(0, k_idx.clamp(min=0).long()[None])[0], 0.0)
        tau = (t + k_idx).clamp(0, T - 1)
        tp = tp + prod_sel
        t = t + k_idx + 1

        # ---- the fired tick, read directly (0 when not fired) -------------
        z_re = torch.where(fired, f_re[tau, lanes], 0.0)
        z_im = torch.where(fired, f_im[tau, lanes], 0.0)

        # ---- AGC (agc.c:12-25) ---------------------------------------------
        bre_n = bre * p["bias_keep"] + p["bias_pole"] * z_re
        bim_n = bim * p["bias_keep"] + p["bias_pole"] * z_im
        zr = (z_re - bre_n) * gain
        zi = (z_im - bim_n) * gain
        # IEEE sqrt: torch's float32 CPU sqrt is not correctly rounded
        # (~0.6% of inputs off by 1 ulp); a float64 sqrt rounded to
        # float32 is, on every device.
        mag = torch.sqrt((zr * zr + zi * zi).double()).float()
        g = gain + p["gain_pole"] * (p["agc_target"] - mag)
        gain_n = torch.where(g > 0.0, g, 0.0)

        # ---- PLL mix (pll.c:50-97) -----------------------------------------
        sn = fast_sin(-pp)
        cs = fast_cos(-pp)
        mre = zr * cs - zi * sn
        mim = zr * sn + zi * cs
        pp_adv = pp + pf
        pp_adv = torch.where(pp_adv >= two_pi, pp_adv - two_pi, pp_adv)

        # ---- M&M retiming (timing.c:59-95) ---------------------------------
        sgn_prev = torch.where(prev < 0.0, -1.0, 1.0)
        sgn_cur = torch.where(mim < 0.0, -1.0, 1.0)
        err_t = sgn_prev * mim - sgn_cur * prev
        tp_upd = tp - (two_pi + p["a_t"] * err_t)
        fd = (tf - t_center) - p["b_t"] * err_t
        fd = torch.where(fd < t_dev, fd, t_dev)
        fd = torch.where(fd > -t_dev, fd, -t_dev)
        tf_upd = t_center + fd

        # ---- Costas update (pll.c:99-130) ----------------------------------
        e = lut_tanh(mre, table) * mim - lut_tanh(mim, table) * mre
        pp_upd = torch.fmod(pp_adv + p["a_p"] * e, two_pi)
        pf_upd = pf + p["b_p"] * e
        err_upd = perr * p["err_keep"] + torch.abs(e) * p["err_pole"]
        lock_now = (err_upd < p["lock_th"]) & (locked == 0)
        unlock_now = (err_upd > p["unlock_th"]) & (locked == 1)
        locked_upd = torch.where(lock_now, 1, torch.where(unlock_now, 0, locked))
        lonce_upd = torch.where(lock_now, 1, lonce)
        pf_upd = torch.where(locked_upd == 0, pf_upd + p["sweep"] * updown,
                             pf_upd)
        updown_upd = torch.where(pf_upd >= fmax, -1.0,
                                 torch.where(pf_upd <= -fmax, 1.0, updown))
        pf_upd = torch.where(pf_upd < fmax, pf_upd, fmax)
        pf_upd = torch.where(pf_upd > -fmax, pf_upd, -fmax)

        # ---- gated state writes --------------------------------------------
        tp = torch.where(fired, tp_upd, tp)
        tf = torch.where(fired, tf_upd, tf)
        prev = torch.where(fired, mim, prev)
        pp = torch.where(fired, pp_upd, pp)
        pf = torch.where(fired, pf_upd, pf)
        perr = torch.where(fired, err_upd, perr)
        locked = torch.where(fired, locked_upd, locked)
        lonce = torch.where(fired, lonce_upd, lonce)
        updown = torch.where(fired, updown_upd, updown)
        gain = torch.where(fired, gain_n, gain)
        bre = torch.where(fired, bre_n, bre)
        bim = torch.where(fired, bim_n, bim)
        rows.append((mre, mim, fired.to(torch.int32), lonce))

    flags = carry.flags | torch.where(t < T, FLAG_UNCONSUMED, 0).to(torch.int32)
    new = DemodCarry(
        t_phase=tp, t_freq=tf, t_prev=prev, p_phase=pp, p_freq=pf,
        p_err=perr, locked=locked, locked_once=lonce, updown=updown,
        agc_gain=gain, agc_bias_re=bre, agc_bias_im=bim,
        inphase=carry.inphase, slot=carry.slot, tick=torch.zeros_like(t),
        fir_tail=carry.fir_tail, flags=flags)
    out = BlockOutput(*(torch.stack(col, dim=1) for col in zip(*rows)))
    return new, out


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build (first use), load and bind csrc/block_demod.cu."""
    lib = _build.load("block_demod")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.block_demod_launch.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
    lib.block_demod_launch.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _packed_params(cfg) -> np.ndarray:
    """The kernel's Params struct as a host float32 array (read-only)."""
    params = np.array(list(_params(cfg).values()) + list(TANH_TABLE),
                      dtype=np.float32)
    params.flags.writeable = False
    return params


def block_demod(cfg, carry: DemodCarry, Ft: torch.Tensor
                ) -> tuple[DemodCarry, BlockOutput]:
    """The CUDA kernel's wrapper: same contract as block_demod_torch.

    A CUDA Ft launches csrc/block_demod.cu on the current stream (no
    synchronisation) and adds one to block_demod.launches; a CPU Ft runs
    block_demod_torch. Any other device, dtype, shape or a failed launch
    raises."""
    if Ft.device.type == "cpu":
        return block_demod_torch(cfg, carry, Ft)
    if Ft.device.type != "cuda":
        raise ValueError(f"no block_demod kernel for device {Ft.device}")
    B = _check_qpsk(cfg, carry, Ft)
    if not Ft.is_contiguous():
        raise ValueError("Ft must be contiguous")
    for k in _F_LEAVES + _I_LEAVES:
        leaf = getattr(carry, k)
        want = torch.float32 if k in _F_LEAVES else torch.int32
        if leaf.device != Ft.device or leaf.dtype != want or leaf.shape != (B,):
            raise ValueError(f"carry.{k}: want {want} ({B},) on {Ft.device}, "
                             f"got {leaf.dtype} {tuple(leaf.shape)} on "
                             f"{leaf.device}")
    lib = load_kernel()
    params = _packed_params(cfg)
    S = cfg.steps_per_block
    fs_in = torch.stack([getattr(carry, k) for k in _F_LEAVES])
    is_in = torch.stack([getattr(carry, k) for k in _I_LEAVES])
    fs_out = torch.empty_like(fs_in)
    is_out = torch.empty_like(is_in)
    sym_re = torch.empty((S, B), dtype=torch.float32, device=Ft.device)
    sym_im = torch.empty_like(sym_re)
    valid = torch.empty((S, B), dtype=torch.int32, device=Ft.device)
    lonce = torch.empty_like(valid)
    # The launch goes to Ft's card: its current stream, with that card made
    # the current device only for the call.
    with torch.cuda.device(Ft.device):
        err = lib.block_demod_launch(
            Ft.data_ptr(), fs_in.data_ptr(), is_in.data_ptr(),
            fs_out.data_ptr(), is_out.data_ptr(), sym_re.data_ptr(),
            sym_im.data_ptr(), valid.data_ptr(), lonce.data_ptr(),
            params.ctypes.data_as(ctypes.c_void_p), len(params), B, S,
            cfg.block_ticks, cfg.gate_candidates,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_demod launch failed: cudaError {err}")
    block_demod.launches += 1
    leaves = {k: fs_out[i] for i, k in enumerate(_F_LEAVES)}
    leaves.update({k: is_out[i] for i, k in enumerate(_I_LEAVES)})
    new = DemodCarry(fir_tail=carry.fir_tail, **leaves)
    return new, BlockOutput(sym_re.t(), sym_im.t(), valid.t(), lonce.t())


block_demod.launches = 0
