"""Helpers (not a test module) for the port's end-to-end checks against the
numpy oracles: tests/test_torch_adversarial.py, test_torch_doppler.py,
test_torch_doppler_oqpsk.py, test_torch_negative_carrier.py and
test_torch_dead_zone.py.

Contracts (ROADMAP.md): fed the same FIR output, the port's recurrence is
bitwise to the numpy oracles. So the port's stream driver and fleet are
bitwise to the port's oracle (meteor_demod_tpu_torch/demod/scalar.py) run
block by block on the port's FIR output (dsp/fir.py polyphase_fir_block),
with no block replayed by the oracle on the host, and on that input the
JAX package's oracle (meteor_demod_tpu/demod/scalar.py) is bitwise the
port's. Against the JAX oracle on its own numpy FIR, which sums in another
order, the symbol count, the lock history and the sign of every locked
symbol must be equal: an unlocked loop (a carrier sweep) can turn an ulp of
FIR difference into other signs before the lock (ROADMAP list C). The JAX
scan is not a bitwise reference (XLA on the CPU contracts multiply-adds).
"""

import dataclasses

import numpy as np
import torch

from meteor_demod_tpu.config import DemodConfig as JaxConfig
from meteor_demod_tpu.demod import scalar as jax_scalar

from meteor_demod_tpu_torch.demod import scalar
from meteor_demod_tpu_torch.demod.pipeline import (StreamDemodulator,
                                                   scalar_state_to_numpy_carry)
from meteor_demod_tpu_torch.demod.state import CARRY_FIELDS, carry_to_numpy
from meteor_demod_tpu_torch.dsp.fir import (f32_to_iq, iq_to_f32,
                                            make_fir_banks,
                                            polyphase_fir_block)
from meteor_demod_tpu_torch.io.wav import decode_iq
from meteor_demod_tpu_torch.parallel.mesh import FleetDemodulator
from meteor_demod_tpu_torch.sim import encode_iq

SYM_KEYS = ("re", "im", "locked_once")


def as_int16(x: np.ndarray) -> np.ndarray:
    """The samples a 16-bit WAV of x holds (the golden tests' fixtures go
    through one)."""
    return decode_iq(encode_iq(x, 16), 16)


def jax_cfg(cfg):
    """The JAX package's DemodConfig with the port config's fields."""
    return JaxConfig(**dataclasses.asdict(cfg))


@dataclasses.dataclass
class Oracle:
    """One input through an oracle, block by block from the initial state:
    each block's symbols and the state after it."""
    parts: list
    states: list

    def upto(self, n_blocks: int):
        """(symbols, state) after the first n_blocks blocks."""
        return np.concatenate(self.parts[:n_blocks]), self.states[n_blocks - 1]

    def all(self):
        return self.upto(len(self.parts))


def port_fir(cfg, x: np.ndarray) -> list:
    """The port's FIR output of each whole block_len piece of x, as the
    stream driver computes it ((L, interp) complex64), None for a short
    last piece (the stream driver's end-of-input oracle takes the numpy
    FIR)."""
    L = cfg.block_len
    banks = torch.as_tensor(make_fir_banks(cfg))
    tail = torch.zeros((1, cfg.taps - 1, 2))
    out = []
    for at in range(0, len(x), L):
        xb = x[at:at + L]
        if len(xb) < L:
            out.append(None)
            continue
        Ft, tail = polyphase_fir_block(torch.from_numpy(iq_to_f32(xb))[None],
                                       tail, banks)
        out.append(f32_to_iq(Ft[:, :, 0].numpy()).reshape(L, cfg.interp))
    return out


def oracle(mod, cfg, x: np.ndarray, fir: list | None = None) -> Oracle:
    """x through mod.demod_stream_np one block_len piece at a time (the
    stream driver's block boundaries; the last piece may be short), fed the
    FIR output `fir` (port_fir's list) or, with None, its own numpy FIR."""
    L = cfg.block_len
    st = mod.initial_state(cfg)
    parts, states = [], []
    for i, at in enumerate(range(0, len(x), L)):
        s, st = mod.demod_stream_np(cfg, x[at:at + L], st,
                                    F=None if fir is None else fir[i])
        parts.append(s)
        states.append(st)
    return Oracle(parts, states)


def both_oracles(cfg, x: np.ndarray, same_input_blocks: int | None = None
                 ) -> tuple[Oracle, Oracle]:
    """(the port's oracle on the port's FIR output, the JAX package's oracle
    on its own FIR). Fed the port's FIR output too, the JAX oracle must be
    bitwise the port's, block by block (over the first same_input_blocks
    blocks when given, to save time on a long fixture)."""
    fir = port_fir(cfg, x)
    mine = oracle(scalar, cfg, x, fir)
    n = len(x) if same_input_blocks is None else \
        same_input_blocks * cfg.block_len
    same_input = oracle(jax_scalar, jax_cfg(cfg), x[:n], fir)
    for b, (p, q) in enumerate(zip(mine.parts, same_input.parts)):
        assert_bitwise(p, q, f"port oracle vs JAX oracle, block {b}")
    return mine, oracle(jax_scalar, jax_cfg(cfg), x)


def assert_bitwise(got: np.ndarray, want: np.ndarray, what: str) -> None:
    """Symbol arrays equal, as the repo's bitwise tests hold them
    (np.array_equal, same dtype: every value exact, the sign of a zero not
    compared. The numpy oracles multiply by the AGC gain as a complex
    number, so where the gain is 0 a zero component can come out signed
    otherwise than in the recurrence, ROADMAP list C). The first differing
    row is named."""
    assert len(got) == len(want), f"{what}: {len(got)} symbols, {len(want)}"
    for k in SYM_KEYS:
        assert got[k].dtype == want[k].dtype, (what, k)
        bad = np.nonzero(got[k] != want[k])[0]
        assert len(bad) == 0, (
            f"{what}: {k} differs in {len(bad)} symbols, first at {bad[0]}: "
            f"{got[k][bad[0]]!r} != {want[k][bad[0]]!r}")


def assert_decisions(got: np.ndarray, want: np.ndarray, what: str) -> int:
    """Symbol count, locked_once on every symbol and the sign of every
    component of every locked symbol (locked_once 1). Returns how many
    unlocked symbols differ in a sign."""
    assert len(got) == len(want), f"{what}: {len(got)} symbols, {len(want)}"
    np.testing.assert_array_equal(got["locked_once"], want["locked_once"],
                                  err_msg=f"{what}: locked_once")
    locked = got["locked_once"] == 1
    differ = np.zeros(len(got), bool)
    for k in ("re", "im"):
        differ |= np.sign(got[k]) != np.sign(want[k])
        bad = np.nonzero(locked & (np.sign(got[k]) != np.sign(want[k])))[0]
        assert len(bad) == 0, (f"{what}: sign of {k} differs in {len(bad)} "
                               f"locked symbols, first at {bad[:1]}")
    return int(np.count_nonzero(differ & ~locked))


def assert_carry(got: dict, cfg, st: dict, what: str) -> None:
    """One stream's numpy carry leaves equal to an oracle state, as
    assert_bitwise holds symbols."""
    want = scalar_state_to_numpy_carry(cfg, st)
    for k in CARRY_FIELDS:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), (
            f"{what}: carry {k} {got[k]!r} != {want[k]!r}")


def stream(cfg, x: np.ndarray) -> tuple[np.ndarray, dict]:
    """x through StreamDemodulator(cfg, "cpu") in one feed: its symbols and
    final carry leaves; no block may be replayed by the oracle."""
    before = StreamDemodulator.replayed_blocks
    d = StreamDemodulator(cfg, "cpu")
    got = np.concatenate([d.process(x), d.finish()])
    assert d.fallback_blocks == 0, f"{d.fallback_blocks} blocks replayed"
    assert StreamDemodulator.replayed_blocks == before
    return got, {k: v[0] for k, v in carry_to_numpy(d._carry).items()}


def check_stream(cfg, x: np.ndarray, mine: Oracle, theirs: Oracle
                 ) -> np.ndarray:
    """The stream driver on x: bitwise to the port's oracle (symbols and
    final carry), decisions equal to the JAX oracle's. Returns its symbols."""
    got, carry = stream(cfg, x)
    want, st = mine.all()
    assert_bitwise(got, want, "stream driver vs the port's oracle")
    assert_carry(carry, cfg, st, "stream driver")
    assert_decisions(got, theirs.all()[0], "stream driver vs the JAX oracle")
    return got


def check_fleet(cfg, rows: np.ndarray, oracles: list, fleet=None) -> list:
    """rows (n, T) complex64, T whole blocks, through a FleetDemodulator
    (`fleet`, else a new FleetDemodulator(cfg, n, "cpu")) block by block:
    each stream bitwise to its port oracle (over its first T samples) in
    symbols and carry, decisions equal to its JAX oracle's; no flag, no
    recovery. `oracles` holds (port, JAX) Oracle pairs, one a row, starting
    where the fleet's carry does. Returns each stream's symbols."""
    n, T = rows.shape
    L = cfg.block_len
    assert T % L == 0
    if fleet is None:
        fleet = FleetDemodulator(cfg, n, device="cpu")
    per_row = [[] for _ in range(n)]
    for b in range(T // L):
        outs = fleet.process_blocks(rows[:, b * L:(b + 1) * L])
        assert not fleet.stream_flags.any(), f"block {b}: flags"
        for i in range(n):
            m = outs.valid[i].astype(bool)
            s = np.zeros(int(m.sum()), dtype=[("re", np.float32),
                                              ("im", np.float32),
                                              ("locked_once", np.int32)])
            s["re"], s["im"] = outs.sym_re[i][m], outs.sym_im[i][m]
            s["locked_once"] = outs.locked_once[i][m]
            per_row[i].append(s)
    assert fleet.recovered_streams == 0
    leaves = carry_to_numpy(fleet.carry)
    got = [np.concatenate(p) for p in per_row]
    for i, (mine, theirs) in enumerate(oracles):
        want, st = mine.upto(T // L)
        assert_bitwise(got[i], want, f"fleet row {i} vs the port's oracle")
        assert_carry({k: v[i] for k, v in leaves.items()}, cfg, st,
                     f"fleet row {i}")
        assert_decisions(got[i], theirs.upto(T // L)[0],
                         f"fleet row {i} vs the JAX oracle")
    return got
