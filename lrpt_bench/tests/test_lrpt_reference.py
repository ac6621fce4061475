"""The reference against the program's plain path at a small size, and the
generators' seam."""

import numpy as np
import pytest
import torch

from lrpt_bench.gen import signal
from lrpt_bench.reference import check_fleet, fir, oracle, params
from lrpt_bench.reference.quantize import quantize

from small import small_run

CELLS = ("qpsk72k.fleet128", "oqpsk80k.fleet128")


def _plain_fleet(cell, seed):
    """Two blocks of a small fleet loop through FleetDemodulator on the CPU
    (the plain torch recurrence) from the initial state."""
    from meteor_demod_tpu_torch.config import DemodConfig
    from meteor_demod_tpu_torch.parallel.mesh import FleetDemodulator
    run = small_run(cell, seed)
    x, _ = signal.fleet_loop(run.cfg, run.mix, seed, torch.device("cpu"))
    x = x.numpy()[:, :2 * run.cfg["block_len"]]
    fleet = FleetDemodulator(DemodConfig(**run.demod_fields()), len(x),
                             device="cpu", chain_blocks=2, ingest="i16",
                             packed_output=True)
    outs = fleet.process_blocks(x)
    rows = {k: np.asarray(getattr(outs, k)) for k in
            ("sym_i", "sym_q", "valid", "locked_once")}
    return run, x, rows


@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_the_programs_plain_fleet_path(cell):
    """The reference, with its own float64 filter, from the initial state
    over the same int16 blocks: every soft byte, lock flag and symbol count
    of the two blocks agrees but for a rounding's byte or two."""
    run, x, rows = _plain_fleet(cell, 11)
    cst, bank = params.derive(run.cfg), fir.banks(run.cfg)
    (ref, locked, _), = check_fleet.replay(
        cst, bank, [dict(x=x, tail=np.zeros((len(x), 64, 2), np.int16),
                         state=oracle.initial_state(len(x), cst))],
        2, torch.device("cpu"))
    every = np.ones(len(x), bool)
    d = check_fleet.compare([rows], ref, locked, 2, every, ~every)
    assert d["symbols"] > 0 and d["bytes"] <= 2


@pytest.mark.parametrize("cell", CELLS)
def test_recurrence_is_the_programs_bit_for_bit(cell):
    """Given the program's own filter output, both forms of the reference's
    recurrence give the program's soft symbols and lock flags exactly."""
    from meteor_demod_tpu_torch.dsp.fir import (make_fir_banks,
                                                polyphase_fir_block)
    from meteor_demod_tpu_torch.config import DemodConfig
    run, x, rows = _plain_fleet(cell, 12)
    cst = params.derive(run.cfg)
    banks = torch.as_tensor(make_fir_banks(DemodConfig(
        **run.demod_fields())))
    L = run.cfg["block_len"]
    tail = torch.zeros((len(x), 64, 2))
    vec, one = oracle.initial_state(len(x), cst), oracle.initial_state(1, cst)
    got_v, got_1 = [], []
    for b in range(2):
        xb = torch.as_tensor(x[:, b * L:(b + 1) * L]).float()
        Ft, tail = polyphase_fir_block(xb, tail, banks)
        Ft = Ft.numpy()                                   # (T, 2, lanes)
        ticks = (Ft[:, 0] + 1j * Ft[:, 1]).T.astype(np.complex64)
        got_v.append(oracle.run_block(cst, vec, ticks))
        got_1.append(oracle.run_block_one(cst, one, ticks[:1]))
    for lane in range(len(x)):
        v = rows["valid"][lane] != 0
        want = (rows["sym_i"][lane][v], rows["sym_q"][lane][v],
                rows["locked_once"][lane][v])
        for got in (got_v, got_1) if lane == 0 else (got_v,):
            i = 0 if got is got_1 else lane
            re = np.concatenate([g[0][i, :g[3][i]] for g in got])
            im = np.concatenate([g[1][i, :g[3][i]] for g in got])
            lo = np.concatenate([g[2][i, :g[3][i]] for g in got])
            assert np.array_equal(quantize(re), want[0])
            assert np.array_equal(quantize(im), want[1])
            assert np.array_equal(lo != 0, want[2] != 0)
    for k in vec:
        assert np.array_equal(vec[k][:1], one[k])


@pytest.mark.parametrize("cell", CELLS)
def test_a_loops_last_block_then_its_first_gives_no_flag(cell):
    """The fleet's loop is periodic in symbols, carrier and pulse tails:
    its last block followed by its first runs through the program with no
    flag and the nominal symbol count, and the samples across the seam
    step no more than samples inside the loop do."""
    from meteor_demod_tpu_torch.config import DemodConfig
    from meteor_demod_tpu_torch.parallel.mesh import FleetDemodulator
    run = small_run(cell, 12)
    run.mix.update(dead_streams=0)
    x, _ = signal.fleet_loop(run.cfg, run.mix, 12, torch.device("cpu"))
    x = x.numpy().astype(np.int16)
    L = run.cfg["block_len"]
    seam = np.concatenate([x[:, -L:], x[:, :L]], axis=1)
    fleet = FleetDemodulator(DemodConfig(**run.demod_fields()), len(x),
                             device="cpu", chain_blocks=2, ingest="i16")
    outs = fleet.process_blocks(seam)
    assert not len(fleet.flagged_streams())
    per_block = L * run.cfg["symrate"] / run.cfg["samplerate"]
    counts = np.asarray(outs.valid).sum(1)
    assert np.all(np.abs(counts - 2 * per_block) <= 3), counts
    step = np.abs(np.diff(x.astype(np.float64), axis=1)).max((1, 2))
    jump = np.abs(x[:, 0].astype(np.float64) - x[:, -1]).max(1)
    assert np.all(jump <= step)


def test_pass_piece_is_that_part_of_the_whole():
    """A piece of the pass made alone equals the same samples of the whole
    recording, so the reference reads the samples the program read."""
    run = small_run("qpsk72k.pass10min", 13)
    cpu = torch.device("cpu")
    whole, _ = signal.pass_samples(run.cfg, run.mix, 13, cpu)
    piece, _ = signal.pass_samples(run.cfg, run.mix, 13, cpu, start=5000,
                                   n_samples=3000)
    assert torch.equal(whole[5000:8000], piece)


def test_the_same_seed_gives_the_same_inputs():
    run = small_run("oqpsk80k.fleet128", 2 ** 33 + 7)
    cpu = torch.device("cpu")
    a, pa = signal.fleet_loop(run.cfg, run.mix, run.seed, cpu)
    b, pb = signal.fleet_loop(run.cfg, run.mix, run.seed, cpu)
    c, _ = signal.fleet_loop(run.cfg, run.mix, run.seed + 1, cpu)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert np.array_equal(pa["carrier_hz"], pb["carrier_hz"])
