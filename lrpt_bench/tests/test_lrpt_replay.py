"""The pass check's replay of kept blocks (drivers/cli_pass.py): the
blocks kept are a uniform sample of a pass's block calls, each what the
program's step saw and gave at the time, and each placed in the recording
by its first samples."""

import types

import numpy as np
import pytest
import torch

from lrpt_bench.drivers import cli_pass
from lrpt_bench.reference import oracle

LEAVES = oracle.FLOAT_LEAVES + oracle.INT_LEAVES


def _carry(batch: int, base: float) -> types.SimpleNamespace:
    c = {n: torch.arange(batch, dtype=torch.float32) + base
         for n in oracle.FLOAT_LEAVES}
    c.update({n: torch.arange(batch, dtype=torch.int32) + int(base)
              for n in oracle.INT_LEAVES})
    c["fir_tail"] = torch.full((batch, 4, 2), base)
    c["flags"] = torch.zeros(batch, dtype=torch.int32)
    return types.SimpleNamespace(**c)


def _step(batch: int):
    """A stand-in block step: the state moves on by one; the output is the
    input's first samples; the step scribbles over its input afterwards,
    as a buffer reused by the next upload would."""
    def demod(carry, x):
        nxt = _carry(batch, float(carry.p_phase[0]) + 1)
        outs = types.SimpleNamespace(
            sym_re=x[:, :6, 0].clone(), sym_im=x[:, :6, 1].clone(),
            valid=torch.ones(batch, 6, dtype=torch.int32),
            locked_once=torch.ones(batch, 6, dtype=torch.int32))
        x.zero_()
        return nxt, outs
    return lambda cfg, b, *a, **k: demod


@pytest.mark.parametrize("n", (4, 16))
def test_the_kept_calls_are_a_uniform_sample(n):
    calls, reps, bins = 800, 400, 8
    hist = np.zeros(bins)
    for rep in range(reps):
        k = cli_pass._Kept(n, rep)
        at = [None] * n
        for c in range(calls):
            s = k._slot()
            if s is not None:
                at[s] = c
        assert None not in at and len(set(at)) == n
        hist += np.bincount(np.array(at) * bins // calls, minlength=bins)
    expect = reps * n / bins
    assert np.all(np.abs(hist - expect) < 5 * np.sqrt(expect))


def test_fewer_calls_than_n_keeps_them_all():
    k = cli_pass._Kept(64, 1)
    assert [k._slot() for _ in range(10)] == list(range(10))


def test_a_reset_draws_the_same_sample():
    k = cli_pass._Kept(8, 3)
    first = [k._slot() for _ in range(500)]
    k.reset()
    assert [k._slot() for _ in range(500)] == first


def test_kept_blocks_are_what_the_step_saw_and_gave():
    batch, L = 3, 32
    kept = cli_pass._Kept(5, 7)
    demod = kept.make(_step(batch))(None, batch)
    carry = _carry(batch, 0.0)
    xs = []
    for i in range(40):
        x = torch.arange(batch * L * 2, dtype=torch.float32).reshape(
            batch, L, 2) + 1000 * i
        xs.append(x.clone())
        carry, _ = demod(carry, x)
    st = dict(kept=kept)
    cli_pass.release(st)
    assert len(st["kept_np"]) == 5
    for b in st["kept_np"]:
        step = int(b["tail"][0, 0, 0])            # the call's carry base
        lane = int(b["before"]["t_phase"][0]) - step
        assert 0 <= lane < batch
        for n in LEAVES:
            assert b["before"][n].shape == (1,)
            assert b["before"][n][0] == step + lane
        np.testing.assert_array_equal(b["x"], xs[step][lane][None].numpy())
        assert b["tail"].shape == (1, 4, 2)
        np.testing.assert_array_equal(b["outs"]["sym_re"],
                                      xs[step][lane][None, :6, 0].numpy())
        assert b["outs"]["valid"].shape == (1, 6) and b["flags"] == 0


def test_blocks_are_placed_by_their_first_samples():
    rng = np.random.default_rng(9)
    host = rng.integers(-3000, 3000, (50_000, 2)).astype(np.int16)
    heads = [host[at:at + 16].astype(np.float32) for at in (0, 17, 40_000)]
    heads.append(np.zeros((16, 2), np.float32) + 0.5)     # not integers
    heads.append(rng.integers(-3000, 3000, (16, 2)).astype(np.float32))
    assert cli_pass._place(host, heads) == [0, 17, 40_000, None, None]
