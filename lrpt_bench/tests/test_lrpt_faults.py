"""Whole runs on the CPU with the timed path broken underneath: `correct`
must come out false for each fault a cell can have. One cell has no
exchange between chips and no batch mean, so the faults are a block step
that hands back its state unchanged and a soft symbol altered where it is
produced. The sound run of each cell is the same run with nothing broken,
and a run with the matched filter summed in another float32 order is
sound too. Every cell of BENCHMARK.json of the fleet and cli_pass kinds
is run."""

import dataclasses
import json

import pytest

from lrpt_bench import run as R
from small import execute, small_run

BENCH = json.loads((R.ROOT / "BENCHMARK.json").read_text())


def _cells(kind: str) -> tuple:
    return tuple(w["name"] for w in BENCH["workloads"]
                 if R.Run(BENCH, w["name"], 0, 1.0, False, None)
                 .mix["kind"] == kind)


FLEETS = _cells("fleet")
# The pass cells: their check replays kept blocks from the program's state.
PASSES = _cells("cli_pass")
CELLS = FLEETS + PASSES


def state_unchanged(orig):
    def step(cfg, carry, Ft):
        _, outs = orig(cfg, carry, Ft)
        return dataclasses.replace(carry), outs
    return step


def symbol_altered(orig):
    def step(cfg, carry, Ft):
        carry, outs = orig(cfg, carry, Ft)
        outs.sym_re[:, 7] = -outs.sym_re[:, 7]
        return carry, outs
    return step


def turbo_symbol_altered(orig):
    """A pass's symbols are assembled by turbo: every thousandth one
    negated there."""
    def demod(*args, **kwargs):
        res = orig(*args, **kwargs)
        res.symbols["re"][7::1000] = -res.symbols["re"][7::1000]
        return res
    return demod


FAULTS = {"sound": None, "state_unchanged": state_unchanged,
          "symbol_altered": symbol_altered}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_correct_is_false_under_each_fault(cell, fault, monkeypatch, capsys):
    from meteor_demod_tpu_torch.demod import backend, turbo
    if FAULTS[fault] is not None:
        # Both recurrences a demodulator can be built on: the kernel's and
        # the plain one the CPU runs.
        for name in ("block_demod", "block_demod_torch"):
            monkeypatch.setattr(backend, name,
                                FAULTS[fault](getattr(backend, name)))
    if fault == "symbol_altered" and cell in PASSES:
        monkeypatch.setattr(turbo, "demod_array_turbo", turbo_symbol_altered(
            turbo.demod_array_turbo))
    run = small_run(cell, 21)
    run.warm = False            # a pass cell's warm-up: the check needs none
    res = execute(run, capsys)
    n = res["checks"]["mismatches"]["value"]
    if fault == "sound":
        assert res["correct"]
    else:
        assert not res["correct"] and n > 0


@pytest.mark.parametrize("cell", FLEETS + PASSES)
def test_another_summation_order_is_correct(cell, capsys):
    run = small_run(cell, 23)
    run.fir = "reordered"
    run.warm = False
    res = execute(run, capsys)
    assert res["correct"]


@pytest.mark.parametrize("cell", FLEETS)
def test_the_control_is_not_correct_here_either(cell, capsys):
    """The TF32 control at the small sizes on the CPU (the card's readings
    at the cells' sizes are test_lrpt_control.py)."""
    run = small_run(cell, 22)
    run.fir = "tf32"
    res = execute(run, capsys)
    assert not res["correct"] and res["checks"]["mismatches"]["value"] > 0


@pytest.mark.parametrize("cell", PASSES)
def test_the_control_fails_the_replay(cell, capsys):
    """The TF32 control at the small sizes on the CPU: the pass's .s does
    not separate it from a sound float32 order, the kept blocks replayed
    from the program's state do (their small-size limit: small.py)."""
    run = small_run(cell, 22)
    run.fir, run.warm = "tf32", False
    res = execute(run, capsys)
    c = res["checks"]["replay_per_mille"]
    assert not res["correct"] and c["value"] > c["limit"]
