"""The readings that set the correctness check's limit, on the card at the
cells' own sizes, each cell's seeds in one process:

- sound runs: the program as it is, on a dozen seeds, and the program with
  its matched filter summed in another float32 order (controls.py
  reordered_fir), on three;
- the control: the program with its matched filter in TF32 (controls.py
  tf32_fir), the precision below the configurations' float32 with TF32
  off, on three seeds.

The window is short: a fleet cell's few seconds of chains, a pass cell's
one pass (its warm-up pass skipped), with the drawn chains and segments
checked as a run checks them. The checks run on the host's cores beside
the next seed's window. Every sound run must read within each of the
cell's limits, and every control run above one of them: in the fleet
cells `mismatches`, in the pass cells `replay_per_mille` (kept block
calls replayed from the program's state; the pass's segments do not
separate the control, PERF.md section 2).

    python -m pytest lrpt_bench/tests/test_lrpt_control.py -q -m gpu -s
"""

import importlib
import json
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

import pytest
import torch

from lrpt_bench import run as R

SOUND = tuple(range(6200000001, 6200000013))
REORDERED = (6300000001, 6300000002, 6300000003)
CONTROL = (6100000001, 6100000002, 6100000003)
# A pass cell's seed takes a whole pass on the card: fewer seeds there,
# the sets' and traced runs' seeds making up the dozen.
PASS_PLAN = {"qpsk72k.pass10min": (12, 3, 3),
             "oqpsk80k.pass10min": (12, 3, 3)}
CELLS = ("qpsk72k.fleet128", "oqpsk80k.fleet128", "qpsk72k.pass10min",
         "oqpsk80k.pass10min")
WINDOW_S = {"fleet": 3.0, "cli_pass": 1.0}


def _check(run, st) -> tuple:
    torch.set_num_threads(2)
    driver = importlib.import_module(
        f"lrpt_bench.drivers.{run.mix['kind']}")
    chk = driver.check(run, st)
    return {k: v[0] for k, v in chk["numbers"].items()}, chk["detail"]


def readings(cell: str, card, plan: list, workers: int = 4) -> list:
    """(seed, fir) pairs through setup and a short window on the card,
    each checked on the host. Returns (seed, fir, {number: reading},
    detail)."""
    bench = json.loads((R.ROOT / "BENCHMARK.json").read_text())
    out = []
    with ProcessPoolExecutor(workers,
                             mp_context=mp.get_context("spawn")) as pool:
        futs = []
        for seed, fir in plan:
            run = R.Run(bench, cell, seed, 0.0, False, card)
            run.seconds = WINDOW_S[run.mix["kind"]]
            run.fir, run.warm = fir, False
            driver = importlib.import_module(
                f"lrpt_bench.drivers.{run.mix['kind']}")
            st = driver.setup(run)
            with R.fir_context(run):
                w = driver.window(run, st)
            assert w["failed"] == 0, (cell, seed, fir)
            driver.release(st)
            torch.cuda.empty_cache()
            run.device = torch.device("cpu")
            futs.append((seed, fir, pool.submit(_check, run, st)))
            del st
        for seed, fir, f in futs:
            n, detail = f.result()
            out.append((seed, fir, n, detail))
            print(f"reading {cell} {fir or 'program'} seed {seed}: "
                  f"{' '.join(f'{k} {v}' for k, v in n.items())} {detail}",
                  flush=True)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_readings_set_the_limit(cell, card, capsys):
    n = PASS_PLAN.get(cell, (len(SOUND), len(REORDERED), len(CONTROL)))
    plan = ([(s, None) for s in SOUND[:n[0]]]
            + [(s, "reordered") for s in REORDERED[:n[1]]]
            + [(s, "tf32") for s in CONTROL[:n[2]]])
    with capsys.disabled():
        res = readings(cell, card, plan)
    bench = json.loads((R.ROOT / "BENCHMARK.json").read_text())
    run = R.Run(bench, cell, 0, 1.0, False, card)
    names = list(res[0][2])
    limit = {k: run.limit(k) for k in names}
    sound = {k: [n[k] for _, fir, n, _ in res if fir != "tf32"]
             for k in names}
    control = [n for _, fir, n, _ in res if fir == "tf32"]
    with capsys.disabled():
        for k in names:
            print(f"\n{cell} {k}: sound {sound[k]} (lower {max(sound[k])}),"
                  f" control {[n[k] for n in control]}, limit {limit[k]}")
    for k in names:
        assert max(sound[k]) <= limit[k]
    assert all(any(n[k] > limit[k] for k in names) for n in control)
