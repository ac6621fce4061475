"""The readings that set the correctness check's limit, on the card at the
cells' own sizes, each cell's seeds in one process:

- sound runs: the program as it is, on a dozen seeds, and the program with
  its matched filter summed in another float32 order (controls.py
  reordered_fir), on three;
- the control: the program with its matched filter in TF32 (controls.py
  tf32_fir), the precision below the configurations' float32 with TF32
  off, on three seeds.

Every cell of BENCHMARK.json is read, with its driver's CONTROL: the
seeds' counts and the window's length, short: a fleet cell's few seconds
of chains, a pass cell's one pass (its warm-up pass skipped), with the
drawn chains and segments checked as a run checks them. The checks run on
the host's cores beside the next seed's window, at most `workers` of them
at a time and no more than half the host's free memory holds (_fits);
where that is fewer than two, each seed is checked in this process on the
card, as a run checks it. Every sound run must read within each of the
cell's limits, and every control run above one of them: in the fleet
cells `mismatches`, in the pass cells `replay_per_mille` (kept block
calls replayed from the program's state; the pass's segments do not
separate the control, PERF.md section 2).

    python -m pytest lrpt_bench/tests/test_lrpt_control.py -q -m gpu -s
    python -m pytest lrpt_bench/tests/test_lrpt_control.py -q -m gpu -s \
        -k qpsk72k.fleet1024                          # one cell
"""

import json
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

from lrpt_bench import run as R

SOUND = tuple(range(6200000001, 6200000013))
REORDERED = (6300000001, 6300000002, 6300000003)
CONTROL = (6100000001, 6100000002, 6100000003)
BENCH = json.loads((R.ROOT / "BENCHMARK.json").read_text())
CELLS = tuple(w["name"] for w in BENCH["workloads"])


def _run(cell: str, seed: int, card) -> R.Run:
    return R.Run(BENCH, cell, seed, 1.0, False, card)


def plan(cell: str) -> list:
    """(seed, fir) pairs: the driver's CONTROL["seeds"] counts of sound,
    reordered and TF32 seeds."""
    n = _run(cell, 0, None).driver().CONTROL["seeds"]
    return ([(s, None) for s in SOUND[:n[0]]]
            + [(s, "reordered") for s in REORDERED[:n[1]]]
            + [(s, "tf32") for s in CONTROL[:n[2]]])


def _fits(st: dict) -> int:
    """How many seeds' checks half the host's free memory holds at once: a
    seed waiting or checked keeps its traffic here, in transit and in its
    worker, and the worker about three times as much again for the
    reference's blocks."""
    size = sum(v.nbytes for v in st.values() if isinstance(v, np.ndarray))
    free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return int(0.5 * free // (6 * size + 1))


def _numbers(chk: dict) -> tuple:
    return {k: v[0] for k, v in chk["numbers"].items()}, chk["detail"]


def _check(run, st) -> tuple:
    torch.set_num_threads(2)
    return _numbers(run.driver().check(run, st))


def readings(cell: str, card, plan: list, workers: int = 4) -> list:
    """(seed, fir) pairs through setup and a short window on the card,
    each checked on the host's cores, or here on the card where fewer than
    two checks fit. Returns (seed, fir, {number: reading}, detail)."""
    out = []

    def collect(seed, fir, res):
        n, detail = res
        out.append((seed, fir, n, detail))
        print(f"reading {cell} {fir or 'program'} seed {seed}: "
              f"{' '.join(f'{k} {v}' for k, v in n.items())} {detail}",
              flush=True)

    with ProcessPoolExecutor(workers,
                             mp_context=mp.get_context("spawn")) as pool:
        futs, most = [], workers
        for i, (seed, fir) in enumerate(plan):
            run = _run(cell, seed, card)
            driver = run.driver()
            run.seconds = driver.CONTROL["window_s"]
            run.fir, run.warm = fir, False
            st = driver.setup(run)
            with R.fir_context(run):
                w = driver.window(run, st)
            assert w["failed"] == 0, (cell, seed, fir)
            driver.release(st)
            if card.type == "cuda":
                torch.cuda.empty_cache()
            if i == 0:
                fits = _fits(st)
                most = min(workers, fits) if fits >= 2 else 0
            if not most:
                res = _numbers(driver.check(run, st))
                del st
                collect(seed, fir, res)
                continue
            while len(futs) >= most:
                s, f, fut = futs.pop(0)
                collect(s, f, fut.result())
            run.device = torch.device("cpu")
            futs.append((seed, fir, pool.submit(_check, run, st)))
            del st
        for s, f, fut in futs:
            collect(s, f, fut.result())
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_readings_set_the_limit(cell, card, capsys):
    with capsys.disabled():
        res = readings(cell, card, plan(cell))
    run = _run(cell, 0, card)
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
