"""Small versions of the cells, for runs on the CPU: each mix with its
driver's SMALL put over it."""

from __future__ import annotations

import copy
import json
import os
import time

import torch

from lrpt_bench import run as R


def small_run(cell: str, seed: int, seconds: float = 0.5,
              trace: bool = False) -> R.Run:
    # The CLI's pass picks its device from the environment.
    os.environ.setdefault("METEOR_DEMOD_PLATFORM", "cpu")
    bench = json.loads((R.ROOT / "BENCHMARK.json").read_text())
    run = R.Run(bench, cell, seed, seconds, trace, torch.device("cpu"))
    run.mix.update(copy.deepcopy(run.driver().SMALL))
    run.cfg["block_len"] = 1024
    return run


def execute(run: R.Run, capsys) -> dict:
    """Drive a whole run (the harness's look for a card skipped) and
    return its result line."""
    assert R.execute(run, time.time()) == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
