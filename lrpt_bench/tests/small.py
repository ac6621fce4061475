"""Small versions of the cells, for runs on the CPU."""

from __future__ import annotations

import json
import os
import time

import torch

from lrpt_bench import run as R

SMALL = {
    "fleet": dict(streams=6, chain_blocks=2, loop_blocks=18,
                  warmup_chains=30, carrier_hz=[20.0, 150.0],
                  check_chains=2, exact_blocks=1, untracked_max=0,
                  limits={"mismatches": 4}),
    "cli_pass": dict(seconds=0.75, t_ca_s=0.0, check_segments=3,
                     segment_warmup_blocks=6, segment_blocks=2,
                     settle_blocks=4, start_max_blocks=60,
                     replay_blocks=16, replay_min_blocks=4,
                     limits={"mismatches": 0,
                             "replay_per_mille": {"qpsk72k": 2.0,
                                                  "oqpsk80k": 2.0}}),
}


def small_run(cell: str, seed: int, seconds: float = 0.5,
              trace: bool = False) -> R.Run:
    # The CLI's pass picks its device from the environment.
    os.environ.setdefault("METEOR_DEMOD_PLATFORM", "cpu")
    bench = json.loads((R.ROOT / "BENCHMARK.json").read_text())
    run = R.Run(bench, cell, seed, seconds, trace, torch.device("cpu"))
    run.mix.update(SMALL[run.mix["kind"]])
    run.cfg["block_len"] = 1024
    return run


def execute(run: R.Run, capsys) -> dict:
    """Drive a whole run (the harness's look for a card skipped) and
    return its result line."""
    assert R.execute(run, time.time()) == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
