"""Worker and job runner for tests/test_torch_multihost_exit.py (not a test
module).

A worker is one rank of a 2-process gloo job: it joins at <init method>,
takes one MultiHostFleet step of 1 stream on <device> (one all_reduce of
the telemetry) and returns. <mode> says how the job ends:

- explicit: shutdown_distributed(), after which no process group is left;
- atexit: nothing, the hook init_distributed registered ends it;
- raise: rank 0 raises before its step, rank 1 takes it;
- bare: no library call at all: init_process_group, one all_reduce, return
  with the group live and no hook, as every job ended before
  shutdown_distributed existed (the fault's reproduction).

The rank <last> returns 0.2 s after its peer.

    python tests/torch_exit_worker.py <rank> <init method> <last> <mode> <timeout s> [device]

The runner starts <jobs> such jobs, <at once> at a time (more processes
than cores load the machine), either rank returning last in turn, and
prints one JSON line with the count of processes that did not exit 0:

    python tests/torch_exit_worker.py --loop <jobs> <at once> <mode> [device]
"""

import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.parallel.multihost import (MultiHostFleet,
                                                       init_distributed,
                                                       local_init_method,
                                                       shutdown_distributed,
                                                       world)

TIMEOUT_S = 60.0    # the jobs' gloo timeout


def start_job(directory: Path, last: int, mode: str,
              device: str = "cpu") -> list:
    """The two processes of one job, rendezvous in `directory` (made
    here)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    if device == "cpu":
        env["METEOR_DEMOD_PLATFORM"] = "cpu"
    directory.mkdir()
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank),
         local_init_method(directory), str(last), mode, str(TIMEOUT_S),
         device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for rank in (0, 1)]


def finish(procs: list) -> list:
    """(exit code, output) of each process, every one ended."""
    try:
        outs = [p.communicate(timeout=4 * TIMEOUT_S)[0].decode()
                for p in procs]
        return [(p.returncode, out) for p, out in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def run_jobs(directory: Path, jobs: int, mode: str,
             device: str = "cpu") -> list:
    """(exit code, output) of both ranks of `jobs` jobs run at once, job j's
    rank j % 2 returning last."""
    started = [start_job(directory / f"job{j}", j % 2, mode, device)
               for j in range(jobs)]
    return finish([p for job in started for p in job])


def loop(jobs: int, at_once: int, mode: str, device: str) -> dict:
    bad, t0 = {}, time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        for k in range(0, jobs, at_once):
            batch = Path(tmp) / str(k)
            batch.mkdir()
            for i, (rc, out) in enumerate(
                    run_jobs(batch, min(at_once, jobs - k), mode, device)):
                if rc != 0 or f"rank {i % 2} {mode} done" not in out:
                    bad[str(rc)] = bad.get(str(rc), 0) + 1
                    sys.stderr.write(f"job {k + i // 2} rank {i % 2} exit "
                                     f"{rc}:\n{out[-2000:]}\n")
    return dict(mode=mode, device=device, jobs=jobs, at_once=at_once,
                processes=2 * jobs, bad_exits=sum(bad.values()),
                bad_by_code=bad, seconds=time.monotonic() - t0)


def worker(rank: int, init_method: str, last: int, mode: str,
           timeout_s: float, device: str) -> None:
    if mode == "bare":
        dist = torch.distributed
        dist.init_process_group(
            "gloo", init_method=init_method, world_size=2, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        t = torch.ones(5, dtype=torch.float64)
        dist.all_reduce(t)
        assert float(t[0]) == 2.0
    else:
        init_distributed(init_method, world_size=2, rank=rank,
                         timeout_s=timeout_s)
        assert world() == (2, rank), world()
        if mode == "raise" and rank == 0:
            raise RuntimeError("rank 0 fails before its collective")
        cfg = DemodConfig(samplerate=230400, block_len=1024)
        fleet = MultiHostFleet(cfg, 1, mesh=[device])
        fleet.process_local_blocks(np.zeros((1, cfg.block_len),
                                            np.complex64))
        assert fleet.telemetry is not None
    if rank == last:
        time.sleep(0.2)
    if mode == "explicit":
        shutdown_distributed()
        assert not torch.distributed.is_initialized()
        shutdown_distributed()          # idempotent
    print(f"rank {rank} {mode} done", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--loop":
        print(json.dumps(loop(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4], (sys.argv[5:] or ["cpu"])[0])))
    else:
        worker(int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), sys.argv[4],
               float(sys.argv[5]), sys.argv[6])
