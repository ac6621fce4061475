"""The exit contract of the port's multi-process fleet
(meteor_demod_tpu_torch/parallel/multihost.py): every process of a clean
gloo job exits 0, whether it ends the job with shutdown_distributed or
leaves it to the atexit hook init_distributed registers, and a process
whose peer died exits non-zero within the job's timeout instead of hanging.

A job left with its group live at exit (the worker's "bare" mode) can
abort (exit -6) after doing its work: a gloo worker thread can still hold
the last collective's tensor when the interpreter finalizes, releasing it
needs the GIL, and Python ends the thread with pthread_exit inside a
noexcept destructor. It shows in a few jobs in a hundred on a busy
machine, so the clean cases run several jobs at once, more processes than
cores, with either rank returning last. Workers and runner:
tests/torch_exit_worker.py, over the rendezvous file of local_init_method.
"""

import os
import sys
import time

import pytest
import torch

from meteor_demod_tpu_torch.parallel.multihost import (init_distributed,
                                                       local_init_method,
                                                       shutdown_distributed,
                                                       world)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_exit_worker import TIMEOUT_S, finish, run_jobs, start_job  # noqa: E402

JOBS = 6            # 2-process jobs at once in a clean case


@pytest.mark.parametrize("mode", ["explicit", "atexit"])
def test_clean_jobs_exit_zero(tmp_path, mode):
    for i, (rc, out) in enumerate(run_jobs(tmp_path, JOBS, mode)):
        job, rank = divmod(i, 2)
        assert rc == 0, f"job {job} rank {rank} exit {rc}:\n{out[-3000:]}"
        assert f"rank {rank} {mode} done" in out, out[-3000:]


def test_dead_peer_costs_at_most_the_timeout(tmp_path):
    t0 = time.monotonic()
    (rc0, out0), (rc1, out1) = finish(start_job(tmp_path / "job", 1,
                                                "raise"))
    secs = time.monotonic() - t0
    assert rc0 == 1 and "rank 0 fails before its collective" in out0, out0
    assert rc1 == 1 and "done" not in out1, out1
    assert secs < TIMEOUT_S, f"the job took {secs:.1f} s"


def test_shutdown_ends_the_group(tmp_path):
    shutdown_distributed()              # outside a group: a no-op
    init_distributed(local_init_method(tmp_path), world_size=1, rank=0)
    assert world() == (1, 0) and torch.distributed.is_initialized()
    shutdown_distributed()
    assert not torch.distributed.is_initialized()
    shutdown_distributed()              # idempotent
    assert world() == (1, 0)
