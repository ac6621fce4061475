"""The port's multi-process fleet (meteor_demod_tpu_torch/parallel/multihost.py)
in a real 2-process gloo job on the CPU, held against the single-process
port as tests/test_multihost.py holds the JAX package's.

Two workers (tests/torch_multihost_worker.py), each with four "cpu" shards
of 2 streams (16 global streams), rendezvous on a file in the test's
directory (parallel/multihost.py local_init_method) and both exit 0; their
local rows must be bitwise the single-process fleet's rows and their
telemetry the same in both processes. The workers also hold
telemetry_every=3 against per-block telemetry, the multihost checkpoint
resumed bitwise and a checkpoint of another topology refused (any failure
there exits the worker non-zero).
"""

import os
import subprocess
import sys

import numpy as np

from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.parallel.mesh import FleetDemodulator
from meteor_demod_tpu_torch.parallel.multihost import local_init_method

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_multihost_worker import stream_blocks  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_multihost_worker.py")


def test_two_process_gloo_fleet(tmp_path):
    init_method = local_init_method(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["METEOR_DEMOD_PLATFORM"] = "cpu"
    procs, outfiles = [], []
    for rank in (0, 1):
        out = tmp_path / f"w{rank}.npz"
        outfiles.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(rank), init_method, str(out),
             str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env))
    for p in procs:
        stdout, _ = p.communicate(timeout=240)
        assert p.returncode == 0, stdout.decode()[-3000:]

    # The single-process port on the same 16 streams' first block.
    cfg = DemodConfig(samplerate=230400, block_len=1024)
    data = np.stack([stream_blocks(cfg, g)[:cfg.block_len]
                     for g in range(16)])
    ref = FleetDemodulator(cfg, 16, device="cpu")
    want = ref.process_blocks(data)

    seen = np.zeros(16, dtype=bool)
    tels = []
    for out in outfiles:
        z = np.load(out)
        sl = slice(int(z["start"]), int(z["stop"]))
        seen[sl] = True
        for k in ("sym_re", "sym_im", "valid", "locked_once"):
            np.testing.assert_array_equal(z[k], getattr(want, k)[sl],
                                          err_msg=k)
        tels.append({k: z[f"tel_{k}"] for k in ref.telemetry})
    assert seen.all(), "the workers did not cover all 16 global streams"
    # The same telemetry in both processes, the fleet's.
    for k in ref.telemetry:
        assert tels[0][k] == tels[1][k], k
        if k == "mean_agc_gain":
            np.testing.assert_allclose(float(tels[0][k]),
                                       float(ref.telemetry[k]), rtol=1e-6)
        else:
            assert int(tels[0][k]) == int(ref.telemetry[k]), k
