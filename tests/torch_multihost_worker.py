"""Worker process for tests/test_torch_multihost.py (not a test module).

Joins a 2-process gloo job at <init method> with four "cpu"
shards of its own (8 global shards of 2 streams: 16 global streams), runs
MultiHostFleet steps on its local rows and writes its outputs and the
global telemetry for the parent to compare against the single-process port.
Also holds, in the job: telemetry_every=3 against per-block telemetry, a
multihost checkpoint resumed bitwise, and a checkpoint of another topology
refused. It ends the job with shutdown_distributed.

Usage: python torch_multihost_worker.py <rank> <init method> <out.npz> <ckpt dir>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod.state import carry_to_numpy
from meteor_demod_tpu_torch.io.checkpoint import (load_multihost_checkpoint,
                                                  save_multihost_checkpoint)
from meteor_demod_tpu_torch.parallel.multihost import (MultiHostFleet,
                                                       init_distributed,
                                                       shutdown_distributed,
                                                       world)
from meteor_demod_tpu_torch.sim import synth_psk

MESH = ["cpu"] * 4
SPD = 2
N_BLOCKS = 3


def stream_blocks(cfg, g: int) -> np.ndarray:
    """Global stream g's N_BLOCKS blocks (the parent makes the same)."""
    n = N_BLOCKS * cfg.block_len
    x, _ = synth_psk(int(n * cfg.symrate / cfg.samplerate) + 64,
                     cfg.samplerate, carrier_hz=40.0 + 10.0 * g,
                     amplitude=6000.0, snr_db=22.0, seed=70 + g)
    return x[:n]


def main():
    rank, init_method, outpath, ckdir = (int(sys.argv[1]), sys.argv[2],
                                         sys.argv[3], sys.argv[4])
    init_distributed(init_method, world_size=2, rank=rank, timeout_s=120)
    assert world() == (2, rank), world()
    # A second call is a no-op.
    init_distributed(init_method, world_size=2, rank=rank)

    cfg = DemodConfig(samplerate=230400, block_len=1024)
    L = cfg.block_len
    fleet = MultiHostFleet(cfg, SPD, mesh=MESH)
    sl = fleet.local_stream_slice()
    assert (fleet.n_local, fleet.n_streams) == (8, 16)
    # Each process makes only its own rows, as a real feed would.
    data = np.stack([stream_blocks(cfg, g) for g in range(sl.start, sl.stop)])
    outs = fleet.process_local_blocks(data[:, :L])
    tel = dict(fleet.telemetry)

    # telemetry_every=3 against per-block telemetry over three blocks: the
    # same rows and carry, telemetry frozen between ticks.
    fleet_k = MultiHostFleet(cfg, SPD, telemetry_every=3, mesh=MESH)
    fleet_1 = MultiHostFleet(cfg, SPD, mesh=MESH)
    ck = os.path.join(ckdir, f"mh{rank}.npz")
    for b in range(N_BLOCKS):
        blk = data[:, b * L:(b + 1) * L]
        ok, o1 = fleet_k.process_local_blocks(blk), fleet_1.process_local_blocks(blk)
        for name in ("sym_re", "sym_im", "valid", "locked_once"):
            np.testing.assert_array_equal(getattr(ok, name), getattr(o1, name),
                                          err_msg=f"block {b} {name}")
        if b == 0:
            tel0 = dict(fleet_k.telemetry)
            assert tel0 == fleet_1.telemetry
        else:
            assert fleet_k.telemetry == tel0, f"telemetry moved at block {b}"
        if b == 1:
            save_multihost_checkpoint(ck, fleet_1)
        if b == 2:
            last = o1
    want = carry_to_numpy(fleet_1.carry)
    for k, v in carry_to_numpy(fleet_k.carry).items():
        np.testing.assert_array_equal(v, want[k], err_msg=f"carry {k}")

    # The checkpoint taken after block 2, resumed: block 3 bitwise.
    resumed = load_multihost_checkpoint(ck, mesh=MESH)
    assert resumed.local_stream_slice() == sl
    got = resumed.process_local_blocks(data[:, 2 * L:3 * L])
    for name in ("sym_re", "sym_im", "valid", "locked_once"):
        np.testing.assert_array_equal(getattr(got, name), getattr(last, name),
                                      err_msg=f"resumed {name}")
    assert resumed.telemetry == fleet_1.telemetry
    # Another topology (two local shards, not four) is refused.
    try:
        load_multihost_checkpoint(ck, mesh=["cpu"] * 2)
    except ValueError as e:
        assert "topology" in str(e), e
    else:
        raise AssertionError("a checkpoint of another topology loaded")

    np.savez(outpath, start=sl.start, stop=sl.stop, sym_re=outs.sym_re,
             sym_im=outs.sym_im, valid=outs.valid,
             locked_once=outs.locked_once,
             **{f"tel_{k}": v for k, v in tel.items()})
    shutdown_distributed()
    assert world() == (1, 0), world()
    print(f"worker {rank} ok", flush=True)


if __name__ == "__main__":
    main()
