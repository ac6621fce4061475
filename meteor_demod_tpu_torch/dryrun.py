"""Entry points for a quick start check: one block through the demodulator,
and a dry run of every multi-device layer at tiny shapes.

    python -m meteor_demod_tpu_torch.dryrun [N]   # N shards, default 4

entry() gives the block demodulator with example arguments on the default
device (utils.select_device: the card, or the CPU under
METEOR_DEMOD_PLATFORM=cpu). dryrun_multichip(n) runs the fleet, a chained
fleet, turbo, the time-sharded FIR and a one-process MultiHostFleet over n
shards: n x "cpu" under METEOR_DEMOD_PLATFORM=cpu, else the visible cards,
cycled to n when there are fewer (shards that share a card run on it in
turn). Every check raises on failure.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .config import DemodConfig
from .utils import make_mesh, select_device


def _cfg(block_len: int = 4096) -> DemodConfig:
    return DemodConfig(samplerate=230400, block_len=block_len)


def entry():
    """(fn, example_args) for the forward step: one block of IQ samples of
    one stream through the FIR and the AGC / PLL / timing recurrence,
    fn(carry, block) -> (carry', BlockOutput)."""
    from .demod.backend import make_batch_demod
    from .demod.state import batch_carry
    cfg = _cfg()
    dev = select_device()
    fn = make_batch_demod(cfg, 1, dev)
    rng = np.random.default_rng(0)
    block = torch.as_tensor(
        rng.standard_normal((1, cfg.block_len, 2)).astype(np.float32) * 800,
        device=dev)
    return fn, (batch_carry(cfg, 1, dev), block)


def dryrun_devices(n_devices: int) -> list:
    """n shards over the devices there are (see the module docstring)."""
    devs = make_mesh()
    return [devs[i % len(devs)] for i in range(n_devices)]


def dryrun_multichip(n_devices: int) -> None:
    """One fleet step and one chained step over n_devices shards, turbo
    with chunks = 2 * n_devices over them, the time-sharded FIR against one
    call, and a MultiHostFleet step in one process (no process group, a
    world of one, no collective)."""
    from .dsp.fir import iq_to_f32, make_fir_banks, polyphase_fir_block
    from .parallel.mesh import FleetDemodulator
    from .parallel.multihost import MultiHostFleet, world
    from .parallel.timeshard import make_sharded_fir
    from .demod.turbo import demod_array_turbo
    from .sim import synth_psk

    devs = dryrun_devices(n_devices)
    print(f"dryrun_multichip({n_devices}) on "
          f"{', '.join(str(d) for d in devs)}", flush=True)
    cfg = _cfg(block_len=512)
    n_streams = 2 * n_devices
    fleet = FleetDemodulator(cfg, n_streams, mesh=devs)
    blocks = np.stack([
        synth_psk(200, cfg.samplerate, carrier_hz=50.0 * i, seed=i,
                  amplitude=5000.0)[0][:cfg.block_len]
        for i in range(n_streams)])
    outs = fleet.process_blocks(blocks)
    assert int(fleet.telemetry["symbols"]) > 0, fleet.telemetry
    assert outs.valid.shape[0] == n_streams

    # Chained dispatch: two blocks a call, the serving host's shape.
    fleet_c = FleetDemodulator(cfg, n_streams, mesh=devs, chain_blocks=2)
    outs_c = fleet_c.process_blocks(np.concatenate([blocks, blocks], axis=1))
    assert outs_c.valid.shape[0] == n_streams
    assert int(fleet_c.telemetry["symbols"]) > 0, fleet_c.telemetry

    # One recording's lanes over the shards.
    chunks = 2 * n_devices
    x, _ = synth_psk(int(chunks * cfg.block_len * 72000 / cfg.samplerate)
                     + 64, cfg.samplerate, carrier_hz=150.0,
                     amplitude=6000.0, seed=5)
    res = demod_array_turbo(cfg, x[:chunks * cfg.block_len], chunks=chunks,
                            max_passes=2, mesh=devs)
    assert len(res.symbols) > 0

    # One stream's samples over the shards: equal to one call, bitwise.
    L = 1024
    xt = iq_to_f32(synth_psk(
        int(n_devices * L * 72000 / cfg.samplerate) + 64, cfg.samplerate,
        carrier_hz=120.0, amplitude=5000.0, seed=7)[0][:n_devices * L])
    got = torch.cat([f.cpu() for f in make_sharded_fir(cfg, devs)(xt)])
    ref, _ = polyphase_fir_block(
        torch.as_tensor(xt[None], device=devs[0]),
        torch.zeros((1, cfg.taps - 1, 2), device=devs[0]),
        torch.as_tensor(make_fir_banks(cfg), device=devs[0]))
    assert torch.equal(got, ref.cpu()), "time-sharded FIR != one call"

    # The multi-process fleet in one process.
    assert world() == (1, 0), world()
    mh = MultiHostFleet(cfg, streams_per_device=1, mesh=devs)
    rows = mh.local_stream_slice()
    outs_mh = mh.process_local_blocks(blocks[rows])
    assert int(mh.telemetry["symbols"]) > 0, mh.telemetry
    assert outs_mh.valid.shape[0] == rows.stop - rows.start


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    fn, args = entry()
    carry, out = fn(*args)
    print(f"entry ok: {int(out.valid.sum())} symbols on "
          f"{out.valid.device}", flush=True)
    dryrun_multichip(int(argv[0]) if argv else 4)
    print("dryrun_multichip ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
