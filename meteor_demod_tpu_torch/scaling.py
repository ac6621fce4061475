"""Scaling harness: a fixed load per device (or per process) against the
number of devices (or processes).

The scale-out answer to running N copies of the reference binary
(main.c:284-329) is one fleet over N devices; what it can lose is the
bookkeeping around the per-block work. Three modes, each printing one JSON
line:

- `overhead`: per-block ms on ONE device of FleetDemodulator's step (its
  shard bookkeeping, upload, readback and fleet telemetry) against the bare
  make_batch_demod call on the same rows, uploaded and read back through
  the same pinned copies (utils.to_device / to_host). The difference bounds
  what scaling can lose per block. One step of each from the same carry
  must give the same outputs and carry bitwise (same_work_bitwise).
- `multiprocess`: 1 process against 2 processes of parallel/multihost.py
  MultiHostFleet over gloo, with the same streams in every process (a fixed
  per-process load). Efficiency is the slower process's rate over the
  single process's. On the CPU each process is pinned to its own cores
  (os.sched_setaffinity); on cards process i runs on cuda:(i mod count), so
  with one card the two processes share it. Each process's final outputs
  and carry must equal the single process's bitwise, and the job's
  telemetry counts must be twice one process's.
- `shards`: FleetDemodulator(mesh=k devices) with `--spd` streams a shard
  for each k of `--devices`; the k devices cycle over the visible cards
  (all cuda:0 with one card, where shards run in turn), or are "cpu" k
  times. The first shard's rows must equal the one-device fleet's bitwise.

    python -m meteor_demod_tpu_torch.scaling --mode overhead --spd 128 --block 8192
    python -m meteor_demod_tpu_torch.scaling --mode shards --devices 1,2,4 --device cpu
    python -m meteor_demod_tpu_torch.scaling --mode multiprocess --device cpu

`--device cpu` runs on the CPU; the default is the card
(utils.select_device). The worker of `multiprocess` is this module run with
`--worker`, not a user entry point.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .config import DemodConfig
from .demod.backend import make_batch_demod
from .demod.state import carry_from_numpy, carry_to_numpy
from .dsp.fir import iq_to_f32
from .parallel.multihost import (MultiHostFleet, init_distributed,
                                 local_init_method, shutdown_distributed)
from .sim import synth_psk
from .utils import make_mesh, select_device, to_device, to_host

_OUTS = ("sym_re", "sym_im", "valid", "locked_once")


def stream_block(cfg: DemodConfig, g: int) -> np.ndarray:
    """Stream g's block: QPSK at 40 + 7 g Hz, 22 dB, seed 700 + g (complex64,
    one block; every step feeds it again)."""
    x, _ = synth_psk(int(cfg.block_len / cfg.osf) + 64, cfg.samplerate,
                     carrier_hz=40.0 + 7.0 * g, amplitude=6000.0,
                     snr_db=22.0, seed=700 + g)
    return x[:cfg.block_len]


def _card_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _warm(step, locked, n_streams: int, max_blocks: int,
          tel_every: int) -> int:
    """Step until every stream is locked (at most max_blocks), then one
    whole telemetry period; the number of steps taken."""
    n = 0
    while n < max_blocks and locked() != n_streams:
        step()
        n += 1
    for _ in range(max(1, tel_every)):
        step()
    return n + max(1, tel_every)


def _timed_ms(step, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    return (time.perf_counter() - t0) / n * 1e3


def run_overhead(cfg: DemodConfig, spd: int, steps: int, device,
                 tel_every: int = 1, warm_max: int = 64) -> dict:
    """FleetDemodulator's step against the bare batch demod on one device
    (module docstring)."""
    from .parallel.mesh import FleetDemodulator
    device = select_device(device)
    rows = np.stack([stream_block(cfg, g) for g in range(spd)])
    fleet = FleetDemodulator(cfg, spd, device=device,
                             telemetry_every=tel_every)
    warm = _warm(lambda: fleet.process_blocks(rows),
                 lambda: (-1 if fleet.telemetry is None
                          else int(fleet.telemetry["locked_streams"])),
                 spd, warm_max, tel_every)

    fn = make_batch_demod(cfg, spd, device)
    xf = iq_to_f32(rows)
    # One step of each from the fleet's locked carry: the two programs timed
    # below must do the same work, outputs and exit carry bitwise.
    carry0 = {k: np.array(v) for k, v in carry_to_numpy(fleet.carry).items()}
    fleet_outs = dataclasses.astuple(fleet.process_blocks(rows))
    carry, outs = fn(carry_from_numpy(carry0, device), to_device(xf, device))
    same = all(np.array_equal(a, b) for a, b in
               zip(to_host(dataclasses.astuple(outs)), fleet_outs))
    want = carry_to_numpy(fleet.carry)
    same &= all(np.array_equal(v, want[k])
                for k, v in carry_to_numpy(carry).items())
    if not same:
        raise AssertionError("overhead: the bare step's outputs or carry "
                             "differ from the fleet step's")
    # Both timed from a copy of the fleet's carry: the same locked regime.
    state = {"carry": carry_from_numpy(carry_to_numpy(fleet.carry), device)}

    def plain_step():
        # The same copies as the fleet's (pinned staging both ways), so the
        # difference is the fleet's own bookkeeping.
        state["carry"], outs = fn(state["carry"], to_device(xf, device))
        to_host(dataclasses.astuple(outs))

    plain_step()
    steps = -(-steps // tel_every) * tel_every        # whole periods
    fleet_ms = _timed_ms(lambda: fleet.process_blocks(rows), steps)
    plain_ms = _timed_ms(plain_step, steps)
    ovh = fleet_ms - plain_ms
    return dict(mode="overhead", device=str(device),
                card=_card_name(device), spd=spd, block_len=cfg.block_len,
                telemetry_every=tel_every, warm_steps=warm, steps=steps,
                fleet_step_ms=fleet_ms, plain_step_ms=plain_ms,
                overhead_ms=ovh, overhead_fraction=ovh / fleet_ms,
                efficiency_lower_bound=plain_ms / fleet_ms,
                same_work_bitwise=True)


def _devices(k: int, device) -> list:
    """k shard devices: "cpu" k times, else the visible cards cycled."""
    if select_device(device).type == "cpu":
        return [torch.device("cpu")] * k
    cards = make_mesh()
    return [cards[i % len(cards)] for i in range(k)]


def run_shards(cfg: DemodConfig, spd: int, steps: int, sizes: list, device
               ) -> dict:
    """FleetDemodulator over k shards of spd streams for each k in sizes
    (module docstring)."""
    from .parallel.mesh import FleetDemodulator
    rows_out, first = [], None
    for k in sizes:
        mesh = _devices(k, device)
        n = spd * k
        blocks = np.stack([stream_block(cfg, g) for g in range(n)])
        fleet = FleetDemodulator(cfg, n, mesh=mesh)
        fleet.process_blocks(blocks)                     # warm
        t0 = time.perf_counter()
        for _ in range(steps):
            outs = fleet.process_blocks(blocks)
        dt = (time.perf_counter() - t0) / steps
        head = {k2: getattr(outs, k2)[:spd] for k2 in _OUTS}
        head.update({f"carry_{k2}": v[:spd] for k2, v in
                     carry_to_numpy(fleet.carry).items()})
        if first is None:
            first = head
        same = all(np.array_equal(head[k2], first[k2]) for k2 in first)
        if not same:
            raise AssertionError(f"{k} shards: the first shard's rows differ "
                                 f"from the one-device fleet's")
        rate = n * cfg.block_len / dt
        rows_out.append(dict(devices=k, shards_on=sorted({str(d)
                                                          for d in mesh}),
                             streams=n, step_ms=dt * 1e3,
                             msamples_per_s=rate / 1e6,
                             msamples_per_s_per_shard=rate / 1e6 / k,
                             first_shard_bitwise=same))
    base = rows_out[0]
    for r in rows_out:
        r["efficiency_vs_first"] = (r["msamples_per_s_per_shard"]
                                    / base["msamples_per_s_per_shard"])
    dev = select_device(device)
    return dict(mode="shards", device=str(dev), card=_card_name(dev),
                block_len=cfg.block_len, spd=spd, steps=steps,
                rows=rows_out)


# ---------------------------------------------------------------------------
# multiprocess: one worker a process (this module run with --worker)
# ---------------------------------------------------------------------------

def worker(rank: int, nprocs: int, init_method: str, spd: int, block: int,
           steps: int, cores: list, device: str, tel_every: int,
           out: str) -> None:
    """One process of the multiprocess mode: pinned to `cores` on the CPU,
    joins the gloo job at `init_method` when nprocs > 1, warms its
    MultiHostFleet to lock, times `steps` steps, writes its rate, last
    outputs, carry and the job's telemetry to `out` (.npz) and ends the
    job."""
    if device == "cpu":
        # Every thread torch starts from here on inherits the mask.
        os.sched_setaffinity(0, cores)
        torch.set_num_threads(len(cores))
    if nprocs > 1:
        init_distributed(init_method, world_size=nprocs, rank=rank,
                         timeout_s=300)
    cfg = DemodConfig(samplerate=230400, block_len=block)
    fleet = MultiHostFleet(cfg, spd, telemetry_every=tel_every,
                           mesh=[device])
    # The same streams in every process: a fixed load a process.
    rows = np.stack([stream_block(cfg, g) for g in range(spd)])
    state = {}

    def step():
        state["outs"] = fleet.process_local_blocks(rows)

    warm = _warm(step, lambda: (-1 if fleet.telemetry is None else
                                int(fleet.telemetry["locked_streams"])),
                 fleet.n_streams, 64, tel_every)
    steps = -(-steps // tel_every) * tel_every
    dt = _timed_ms(step, steps) / 1e3
    np.savez(out, step_ms=dt * 1e3, warm_steps=warm, steps=steps,
             msamples_per_s=spd * block / dt / 1e6,
             **{k: getattr(state["outs"], k) for k in _OUTS},
             **{f"carry_{k}": v for k, v in
                carry_to_numpy(fleet.carry).items()},
             **{f"tel_{k}": v for k, v in fleet.telemetry.items()})
    shutdown_distributed()


def run_multiprocess(spd: int, block: int, steps: int, device,
                     tel_every: int = 1, timeout_s: float = 900.0) -> dict:
    """1 process against 2 (module docstring)."""
    device = select_device(device)
    if device.type == "cpu":
        cores = sorted(os.sched_getaffinity(0))
        per = max(1, len(cores) // 2)
        core_sets = [cores[:per], cores[per:2 * per] or cores[:per]]
        devs = ["cpu", "cpu"]
    else:
        n = torch.cuda.device_count()
        core_sets = [[], []]
        devs = [f"cuda:{i % n}" for i in range(2)]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    def job(nprocs: int, tmp: str) -> list:
        init_method = local_init_method(tmp)
        outs = [os.path.join(tmp, f"p{nprocs}_{r}.npz")
                for r in range(nprocs)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "meteor_demod_tpu_torch.scaling",
             "--worker", str(r), str(nprocs), init_method, str(spd),
             str(block), str(steps), ",".join(map(str, core_sets[r])),
             devs[r], str(tel_every), outs[r]],
            env=env, cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(nprocs)]
        try:
            logs = [p.communicate(timeout=timeout_s)[0].decode()
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"worker {r} of {nprocs} exit "
                                   f"{p.returncode}:\n{log[-3000:]}")
        return [dict(np.load(o)) for o in outs]

    with tempfile.TemporaryDirectory() as tmp:
        one = job(1, tmp)[0]
        two = job(2, tmp)
    for r, w in enumerate(two):
        for k in one:
            if k.startswith(("sym_", "valid", "locked_once", "carry_")):
                if not np.array_equal(w[k], one[k]):
                    raise AssertionError(f"2 processes: rank {r} {k} differs "
                                         f"from one process's")
        for k in ("locked_streams", "locked_once_streams", "symbols",
                  "flags"):
            if int(w[f"tel_{k}"]) != 2 * int(one[f"tel_{k}"]):
                raise AssertionError(f"2 processes: telemetry {k} "
                                     f"{int(w[f'tel_{k}'])} is not twice "
                                     f"{int(one[f'tel_{k}'])}")
    rates = [float(w["msamples_per_s"]) for w in two]
    base = float(one["msamples_per_s"])
    shared = device.type == "cuda" and devs[0] == devs[1]
    return dict(mode="multiprocess", device=str(device),
                card=_card_name(device), spd=spd, block_len=block,
                steps=int(one["steps"]), telemetry_every=tel_every,
                process_devices=devs,
                cores_per_process=[len(c) for c in core_sets],
                shared_card=shared,
                one_process_msamples_per_s=base,
                two_process_msamples_per_s=rates,
                efficiency_2proc_vs_1proc=min(rates) / base,
                rows_bitwise_one_process=True)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        (rank, nprocs, init_method, spd, block, steps, cores, device,
         tel_every, out) = argv[1:11]
        worker(int(rank), int(nprocs), init_method, int(spd), int(block),
               int(steps), [int(c) for c in cores.split(",") if c], device,
               int(tel_every), out)
        return 0
    ap = argparse.ArgumentParser(
        prog="python -m meteor_demod_tpu_torch.scaling",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="overhead",
                    choices=["overhead", "multiprocess", "shards"])
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    ap.add_argument("--spd", type=int, default=8,
                    help="streams a device (a process, a shard)")
    ap.add_argument("--block", type=int, default=8192, help="block_len")
    ap.add_argument("--steps", type=int, default=4, help="timed steps")
    ap.add_argument("--devices", default="1,2,4",
                    help="shards mode: shard counts to run")
    ap.add_argument("--telemetry-every", type=int, default=1,
                    help="fleet telemetry every K blocks (timed steps round "
                         "up to whole periods)")
    args = ap.parse_args(argv)
    cfg = DemodConfig(samplerate=230400, block_len=args.block)
    if args.mode == "overhead":
        res = run_overhead(cfg, args.spd, args.steps, args.device,
                           args.telemetry_every)
    elif args.mode == "shards":
        res = run_shards(cfg, args.spd, args.steps,
                         [int(s) for s in args.devices.split(",")],
                         args.device)
    else:
        res = run_multiprocess(args.spd, args.block, args.steps, args.device,
                               args.telemetry_every)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
