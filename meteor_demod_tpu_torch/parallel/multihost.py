"""One fleet over several processes: the stream axis across a torch.distributed
job.

The reference is a single-process program; scaling it out means running N
copies. The JAX package runs ONE logical fleet over the global device mesh
of a multi-process job; so does this module:

- `init_distributed` joins the job: torch.distributed.init_process_group
  with the gloo backend and a finite timeout, by env:// discovery
  (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) unless told otherwise.
  For a job whose processes all run on one machine, `local_init_method`
  gives a rendezvous on a file in the job's directory, with no TCP port to
  pick.
- `shutdown_distributed` ends the job; `init_distributed` registers it with
  atexit, as the JAX package finalizes its job at exit.
- `MultiHostFleet` is one process's part of the global fleet: a
  parallel/mesh.py FleetDemodulator over the process's own device list.
  Global stream rows are rank-major: process r owns rows
  [r * n_local, (r + 1) * n_local), and every process has the same n_local.
  Streams never move between processes.
- The only collective is one all_reduce of the five telemetry values, run
  on telemetry ticks only. The values are host scalars after the readback
  already, so it reduces a CPU tensor over gloo: the demodulation stays on
  the card and NCCL is not needed. That also lets two processes share one
  card: two NCCL ranks cannot both sit on cuda:0, two gloo ranks can.
- Lockstep: every process must make the same collective calls, or the job
  hangs until the timeout. Ticks fall on the same blocks everywhere (one
  block counter, advanced once a call). A tick whose reduced flag count is
  nonzero sends every process into the recovery, which re-derives the
  telemetry with a second all_reduce; between ticks a process whose own
  streams flagged recovers them alone, with no collective, and the
  corrected rows reach the next tick's reduction.

The exit contract: after a clean job every process exits 0, whether it
calls shutdown_distributed itself or leaves it to atexit; a process whose
peer died exits within the job's timeout, non-zero where its own work
failed. Without the shutdown a gloo worker thread can still hold the last
collective's tensor when the interpreter finalizes; releasing it then needs
the GIL, Python ends the thread with pthread_exit inside a noexcept C++
destructor, and the process aborts (SIGABRT) after it did its work.

A world of one (no process group) runs the same code with no collective.
torch.distributed is called only in this module.
"""

from __future__ import annotations

import atexit
import datetime
import os
import sys

import numpy as np
import torch

from ..config import DemodConfig
from ..utils import make_mesh
from .mesh import TELEMETRY, FleetDemodulator, _telemetry_values

# Seconds a rendezvous or a collective may wait for the other processes
# before it raises.
DEFAULT_TIMEOUT_S = 300.0


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the job's gloo process group; a no-op if already joined.

    init_method defaults to env:// (MASTER_ADDR, MASTER_PORT and, when not
    given, WORLD_SIZE and RANK from the environment); e.g.
    init_distributed("tcp://localhost:29500", 2, rank), or, for processes
    on one machine, init_distributed(local_init_method(job_dir), 2, rank).
    A failed or timed out rendezvous raises.

    Joining registers shutdown_distributed with atexit, so every process
    of a clean job exits 0 even if it never calls it; timeout_s also bounds
    what a dead peer costs a collective or the exit."""
    dist = torch.distributed
    if dist.is_initialized():
        return
    kw = {}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(
        "gloo", init_method=init_method or "env://",
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    atexit.register(_shutdown_at_exit)


def local_init_method(directory: str) -> str:
    """init_method for a job whose processes all run on this machine: a
    FileStore on a file in `directory`, which serves this one job (e.g. a
    new temporary directory; the file may outlive the job) and is given to
    every process. No TCP port is picked, so no other process can take it
    between the pick and rank 0's bind."""
    return "file://" + os.path.join(os.path.abspath(directory), "rendezvous")


def shutdown_distributed() -> None:
    """End this process's part of the job: a barrier under the job's
    timeout, so that no process tears down while a peer still uses the
    group, then destroy_process_group, which joins gloo's worker threads
    while the interpreter can still run them. A no-op outside a process
    group, and idempotent. Raises if the barrier fails (a peer died or
    timed out); the group is destroyed all the same."""
    _shutdown(agree=True)


def _shutdown_at_exit() -> None:
    # A process leaving on an uncaught exception skips the barrier: its
    # peers may be inside another collective, which a barrier would meet
    # only at the timeout; closing the group at once fails theirs now.
    _shutdown(agree=not hasattr(sys, "last_value"))


def _shutdown(agree: bool) -> None:
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return
    try:
        if agree:
            dist.barrier()
    finally:
        dist.destroy_process_group()


def world() -> tuple[int, int]:
    """(world size, rank) of the job; (1, 0) outside a process group."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _telemetry_fn(tel: dict) -> dict:
    """The job's telemetry from this process's: the counts add and
    mean_agc_gain is the mean of the processes' means (each the mean of its
    equal shards' means: the JAX step's pmean). One all_reduce of a float64
    CPU tensor, which holds the int32 counts exactly; every process must
    call it. A world of one returns the values as they are."""
    size, _ = world()
    if size == 1:
        return dict(tel)
    t = torch.tensor([float(tel[k]) for k in TELEMETRY], dtype=torch.float64)
    torch.distributed.all_reduce(t)
    out = dict(zip(TELEMETRY, t.tolist()))
    out["mean_agc_gain"] /= size
    return _telemetry_values(out)


class MultiHostFleet:
    """One process's part of a fleet across every process of the job.

    Each process feeds process_local_blocks the sample rows of ITS streams
    (local_stream_slice says which global rows those are) and gets back
    those streams' BlockOutput; `telemetry` is fleet-global, the same in
    every process. `mesh` is this process's device list (None: every
    visible card, utils.make_mesh), streams_per_device streams on each; with
    mesh=None in every process this is the JAX package's global_fleet, the
    fleet over every card of the job.

    A job of several processes is joined with init_distributed before the
    fleet is made and ends with shutdown_distributed or at exit: every
    process of a clean job exits 0, and a dead peer costs a telemetry tick
    or the exit at most the job's timeout.
    """

    def __init__(self, cfg: DemodConfig, streams_per_device: int,
                 backend: str = "auto", recover_flagged: bool = True,
                 telemetry_every: int = 1, mesh=None):
        cfg.validate()
        if telemetry_every < 1:
            raise ValueError("telemetry_every must be >= 1")
        self.cfg = cfg
        self.world_size, self.rank = world()
        self.mesh = make_mesh(mesh)
        self.spd = streams_per_device
        self.n_local = streams_per_device * len(self.mesh)
        self.n_streams = self.n_local * self.world_size
        self.recover_flagged = recover_flagged
        # The local fleet never recovers on its own: when to recover, and
        # whether the telemetry is then reduced again, is the job's call.
        self._fleet = FleetDemodulator(
            cfg, self.n_local, backend=backend, recover_flagged=False,
            telemetry_every=telemetry_every, mesh=self.mesh)
        self.telemetry = None
        self.local_stream_flags = None

    @property
    def telemetry_every(self) -> int:
        return self._fleet.telemetry_every

    @property
    def carry(self):
        """This process's rows of the fleet carry (FleetDemodulator.carry)."""
        return self._fleet.carry

    def local_stream_slice(self) -> slice:
        """Global stream rows owned by this process."""
        return slice(self.rank * self.n_local, (self.rank + 1) * self.n_local)

    def process_local_blocks(self, local_blocks: np.ndarray):
        """local_blocks: (n_local, block_len) complex64 (or (..., 2)
        float32) -> this process's rows of the fleet BlockOutput (numpy)."""
        fleet = self._fleet
        blocks = fleet._feed(local_blocks)
        prev, outs, tel_tick, _ = fleet._dispatch(blocks)
        self.local_stream_flags = fleet.stream_flags
        if tel_tick:
            self.telemetry = _telemetry_fn(fleet.telemetry)
            # The reduced flag count is the same in every process, so all
            # of them enter the recovery (and its collective) together.
            if self.recover_flagged and int(self.telemetry["flags"]) != 0:
                outs = self._recover_local(prev, blocks, outs)
        elif self.recover_flagged and np.any(self.local_stream_flags):
            # Between ticks the trigger is local: only this process enters,
            # so no collective may run.
            outs = self._recover_local(prev, blocks, outs, collective=False)
        return outs

    def _recover_local(self, prev: list, blocks: np.ndarray, outs,
                       collective: bool = True):
        """Re-demodulate this process's flagged streams with the exact
        scalar oracle (FleetDemodulator._recover on the local rows); when
        `collective` (a tick, every process taking part), re-derive the
        fleet-global telemetry from the corrected state, flags 0."""
        fleet = self._fleet
        if len(fleet.flagged_streams()):
            outs = fleet._recover(prev, blocks, outs, update_telemetry=False)
        if collective:
            leaves = fleet._shards.carry_to_numpy(fleet._carries)
            self.telemetry = _telemetry_fn(fleet.telemetry_of(leaves,
                                                              outs.valid))
        return outs

    def flagged_local_streams(self) -> np.ndarray:
        """Local stream rows that tripped a safety flag in the last block
        (already recovered exactly when recover_flagged, the default)."""
        return self._fleet.flagged_streams()

    # -- checkpoint state (io/checkpoint.py wraps these in .npz files) --

    def state_dict(self) -> tuple[dict, dict]:
        """(json-able meta, numpy arrays) of THIS PROCESS's part: its local
        fleet's state and the fleet-global telemetry. The meta is the JAX
        MultiHostFleet's flat one (so its load_multihost_checkpoint resumes
        the file at the same topology), with this port's rank and the local
        fleet's meta beside it. Every process saves its own file at the
        same block; a restore needs the same topology (process count, rank
        and local stream count)."""
        fm, arrays = self._fleet.state_dict()
        if self.local_stream_flags is not None:
            arrays["local_stream_flags"] = np.asarray(
                self.local_stream_flags)
        meta = dict(
            cfg=fm["cfg"], streams_per_device=self.spd,
            axis_name=fm["axis_name"], backend=fm["backend"],
            port_backend=fm["port_backend"],
            telemetry_every=self.telemetry_every,
            recover_flagged=self.recover_flagged,
            block_idx=fm["block_idx"],
            recovered_streams=fm["recovered_streams"],
            n_local=self.n_local, n_streams=self.n_streams, rank=self.rank,
            telemetry=(None if self.telemetry is None else
                       {k: float(v) for k, v in self.telemetry.items()}),
            local=fm)
        return meta, arrays

    def restore_state(self, meta: dict, z, prefix: str = "") -> None:
        """Overwrite this process's state from its state_dict capture, or
        from a JAX MultiHostFleet's (flat meta: no local fleet's meta, no
        rank, which its loader does not check either); a capture of another
        topology is refused."""
        saved = (meta["n_local"], meta["n_streams"],
                 meta.get("rank", self.rank))
        if saved != (self.n_local, self.n_streams, self.rank):
            raise ValueError(
                f"checkpoint topology (n_local, n_streams, rank) {saved} "
                f"does not match this job's "
                f"{(self.n_local, self.n_streams, self.rank)}")
        self.recover_flagged = bool(meta["recover_flagged"])
        local = meta.get("local")
        if local is None:
            # The local fleet of a JAX capture: its rows, counters and
            # flags; its own telemetry is made on the next tick.
            local = dict(cfg=meta["cfg"], n_streams=self.n_local,
                         axis_name=meta["axis_name"],
                         backend=meta.get("backend", "auto"),
                         recover_flagged=False,
                         telemetry_every=meta["telemetry_every"],
                         block_idx=meta["block_idx"],
                         recovered_streams=meta["recovered_streams"],
                         telemetry=None)
        self._fleet.restore_state(local, z, prefix)
        self._fleet.recover_flagged = False
        if f"{prefix}local_stream_flags" in z.files:
            self._fleet.stream_flags = np.asarray(
                z[f"{prefix}local_stream_flags"]).copy()
        self.local_stream_flags = self._fleet.stream_flags
        self.telemetry = (None if meta["telemetry"] is None else
                          _telemetry_values(meta["telemetry"]))
