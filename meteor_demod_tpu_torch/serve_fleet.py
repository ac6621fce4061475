"""Production serving host: many LRPT streams on the cards, restartable.

    python -m meteor_demod_tpu_torch.serve_fleet --synth 256 --dead 2 \\
        --seconds 10 --out-dir out --checkpoint fleet.ckpt.npz

The reference serves one stream per process (main.c:284-329); a station
fleet replaces N such processes with one ServingFleet (parallel/serving.py:
groups of --group-size streams, each dispatched --chain blocks at a time).
This program is the operational glue a deployment needs around it:

- N inputs (2-channel WAV files, raw IQ files and/or synthesized passes)
  demodulated concurrently, one lock-gated .s writer per stream (the
  reference's ring semantics, io/writer.py);
- periodic and signal-triggered checkpointing (save_serving_checkpoint) and
  --resume, which seeks every input to the checkpoint's chain index, so that
  demodulation continues bit-identically. Writer ring state rides in a side
  <checkpoint>.writers.npz and the .s files are truncated back to the
  checkpointed byte counts on resume, so the restarted host's byte stream is
  exactly the uninterrupted one;
- hosts of both packages resume each other's checkpoints (the layouts of the
  checkpoint and of its side file are the JAX package's): a stream the JAX
  host had parked goes back onto its lane at load, and the symbols it
  deferred are written into its .s before its next rows and before each
  save, as the JAX host writes them. --band and --park-after-s are the JAX
  host's flags, recorded in the checkpoint so that a JAX host resuming it
  bands and parks as it would have; every lane runs on the card here, so
  neither changes this host's output.

Tail of a stream: a final chain that the input fills only in part is padded
with the format's zero level and demodulated whole, and an input that ends
exactly on a chain boundary is found to have ended only by the next read,
which gives a whole chain of the zero level. So up to one chain of
pad-derived symbols (the loops coasting on silence) follows the real tail in
that stream's .s. This is the JAX package's host's behaviour, kept: dropping
the partial chain would lose up to chain*block_len - 1 real samples, and the
CLI's exact tail (the scalar oracle over the real samples only) costs
seconds of host time per stream.

The devices are every visible CUDA card (utils.make_mesh), each group's
streams sharded over them, so --group-size must be a multiple of the card
count; METEOR_DEMOD_PLATFORM=cpu runs on the CPU (plain recurrence, seconds
per block: keep such runs small):
    METEOR_DEMOD_PLATFORM=cpu python -m meteor_demod_tpu_torch.serve_fleet \\
        --synth 8 --dead 1 --seconds 1 --group-size 8 --chain 2 \\
        --block-len 2048 --out-dir /tmp/fleet_out --checkpoint /tmp/fl.npz
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .config import DemodConfig
from .io.checkpoint import load_serving_checkpoint, save_serving_checkpoint
from .io.wav import decode_iq, open_input
from .io.writer import SymbolWriter
from .parallel.serving import ServingFleet
from .sim import synth_psk
from .utils import make_mesh


class _FileSource:
    """Block-aligned reads from a 2-channel WAV (sniffed) or raw IQ
    (8/16/32-bit via --bps) through io/wav.open_input, the CLI's ingest
    sniffing; zeros after EOF."""

    def __init__(self, path: str, block_len: int, samplerate: int,
                 raw_bps: int):
        self.f, info, _ = open_input(path)
        if info is not None and info.samplerate != samplerate:
            raise SystemExit(
                f"{path}: samplerate {info.samplerate} != {samplerate}")
        self.bps = info.bps if info is not None else raw_bps
        self.data_start = self.f.tell()    # after the sniffed header
        self.size = os.path.getsize(path)
        self.block_bytes = block_len * 2 * (self.bps // 8)
        self.block_len = block_len
        self.done = False
        # Raw-ingest mode (set by main() when every source shares the
        # fleet's integer format): next_block returns the file's raw (L, 2)
        # integer sample pairs, decoded on the device.
        self.raw_dtype = None
        self.raw_pad = 0

    def seek_blocks(self, n: int) -> None:
        pos = self.data_start + n * self.block_bytes
        # A seek at or past the data end means no real sample remains: mark
        # done so a resumed run cannot emit a post-EOF zero chain the
        # uninterrupted run never wrote.
        self.done = pos >= self.size
        self.f.seek(pos)

    def _empty(self) -> np.ndarray:
        if self.raw_dtype is not None:
            return np.full((self.block_len, 2), self.raw_pad, self.raw_dtype)
        return np.zeros(self.block_len, np.complex64)

    def _decode(self, raw: bytes) -> np.ndarray:
        if self.raw_dtype is not None:
            return np.frombuffer(raw, self.raw_dtype).reshape(-1, 2)
        return decode_iq(raw, self.bps)

    def next_block(self) -> np.ndarray:
        if self.done:
            return self._empty()
        raw = self.f.read(self.block_bytes)
        if len(raw) < self.block_bytes:
            # Pad the partial tail instead of dropping it (the feed is a
            # whole chain, so a dropped partial read would lose up to
            # chain*block_len - 1 real samples). Pad value: the format's
            # zero level (128 for unsigned 8-bit). See the module docstring.
            self.done = True
            pair_bytes = 2 * (self.bps // 8)
            raw = raw[:len(raw) - len(raw) % pair_bytes]
            out = self._empty()
            if raw:
                tail = self._decode(raw)
                out[:len(tail)] = tail
            return out
        return self._decode(raw)

    def close(self) -> None:
        self.f.close()


class _SynthSource:
    """A deterministic synthesized pass (or pure-noise dead antenna)."""

    def __init__(self, idx: int, cfg: DemodConfig, n_blocks: int,
                 feed_len: int, dead: bool):
        n = n_blocks * feed_len
        if dead:
            rng = np.random.default_rng(1000 + idx)
            x = (500.0 * (rng.standard_normal(n)
                          + 1j * rng.standard_normal(n))
                 ).astype(np.complex64)
        else:
            # Carriers cycle within the acquirable +-fmax band whatever the
            # fleet size (317 Hz steps folded into +-2400 Hz).
            c = -2400.0 + (317.0 * idx) % 4800.0
            x, _ = synth_psk(
                int(n * cfg.symrate / cfg.samplerate) + 64,
                cfg.samplerate, symrate=cfg.symrate, oqpsk=cfg.oqpsk,
                carrier_hz=c, amplitude=6000.0,
                snr_db=(12.0, 15.0, 18.0, 25.0)[idx % 4], seed=idx,
                carrier_ramp_hz_s=(-30.0, 0.0, 30.0)[idx % 3])
            x = x[:n]
        self.x = x
        self.block_len = feed_len
        self.pos = 0
        self.done = False

    def seek_blocks(self, n: int) -> None:
        self.pos = n * self.block_len
        self.done = self.pos + self.block_len > len(self.x)

    def next_block(self) -> np.ndarray:
        if self.pos + self.block_len > len(self.x):
            self.done = True
            return np.zeros(self.block_len, np.complex64)
        b = self.x[self.pos:self.pos + self.block_len]
        self.pos += self.block_len
        return b

    def close(self) -> None:
        pass


def _parse_args(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="meteor_demod_tpu_torch.serve_fleet",
        description=__doc__.split("\n")[0])
    ap.add_argument("--inputs", nargs="*", default=[],
                    help="2-channel WAV or raw IQ files, one per stream")
    ap.add_argument("--synth", type=int, default=0,
                    help="additionally synthesize this many streams")
    ap.add_argument("--dead", type=int, default=0,
                    help="of the synthesized streams, make this many "
                         "pure-noise dead antennas")
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="length of the synthesized streams")
    ap.add_argument("-s", "--samplerate", type=int, default=230400)
    ap.add_argument("--bps", type=int, default=16, choices=(8, 16, 32),
                    help="bits per sample for raw (non-WAV) inputs")
    ap.add_argument("--block-len", type=int, default=8192)
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--chain", type=int, default=8,
                    help="blocks per device dispatch (higher amortizes the "
                         "host round trip, lower tightens the policy and "
                         "status tick)")
    ap.add_argument("--band", type=int, default=8,
                    help="the JAX host's tau0 band, recorded in the "
                         "checkpoint for a JAX host that resumes it; this "
                         "host runs every lane on the card, so it does not "
                         "change the output")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help=".npz path; saved periodically and on SIGINT/"
                         "SIGTERM")
    ap.add_argument("--checkpoint-every", type=int, default=256,
                    help="dispatches (chains of --chain blocks) between "
                         "periodic checkpoint saves")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint (inputs are seeked to "
                         "the checkpoint's chain index; .s files appended)")
    ap.add_argument("--status-every", type=int, default=64)
    ap.add_argument("--park-after-s", type=float, default=5.0,
                    help="the JAX host's parking delay (seconds of signal a "
                         "stream may stay unlocked while peers are locked), "
                         "recorded in the checkpoint for a JAX host that "
                         "resumes it; this host runs every lane on the card "
                         "and parks none, so it does not change the output")
    ap.add_argument("--sweep-rescue", type=float, default=0.0,
                    help="seconds of unlocked signal before a stream's "
                         "sweep is kicked onto the downward escape pass "
                         "(0 = off = exact reference acquisition; see "
                         "parallel/mesh.py set_sweep_rescue)")
    ap.add_argument("--ingest", choices=("auto", "f32", "i16", "u8"),
                    default="auto",
                    help="sample upload format: i16/u8 uploads the raw "
                         "integer stream and decodes on the device (a half "
                         "or a quarter of the host->device traffic). auto "
                         "picks i16/u8 when every input file shares that "
                         "format and no synth streams are mixed in")
    ap.add_argument("--until", choices=("shortest", "longest"),
                    default="shortest",
                    help="stop when the first source ends (default; no "
                         "stream is ever fed post-EOF zeros) or when the "
                         "last does (shorter streams feed zeros and their "
                         "post-EOF rows are dropped)")
    ap.add_argument("--max-blocks", type=int, default=0,
                    help="stop after this many dispatches (chains of "
                         "--chain blocks; 0 = run to EOF); for "
                         "deterministic kill/resume validation")
    return ap.parse_args(argv)


def _park_ticks(args, cfg: DemodConfig) -> int:
    """--park-after-s in the JAX fleet's unit, policy ticks of one chain."""
    return max(1, round(args.park_after_s * cfg.samplerate
                        / (args.chain * cfg.block_len)))


def _resume(args, cfg: DemodConfig, n_streams: int, ingest: str, mesh):
    """Load --checkpoint and refuse every mismatch with this run before
    any output is touched. Returns the fleet."""
    if not (args.checkpoint and os.path.exists(args.checkpoint)):
        raise SystemExit("--resume needs an existing --checkpoint")
    fleet = load_serving_checkpoint(args.checkpoint, mesh=mesh)
    if fleet.n_streams != n_streams:
        raise SystemExit(
            f"checkpoint has {fleet.n_streams} streams, inputs give "
            f"{n_streams}")
    if fleet.group_size != args.group_size:
        raise SystemExit(
            f"checkpoint group size {fleet.group_size} != "
            f"--group-size {args.group_size}")
    if fleet.cfg != cfg:
        raise SystemExit(
            "checkpoint was saved with a different DemodConfig "
            f"({fleet.cfg}) than this run ({cfg}) — pass the "
            "matching -s/--block-len")
    if fleet.groups[0].ingest != ingest:
        raise SystemExit(
            f"checkpoint ingest {fleet.groups[0].ingest!r} != this "
            f"run's {ingest!r}; pass the matching --ingest")
    if not fleet.groups[0].packed_output:
        raise SystemExit("checkpoint fleet does not quantize on the device "
                         "(packed_output); it is not a serving host's")
    if fleet.groups[0].chain_blocks != args.chain:
        raise SystemExit(
            f"checkpoint was saved with --chain "
            f"{fleet.groups[0].chain_blocks}, this run uses "
            f"--chain {args.chain} — the chain index and input "
            "seeks are in chain units; pass the matching --chain")
    # This run's policy flags win over the checkpointed values (the band
    # stays the checkpoint's, as in the JAX host): an operator restarting
    # with --sweep-rescue expects it to apply.
    for f in fleet.groups:
        f.set_sweep_rescue(args.sweep_rescue)
        f.jax_policy["park_after"] = _park_ticks(args, cfg)
    return fleet


def _restore_writers(wpath: str, start_block: int, writers, files) -> None:
    """Reload every writer's ring from the side file and truncate the .s
    files back to the checkpointed byte counts."""
    if not os.path.exists(wpath):
        raise SystemExit(
            f"{wpath} missing: writer ring state is saved next to "
            "every checkpoint — without it a resume would duplicate "
            "or misalign output bytes. Restart without --resume to "
            "start fresh.")
    with np.load(wpath) as z:
        if int(z["block_idx"]) != start_block:
            raise SystemExit(
                f"writer state is from chain {int(z['block_idx'])} "
                f"but the fleet checkpoint is from {start_block} — "
                "the host died between the two save steps. Restart "
                "without --resume (or restore a consistent pair).")
        for i, w in enumerate(writers):
            w._ring[:] = z["rings"][i]
            w._fill = int(z["fills"][i])
            w.bytes_out = int(z["bytes_out"][i])
    # The .s files may hold bytes written after the checkpoint (chains
    # between the last save and the kill): truncate back to the recorded
    # counts so the resume appends exactly once. A file shorter than the
    # count means the out-dir does not match the checkpoint (truncate would
    # zero-fill a silent hole).
    for i, f in enumerate(files):
        have = os.fstat(f.fileno()).st_size
        if have < writers[i].bytes_out:
            raise SystemExit(
                f"{f.name}: {have} bytes on disk but the checkpoint "
                f"recorded {writers[i].bytes_out} — the output dir "
                "does not match this checkpoint")
        f.truncate(writers[i].bytes_out)
        f.seek(writers[i].bytes_out)


def _write_rows(writer: SymbolWriter, sym_i, sym_q, valid,
                locked_once) -> None:
    """Valid-gate one stream's int8 rows (already the .s byte values: a
    PackedOutput's, quantized on the device, or parked_output's of a packed
    fleet) into its lock-gated writer."""
    v = np.asarray(valid).astype(bool)
    n = int(v.sum())
    if not n:
        return
    iq = np.empty(2 * n, np.int8)
    iq[0::2] = np.asarray(sym_i)[v]
    iq[1::2] = np.asarray(sym_q)[v]
    writer.feed(iq, np.asarray(locked_once)[v].astype(np.int32))


def main(argv=None) -> int:
    args = _parse_args(argv)
    mesh = make_mesh()
    cfg = DemodConfig(samplerate=args.samplerate, block_len=args.block_len)
    feed_len = args.chain * cfg.block_len     # samples per dispatch
    n_blocks_synth = max(
        1, int(args.seconds * cfg.samplerate / feed_len))
    sources = [_FileSource(p, feed_len, cfg.samplerate, args.bps)
               for p in args.inputs]
    n_files = len(sources)
    # Synthesis is set-up, not serving; numpy releases the interpreter lock
    # in its long loops, so the passes are made on all cores.
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        sources += pool.map(
            lambda i: _SynthSource(n_files + i, cfg, n_blocks_synth,
                                   feed_len, dead=i < args.dead),
            range(args.synth))
    ingest = args.ingest
    if ingest == "auto":
        file_bps = {s.bps for s in sources if isinstance(s, _FileSource)}
        if args.synth == 0 and file_bps == {16}:
            ingest = "i16"
        elif args.synth == 0 and file_bps == {8}:
            ingest = "u8"
        else:
            ingest = "f32"
    if ingest != "f32":
        bad = [i for i, s in enumerate(sources)
               if not isinstance(s, _FileSource)
               or s.bps != (16 if ingest == "i16" else 8)]
        if bad:
            raise SystemExit(
                f"--ingest {ingest} needs every input to be a "
                f"{'16' if ingest == 'i16' else '8'}-bit file; "
                f"streams {bad} are not")
        for src in sources:
            src.raw_dtype = np.int16 if ingest == "i16" else np.uint8
            src.raw_pad = 0 if ingest == "i16" else 128
        print(f"raw {ingest} ingest: on-device decode", flush=True)
    n_streams = len(sources)
    if n_streams == 0 or n_streams % args.group_size != 0:
        raise SystemExit(
            f"{n_streams} streams; need a nonzero multiple of "
            f"--group-size {args.group_size}")

    start_block = 0
    if args.resume:
        fleet = _resume(args, cfg, n_streams, ingest, mesh)
        start_block = fleet.groups[0]._block_idx
        for s in sources:
            s.seek_blocks(start_block)
        print(f"resumed at chain {start_block}", flush=True)
    else:
        fleet = ServingFleet(cfg, n_streams, group_size=args.group_size,
                             mesh=mesh, sweep_rescue_s=args.sweep_rescue,
                             chain_blocks=args.chain, ingest=ingest,
                             packed_output=True)
        fleet.band = args.band
        for f in fleet.groups:
            f.jax_policy["park_after"] = _park_ticks(args, cfg)
    print(f"serving {n_streams} streams on {', '.join(map(str, mesh))}",
          flush=True)

    os.makedirs(args.out_dir, exist_ok=True)
    mode = "ab" if args.resume else "wb"
    files = [open(os.path.join(args.out_dir, f"stream{i:03d}.s"), mode)
             for i in range(n_streams)]
    writers = [SymbolWriter(f) for f in files]
    if args.resume:
        _restore_writers(args.checkpoint + ".writers.npz", start_block,
                         writers, files)

    stop = {"now": False}

    def _sig(_signo, _frame):
        stop["now"] = True

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)

    def _drain_stream(i: int) -> None:
        """Write stream i's deferred rows (those of a stream a loaded JAX
        checkpoint had parked) into its writer."""
        rows = fleet.parked_output(i)
        _write_rows(writers[i], rows["sym_re"], rows["sym_im"],
                    rows["valid"], rows["locked_once"])

    def _save() -> None:
        if not args.checkpoint:
            return
        for i in range(n_streams):
            _drain_stream(i)          # deferred rows go to disk, not .npz
        for f in files:
            f.flush()
        # Writer ring state rides in a side file so a resumed host
        # continues the byte stream exactly (flushing partial rings
        # mid-run would break the reference's ring cadence and emit
        # pre-lock bytes; the reference flushes only at EOF).
        tmp = args.checkpoint + ".tmp.npz"
        save_serving_checkpoint(tmp, fleet)
        os.replace(tmp, args.checkpoint)
        # block_idx ties the two files together: resume refuses a pair
        # split by a crash between the replaces (loud error, never a
        # silent byte hole).
        wtmp = args.checkpoint + ".writers.tmp.npz"
        np.savez(wtmp,
                 block_idx=np.int64(fleet.groups[0]._block_idx),
                 rings=np.stack([w._ring for w in writers]),
                 fills=np.array([w._fill for w in writers]),
                 bytes_out=np.array([w.bytes_out for w in writers]))
        os.replace(wtmp, args.checkpoint + ".writers.npz")
        print(f"checkpoint saved at chain {fleet.groups[0]._block_idx}",
              flush=True)

    t0 = time.time()
    blocks = 0
    batch = None      # the chain's input, one buffer reused (268 MB at 256)
    # True while a chain's rows are being written: an exception there leaves
    # a torn state (some writers have the chain, others do not), so the exit
    # save must not checkpoint it — the last periodic checkpoint stays the
    # consistent resume point.
    mid_chain = False
    try:
        while not stop["now"]:
            if args.max_blocks and blocks >= args.max_blocks:
                break
            if args.until == "shortest" and any(s.done for s in sources):
                break
            if all(s.done for s in sources):
                break
            # A source that already hit EOF feeds zeros this chain (the
            # fleet shape is static); its rows are post-signal garbage
            # (locked_once stays set, so the lock gate would pass them):
            # drop them. The real tail is written in the chain where done
            # first flips (was_done still False there).
            was_done = [s.done for s in sources]
            feed = [s.next_block() for s in sources]
            if batch is None:
                batch = np.empty((n_streams,) + feed[0].shape, feed[0].dtype)
            np.stack(feed, out=batch)
            mid_chain = True
            outs = fleet.process_blocks(batch)
            for i in range(n_streams):
                _drain_stream(i)
                if not was_done[i]:
                    _write_rows(writers[i], outs.sym_i[i], outs.sym_q[i],
                                outs.valid[i], outs.locked_once[i])
            mid_chain = False
            blocks += 1
            if args.checkpoint and blocks % args.checkpoint_every == 0:
                _save()
            if blocks % args.status_every == 0:
                locked = sum(int(f.telemetry["locked_streams"])
                             for f in fleet.groups)
                rate = (blocks * feed_len * n_streams
                        / max(time.time() - t0, 1e-9) / 1e6)
                print(f"chain {start_block + blocks}: locked {locked}/"
                      f"{n_streams}, {rate:.1f} Msamp/s", flush=True)
    finally:
        if mid_chain:
            print("aborted mid-chain: keeping the last periodic "
                  "checkpoint (a save now would record a torn state)",
                  flush=True)
        else:
            _save()
        for i in range(n_streams):
            _drain_stream(i)
        for w in writers:
            w.flush_partial()
        for f in files:
            f.close()
        for s in sources:
            s.close()
        secs = max(time.time() - t0, 1e-9)
        total = sum(w.bytes_out for w in writers)
        recovered = sum(f.recovered_streams for f in fleet.groups)
        print(f"{start_block + blocks} chains served, {total} soft bytes "
              f"across {n_streams} streams, {recovered} stream spans "
              f"recovered by the host oracle, "
              f"{blocks * feed_len * n_streams / secs / 1e6:.1f} Msamp/s "
              f"over {secs:.2f} s of serving", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
