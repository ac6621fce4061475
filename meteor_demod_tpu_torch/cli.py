"""Command-line frontend with the reference's exact flag surface.

Replicates main.c's getopt_long interface and semantics (main.c:19,35-51,
82-198): same short/long options, human_to_float suffix parsing, `--stdout`
implying batch+quiet, stdin forcing batch mode, WAV-header autodetection with
raw fallback, default LRPT_<datetime>.s output name, and the batch status
line format (main.c:247-263). Unknown `-m` values silently keep QPSK
(main.c:103-105).

The worker/UI split (worker pthread main.c:218 + status loop main.c:221-267)
maps to a Python worker thread running the block demodulator while the main
thread prints status. The demodulator runs on the CUDA card;
METEOR_DEMOD_PLATFORM=cpu runs it on the CPU instead. Without a card and
without that setting the CLI raises: it never falls back to the CPU.

--checkpoint <file> resumes from <file> when it exists and saves the state
there at the end, so split captures demodulate as one continuous stream.

-T/--turbo <chunks> demodulates one recording across the block demodulator's
lanes (demod/turbo.py): a file whole (0 picks the lane count), stdin span by
span. Without -B the curses TUI (ui/tui.py) draws the run.
METEOR_DEMOD_PROFILE=<dir> writes a torch.profiler trace of the run there
(profiling.py).
"""

from __future__ import annotations

import getopt
import os
import sys
import threading

import numpy as np

from . import __version__
from .config import DemodConfig
from .demod.pipeline import StreamDemodulator, quantize_symbols
from .io.checkpoint import load_checkpoint, save_checkpoint
from .io.wav import FILE_BUFFER_SIZE, decode_iq, open_input, read_sample_blocks
from .io.writer import SymbolWriter
from .profiling import call, counters, maybe_trace, span
from .utils import gen_fname, human_to_float, make_mesh, select_device

# -T 0 fills at most this many lanes of a launch per device, each lane with
# at least TURBO_MIN_BLOCKS blocks so that the gauge warmup can mature
# (turbo.default_warmup_blocks targets 65536 samples).
TURBO_MAX_LANES = 128
TURBO_MIN_BLOCKS = 32

SHORTOPTS = "Bb:d:f:hm:o:O:qR:r:s:S:T:v"
LONGOPTS = [
    "batch", "pll-bw=", "freq-delta=", "fir-order=", "help", "mode=",
    "output=", "oversamp=", "quiet", "refresh-rate=", "symrate=", "stdout",
    "samplerate=", "bps=", "version", "turbo=", "checkpoint=",
    "sweep-rescue=",
]

USAGE = """Usage: {pname} [options] file_in
   -B, --batch             Disable TUI and all control characters (aka "script-friendly mode")
   -m, --mode <mode>       Specify the signal modulation scheme (default: qpsk, valid modes: qpsk, oqpsk)
   -o, --output <file>     Output decoded symbols to <file>
   -q, --quiet             Do not print status information
   -r, --symrate <rate>    Set the symbol rate to <rate> (default: 72000)
   -R, --refresh-rate <ms> Refresh the status screen every <ms> ms (default: 50ms in TUI mode, 2000ms in batch mode)
   -s, --samplerate <samp> Force the input samplerate to <samp> (default: auto)
       --bps <bps>         Force the input bits per sample to <bps> (default: 16)
       --stdout            Write output symbols to stdout (implies -B, -q)

   -h, --help              Print this help screen
   -v, --version           Print version info

Advanced options:
   -b, --pll-bw <bw>       Set the PLL bandwidth to <bw> (default: 1)
   -d, --freq-delta <freq> Set the maximum carrier deviation to <freq> (default: +-3.5kHz)
   -f, --fir-order <ord>   Set the RRC filter order to <ord> (default: 32)
   -O, --oversamp <mult>   Set the interpolation factor to <mult> (default: 5)

Extensions (not in the reference):
   -T, --turbo <chunks>    Demodulate one recording chunk-parallel across
                           <chunks> lanes of the card (0 = pick the count
                           from the file's length); on stdin, span by span
                           (nothing is written until a span of
                           <chunks> x 16 x 8192 samples has buffered)
       --checkpoint <file> Resume from <file> if it exists and save the
                           demodulator state there at the end: captures
                           split over several runs demodulate as one
                           continuous stream
       --sweep-rescue <s>  Escape the acquisition sweep's dead zone: after
                           <s> seconds of unlocked signal, restart the
                           sweep from +fmax downward (a full downward
                           pass captures every in-range carrier; the
                           reference's upward-first sweep measurably
                           stalls near small negative offsets and never
                           locks — pll.c:109-130). 0 (default) disables
                           the kick for exact reference acquisition
                           behavior

Device: the CUDA card; METEOR_DEMOD_PLATFORM=cpu runs on the CPU.
"""


def usage(pname: str) -> None:
    sys.stderr.write(USAGE.format(pname=pname))


def _atoi(s: str) -> int:
    """C atoi: parse leading integer, 0 on failure."""
    s = s.strip()
    out = ""
    for i, ch in enumerate(s):
        if ch.isdigit() or (ch in "+-" and i == 0):
            out += ch
        else:
            break
    try:
        return int(out)
    except ValueError:
        return 0


class Options:
    def __init__(self):
        self.pll_bw = 1.0
        self.rrc_order = 32
        self.interp_factor = 5
        self.quiet = False
        self.symrate = 72000.0
        self.freq_max_delta = -1.0
        self.oqpsk = False
        self.batch = False
        self.update_interval = -1
        self.bps = 0
        self.samplerate = -1
        self.stdout_mode = False
        self.output_fname = None
        self.input_path = None
        self.turbo_chunks: int | None = None     # None = off, 0 = auto
        self.checkpoint_path: str | None = None
        self.sweep_rescue_s = 0.0                # 0 = off (ref parity)


def parse_args(argv: list[str]) -> Options | int:
    """Returns Options, or an int exit code for -h/-v/errors."""
    pname = argv[0] if argv else "meteor_demod"
    opts = Options()
    try:
        parsed, rest = getopt.getopt(argv[1:], SHORTOPTS, LONGOPTS)
    except getopt.GetoptError:
        usage(pname)
        return 1
    for flag, val in parsed:
        if flag == "--stdout":
            opts.stdout_mode = True
        elif flag in ("-b", "--pll-bw"):
            opts.pll_bw = human_to_float(val)
        elif flag in ("-B", "--batch"):
            opts.batch = True
        elif flag in ("-d", "--freq-delta"):
            opts.freq_max_delta = human_to_float(val)
        elif flag in ("-f", "--fir-order"):
            opts.rrc_order = _atoi(val)
        elif flag in ("-h", "--help"):
            usage(pname)
            return 0
        elif flag in ("-m", "--mode"):
            if val == "oqpsk":           # anything else keeps QPSK
                opts.oqpsk = True
        elif flag in ("-o", "--output"):
            opts.output_fname = val
        elif flag in ("-O", "--oversamp"):
            opts.interp_factor = _atoi(val)
        elif flag in ("-q", "--quiet"):
            opts.quiet = True
        elif flag in ("-R", "--refresh-rate"):
            opts.update_interval = _atoi(val)
        elif flag in ("-r", "--symrate"):
            opts.symrate = human_to_float(val)
        elif flag in ("-s", "--samplerate"):
            opts.samplerate = int(human_to_float(val))
        elif flag in ("-S", "--bps"):
            opts.bps = _atoi(val)
        elif flag in ("-T", "--turbo"):
            opts.turbo_chunks = _atoi(val)
        elif flag == "--checkpoint":
            opts.checkpoint_path = val
        elif flag == "--sweep-rescue":
            opts.sweep_rescue_s = human_to_float(val)
        elif flag in ("-v", "--version"):
            sys.stderr.write(f"meteor_demod_tpu_torch v{__version__}\n")
            return 0

    # Hz -> rad/symbol (main.c:136); negative keeps the pll default. A zero
    # symrate is caught later by DemodConfig.validate with a clean error.
    if opts.symrate > 0:
        opts.freq_max_delta = opts.freq_max_delta * 2 * np.pi / opts.symrate

    if not rest:
        usage(pname)
        return 1
    opts.input_path = rest[0]

    if opts.output_fname is None:
        opts.output_fname = gen_fname()
    if opts.update_interval < 0:
        opts.update_interval = 2000 if opts.batch else 50
    if opts.stdout_mode:
        opts.batch = True
        opts.quiet = True
    return opts


class DemodRunner:
    """Worker-side demod loop (thread_process, main.c:284-329). An exception
    in the worker is kept in `error` and re-raised by main()."""

    def __init__(self, opts: Options, demod: StreamDemodulator,
                 samples_file, soft_file, bps: int, file_len: int):
        self.opts = opts
        self.demod = demod
        self.samples_file = samples_file
        self.writer = SymbolWriter(soft_file)
        self.bps = bps
        self.file_len = file_len
        self.bytes_read = 0
        self.error: BaseException | None = None
        self.done = threading.Event()
        self.stop = threading.Event()

    def run(self) -> None:
        # File input: accumulate chunks up to one chained-dispatch span so
        # StreamDemodulator's multi-block fast path engages. Live stdin keeps
        # per-chunk delivery (the reference's own buffering is one 32 KiB
        # read, ~36 ms).
        if self.opts.input_path == "-":
            span = 1
        else:
            span = self.demod.cfg.block_len * self.demod.chain_blocks
        buf = []
        buffered = 0
        try:
            for chunk in read_sample_blocks(self.samples_file, self.bps):
                if self.stop.is_set():
                    break
                self.bytes_read += len(chunk) * 2 * self.bps // 8
                buf.append(chunk)
                buffered += len(chunk)
                if buffered >= span:
                    self._emit(self.demod.process(np.concatenate(buf)))
                    buf, buffered = [], 0
            if buf:
                self._emit(self.demod.process(np.concatenate(buf)))
            self._emit(self.demod.finish())
            self.writer.flush_partial()
        except Exception as e:          # re-raised on the main thread
            self.error = e
        finally:
            self.done.set()

    def _emit(self, symbols: np.ndarray) -> None:
        if len(symbols):
            self.writer.feed(quantize_symbols(symbols),
                             symbols["locked_once"])

    # -- status values (main.c:231-232, 250-258) ----------------------------
    def progress_pct(self) -> float:
        if not self.file_len:
            return 0.0
        return 100.0 * self.bytes_read / self.file_len

    def status_tuple(self):
        d = self.demod
        return (self.progress_pct(), d.carrier_freq_hz(), d.symbol_rate_hz(),
                d.pll_locked)


def main(argv: list[str] | None = None) -> int:
    """One run of the CLI: its exit code. The run is the span cli.main, and
    its changes of the profiling counters are kept in
    profiling.calls("cli.main")."""
    with call("cli.main"):
        return _main(argv)


def _main(argv: list[str] | None) -> int:
    argv = list(sys.argv) if argv is None else argv
    opts = parse_args(argv)
    if isinstance(opts, int):
        return opts
    device = select_device()

    try:
        samples_file, info, is_stdin = open_input(opts.input_path)
    except OSError:
        sys.stderr.write("Could not open input file\n")
        return 1
    if is_stdin:
        opts.batch = True                      # main.c:155-157
    samplerate, bps = opts.samplerate, opts.bps
    if info is not None:
        samplerate, bps = info.samplerate, info.bps
    if samplerate < 0:
        sys.stderr.write("Could not auto-detect sample rate. "
                         "Please specify it with -s <samplerate>\n")
        usage(argv[0])
        return 1
    if not bps:
        sys.stderr.write("Could not auto-detect bits per sample, "
                         "assuming 16\n")
        bps = 16

    if opts.stdout_mode:
        soft_file = sys.stdout.buffer
    else:
        try:
            soft_file = open(opts.output_fname, "wb")
        except OSError:
            sys.stderr.write("Could not open output file\n")
            return 1

    cfg = DemodConfig(
        samplerate=samplerate, symrate=opts.symrate,
        interp=opts.interp_factor, rrc_order=opts.rrc_order,
        pll_bw=opts.pll_bw, oqpsk=opts.oqpsk,
        freq_max=opts.freq_max_delta)
    try:
        cfg.validate()
    except ValueError as e:
        sys.stderr.write(f"Invalid configuration: {e}\n")
        return 1

    if opts.sweep_rescue_s > 0 and opts.turbo_chunks is not None:
        sys.stderr.write("--sweep-rescue is ignored with -T/--turbo (the "
                         "turbo paths run whole spans; acquisition kicks "
                         "apply to the sequential/live path only)\n")
    if opts.checkpoint_path is not None and opts.turbo_chunks is not None:
        sys.stderr.write("--checkpoint cannot be combined with -T/--turbo "
                         "(the turbo path is whole-file)\n")
        return 1

    if opts.turbo_chunks is not None and not is_stdin:
        with maybe_trace():
            return _run_turbo(opts, cfg, samples_file, soft_file, bps)

    # stdin + -T: the whole file is never in hand, so apply the turbo
    # machinery to buffered SPANS instead (turbo.span_submit): live/piped
    # inputs that burst ahead of real time are demodulated chunk-parallel,
    # with the sequential path as the verified-prefix fallback.
    span_turbo = opts.turbo_chunks is not None
    demod = StreamDemodulator(
        cfg, device, sweep_rescue_s=opts.sweep_rescue_s,
        span_turbo=span_turbo,
        span_chunks=max(2, opts.turbo_chunks or 32) if span_turbo else 32)
    if opts.checkpoint_path is not None and os.path.exists(
            opts.checkpoint_path):
        resumed = load_checkpoint(opts.checkpoint_path, device)
        if resumed.cfg != cfg:
            sys.stderr.write(
                f"checkpoint {opts.checkpoint_path} was written with a "
                f"different configuration; refusing to resume\n")
            return 1
        demod = resumed
        # The loader builds a default StreamDemodulator; re-apply the
        # run's policy flags (the carry and counters stay as saved).
        demod.sweep_rescue_s = float(opts.sweep_rescue_s)
        if not opts.quiet:
            print(f"Resumed from {opts.checkpoint_path} "
                  f"({demod.symbols_out} symbols so far)",
                  file=sys.stderr if opts.stdout_mode else sys.stdout)

    # File length probe (main.c:190-193).
    file_len = 0
    if not is_stdin:
        try:
            pos = samples_file.tell()
            samples_file.seek(0, 2)
            file_len = max(0, samples_file.tell() - pos)
            samples_file.seek(pos)
        except OSError:
            file_len = 0

    runner = DemodRunner(opts, demod, samples_file, soft_file, bps, file_len)

    if not opts.quiet:
        print(f"Input: {opts.input_path}, output: "
              f"{'stdout' if opts.stdout_mode else opts.output_fname}",
              file=sys.stderr if opts.stdout_mode else sys.stdout)

    def traced_run():
        # On the worker's own thread: torch.profiler records the CPU side
        # of the thread it was started on only (the card's side whole).
        with maybe_trace():
            runner.run()

    worker = threading.Thread(target=traced_run, daemon=True)
    worker.start()
    try:
        if not opts.batch:
            from .ui.tui import run_tui
            run_tui(runner, opts.update_interval)
        elif not opts.quiet:
            _batch_status_loop(runner, opts)
        else:
            runner.done.wait()
    except KeyboardInterrupt:
        pass
    finally:
        # Signal the worker on every exit path, so join() never waits on a
        # worker that is still streaming.
        runner.stop.set()
        worker.join()

    if not opts.stdout_mode:
        soft_file.close()
    if not is_stdin:
        samples_file.close()
    if runner.error is not None:
        raise runner.error
    if opts.checkpoint_path is not None:
        save_checkpoint(opts.checkpoint_path, demod)
        if not opts.quiet:
            print(f"Checkpoint saved to {opts.checkpoint_path}",
                  file=sys.stderr if opts.stdout_mode else sys.stdout)
    return 0


def turbo_lanes(n_samples: int, block_len: int, n_dev: int = 1) -> int:
    """-T 0: fill the lanes of a launch on each of n_dev devices, but keep
    each lane's chunk at TURBO_MIN_BLOCKS blocks or more; short recordings
    get fewer, longer chunks. A count of at least n_dev snaps down to a
    multiple of n_dev, so that the lanes shard over the devices."""
    chunks = int(np.clip(n_samples // (TURBO_MIN_BLOCKS * block_len),
                         1, TURBO_MAX_LANES * n_dev))
    if chunks >= n_dev:
        chunks -= chunks % n_dev
    return chunks


def _run_turbo(opts: Options, cfg: DemodConfig, samples_file, soft_file,
               bps: int) -> int:
    """Offline chunk-parallel demodulation of the whole file (-T <chunks>).

    Reads all samples, runs demod_array_turbo across the batch lanes of
    every visible card (the lanes sharded over the cards when there are
    several, mesh="auto"), and writes the usual lock-gated int8 soft-symbol
    stream (one device, the CPU, under METEOR_DEMOD_PLATFORM=cpu)."""
    from .demod.turbo import demod_array_turbo

    with span("cli.read"):
        raw = samples_file.read()
        # Reference ingest parity (wav_read reads full 32 KiB buffers and
        # discards a short trailing read, wavfile.c:50-80): -T must
        # demodulate exactly the bytes the batch path consumes, or the two
        # modes emit different symbol streams for the same file.
        raw = raw[:len(raw) - len(raw) % FILE_BUFFER_SIZE]
    with span("cli.decode"):
        x = decode_iq(raw, bps)
    chunks = opts.turbo_chunks or turbo_lanes(len(x), cfg.block_len,
                                              len(make_mesh()))
    info = sys.stderr if opts.stdout_mode else sys.stdout
    if not opts.quiet:
        print(f"Turbo: {len(x)} samples across {chunks} lanes", file=info)
    seq0 = counters().get("turbo.sequential_samples", 0)
    res = demod_array_turbo(cfg, x, chunks=chunks, mesh="auto", strict=True)
    seq = counters().get("turbo.sequential_samples", 0) - seq0
    with span("cli.quantize"):
        soft = quantize_symbols(res.symbols)
    with span("cli.write"):
        w = SymbolWriter(soft_file)
        w.feed(soft, res.symbols["locked_once"])
        w.flush_partial()
        if not opts.stdout_mode:
            soft_file.close()
    samples_file.close()
    if not opts.quiet:
        # The samples demodulated on the sequential path: the unverified
        # suffix of a fixpoint that did not converge (or the whole
        # recording), and the tail after the last whole chunk.
        print(f"Turbo: {len(res.symbols)} symbols, passes={res.passes}, "
              f"converged={res.converged}, sequential={seq} samples "
              f"(fallback {res.fallback_samples}, tail "
              f"{seq - res.fallback_samples})", file=info)
    return 0


def _batch_status_loop(runner: DemodRunner, opts: Options) -> None:
    """Periodic status line (main.c:247-263)."""
    interval = opts.update_interval / 1000.0
    while not runner.done.is_set():
        pct, freq_hz, rate_hz, locked = runner.status_tuple()
        sys.stdout.write(
            f"\n({pct:5.1f}%) Carrier: {freq_hz:+7.1f} Hz, "
            f"Symbol rate: {rate_hz:.1f} Hz, "
            f"Locked: {'Yes' if locked else 'No'}")
        sys.stdout.flush()
        runner.done.wait(interval)
    sys.stdout.write("\n")
