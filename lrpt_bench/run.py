#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json and print its result as one JSON line.

    python3 lrpt_bench/run.py --workload <cell> --seed <n> --seconds <s>
                              --trace <0|1>

from the root of a checkout. The cell names a configuration
(configs/<config>.json) and a traffic mix (traffic/<traffic>.json), whose
"kind" names its driver (drivers/<kind>.py). Set-up builds the program and
warms every shape the window uses; the window runs for `seconds`. With
--trace 0 the result holds the cell's end-to-end metrics, with --trace 1
its per-layer metrics (those whose "workloads" list names the cell), each
read by layer_metrics/<metric>.py from a torch.profiler trace of the
window, the harness's spans and the program's counters. Then the
program's state is freed and the plain reference in reference/ checks
what the window produced: each number compared is printed beside its
limit, last on standard error and last in the result.

A run needs a CUDA card and the program (meteor_demod_tpu_torch) beside
this folder; without either it exits non-zero and prints no result.
"""

import time

T_MAIN = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "meteor_demod_tpu")


def process_start() -> float:
    """This process's start on the wall clock (Linux /proc), else the
    moment this file began to run."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        up = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return T_MAIN


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_reader(name: str):
    path = HERE / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"lrpt_bench.layer_metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


class Run:
    """What a driver is given: the cell's files and the run's arguments."""

    def __init__(self, bench: dict, cell: str, seed: int, seconds: float,
                 trace: bool, device):
        wl = {w["name"]: w for w in bench["workloads"]}
        if cell not in wl:
            raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
        self.bench, self.cell, self.workload = bench, cell, wl[cell]
        self.cfg = json.loads((HERE / "configs" /
                               f"{wl[cell]['config']}.json").read_text())
        self.mix = json.loads((HERE / "traffic" /
                               f"{wl[cell]['traffic']}.json").read_text())
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        # A stand-in for the program's matched filter through the window
        # (controls.py: "tf32", the control, or "reordered"), for the
        # readings that set the check's limit. The benchmark's runs never
        # set it.
        self.fir = None
        # Readings of the check alone may skip a pass cell's warm-up pass;
        # the benchmark's runs always warm up.
        self.warm = True

    def demod_fields(self) -> dict:
        return {k: self.cfg[k] for k in (
            "samplerate", "symrate", "interp", "rrc_order", "rrc_alpha",
            "pll_bw", "sym_bw", "oqpsk", "freq_max", "block_len")}

    def limit(self, name: str):
        """A number's limit in the mix: one for every configuration, or one
        a configuration by name."""
        lim = self.mix["limits"][name]
        return lim[self.workload["config"]] if isinstance(lim, dict) else lim

    def end_to_end_names(self) -> list:
        return [m["name"] for m in self.bench["end_to_end"]
                if reports(m, self.cell)]

    def per_layer(self) -> list:
        e2e = set(self.end_to_end_names())
        return [m for m in self.bench["per_layer"]
                if m["moves"] in e2e and reports(m, self.cell)]

    def driver(self):
        """The module drivers/<kind>.py that runs the mix's kind."""
        return importlib.import_module(
            f"lrpt_bench.drivers.{self.mix['kind']}")


def power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    t_proc = process_start()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    sys.path.insert(0, str(ROOT))

    import torch
    chips = int(next(w["chips"] for w in bench["workloads"]
                     if w["name"] == a.workload))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"lrpt_bench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if importlib.util.find_spec("meteor_demod_tpu_torch") is None:
        print("lrpt_bench: the program (meteor_demod_tpu_torch) is not in "
              "this checkout", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = Run(bench, a.workload, a.seed, a.seconds, bool(a.trace), device)
    return execute(run, t_proc)


def fir_context(run: Run):
    """The stand-in filter the run asks for, if any (controls.py)."""
    import contextlib
    if not run.fir:
        return contextlib.nullcontext()
    from lrpt_bench.controls import FIRS
    return FIRS[run.fir]()


def execute(run: Run, t_proc: float) -> int:
    import contextlib
    import gc

    import torch

    from lrpt_bench import trace as tr

    driver = run.driver()
    cuda = run.device.type == "cuda"
    st = driver.setup(run)
    if cuda:
        torch.cuda.synchronize(run.device)
    t_window = time.time()
    setup_s = t_window - t_proc
    print(f"setup_s {setup_s:.3f}", file=sys.stderr)
    with contextlib.ExitStack() as stack:
        stack.enter_context(fir_context(run))
        if run.trace:
            prof = stack.enter_context(tr.profiler())
        w = driver.window(run, st)
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    metrics, breakdown, dev_times = {}, None, None
    if run.trace:
        trace = tr.Trace(prof)
        del prof
        ctx = dict(run=run, trace=trace, window=w, state=st,
                   calls=trace.calls(driver.SPAN))
        lo, hi = ctx["calls"][0][0], ctx["calls"][-1][1]
        dev_times = dict(busy_s=trace.device_in(lo, hi), window_s=hi - lo)
        breakdown = trace.breakdown(lo, hi)
        for m in run.per_layer():
            v = load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = driver.end_to_end(run, st, w)
        e2e["setup_s"] = setup_s
        units = {m["name"]: m["unit"] for m in run.bench["end_to_end"]}
        for name in run.end_to_end_names():
            metrics[name] = {"value": float(e2e[name]), "unit": units[name]}
    driver.release(st)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        print(f"lrpt_bench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    t_check = time.time()
    chk = driver.check(run, st)
    print(f"check took {time.time() - t_check:.1f} s", file=sys.stderr)
    numbers = chk["numbers"]
    correct = (w["failed"] == 0 and w["attempted"] > 0
               and all(v <= lim for v, lim in numbers.values()))
    print(f"card: {power_limit() if cuda else 'cpu'}", file=sys.stderr)
    for name, (v, lim) in numbers.items():
        print(f"check {name} {v} limit {lim}", file=sys.stderr)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if cuda
              else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    if dev_times:
        device.update(dev_times)
    out = {"correct": bool(correct), "attempted": int(w["attempted"]),
           "failed": int(w["failed"]), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, (v, lim) in numbers.items()}
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
