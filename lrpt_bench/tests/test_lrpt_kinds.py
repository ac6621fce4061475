"""A cell of a new driver kind is taken from new files and new
BENCHMARK.json entries alone.

A copy of the harness gains a stub kind: a driver module with its NUMBERS,
SMALL and CONTROL, a traffic mix, a per-layer reader and a test of its
own, and BENCHMARK.json gains a cell of it that reports
fleet_msamples_per_s, as a serving host's would. No file of the copy is
edited. The copy's own contract tests, small_run, run.execute (--trace 0
and 1) and the control test's plan and readings then take the cell, and
its traced run reads its own per-layer metric and none of the fleet
driver's. Here, each accepted cell reads the per-layer metrics it read
before the metrics gained their lists of cells.
"""

import json
import os
import shutil
import subprocess
import sys

from lrpt_bench import run as R

BENCH = json.loads((R.ROOT / "BENCHMARK.json").read_text())
STUB = "qpsk72k.stub"

DRIVER = '''"""A stub kind: matrix products on the run's device."""
import time

import torch

from ..trace import span

SPAN = "product"
NUMBERS = ("off",)
SMALL = dict(size=16)
CONTROL = dict(window_s=0.2, seeds=(2, 1, 1))


def setup(run):
    n = int(run.mix["size"])
    gen = torch.Generator(device=run.device)
    gen.manual_seed(run.seed)
    return dict(a=torch.randn(n, n, generator=gen, device=run.device))


def window(run, st):
    calls, t0 = 0, time.perf_counter()
    while True:
        with span(SPAN):
            out = st["a"] @ st["a"]
        st.setdefault("out", out)
        calls += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    return dict(wall_s=time.perf_counter() - t0, attempted=calls, failed=0)


def end_to_end(run, st, w):
    n = st["a"].numel() * w["attempted"]
    return {"fleet_msamples_per_s": n / w["wall_s"] / 1e6}


def release(st):
    st["a"], st["out"] = st["a"].cpu(), st["out"].cpu()


def check(run, st):
    a = st["a"].double()
    off = float((st["out"].double() - a @ a).abs().max())
    return {"numbers": {"off": (off, run.limit("off"))},
            "detail": dict(window_s=run.seconds)}
'''

READER = '''"""Products in the stub's traced window."""


def read(ctx):
    return float(len(ctx["calls"])) or None
'''

STUB_TEST = '''"""The stub cell through the harness's own entry points."""
import torch

import test_lrpt_control as C
from small import execute, small_run

CELL = "qpsk72k.stub"


def test_small_run_and_execute_take_the_stub(capsys):
    run = small_run(CELL, 5)
    assert run.mix["size"] == 16 and run.mix["kind"] == "stub"
    res = execute(run, capsys)
    assert res["correct"], res
    assert set(res["metrics"]) == {"fleet_msamples_per_s", "setup_s"}
    assert set(res["checks"]) == {"off"}
    res = execute(small_run(CELL, 5, trace=True), capsys)
    assert res["correct"], res
    assert set(res["metrics"]) == {"stub.products"}


def test_the_control_test_takes_the_stub(monkeypatch):
    assert CELL in C.CELLS
    plan = C.plan(CELL)
    assert [fir for _, fir in plan] == [None, None, "reordered", "tf32"]
    for fits in (C._fits, lambda st: 1):     # checked in workers, and here
        monkeypatch.setattr(C, "_fits", fits)
        res = C.readings(CELL, torch.device("cpu"), plan, workers=2)
        assert [(s, f) for s, f, _, _ in res] == plan
        for _, _, numbers, detail in res:
            assert set(numbers) == {"off"} and detail["window_s"] == 0.2
'''


def _stub_copy(root):
    """The harness and BENCHMARK.json copied under root, with the stub
    kind's new files and entries."""
    shutil.copytree(R.HERE, root / "lrpt_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = {"drivers/stub.py": DRIVER,
           "layer_metrics/stub.products.py": READER,
           "tests/test_lrpt_stub.py": STUB_TEST,
           "traffic/stubmix.json": json.dumps(
               {"kind": "stub", "size": 256, "limits": {"off": 1e-3}})}
    for path, text in new.items():
        assert not (root / "lrpt_bench" / path).exists(), path
        (root / "lrpt_bench" / path).write_text(text)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(
        name=STUB, config="qpsk72k", traffic="stubmix", chips=1,
        why="a stub kind that reports the fleet's rate"))
    next(m for m in bench["end_to_end"]
         if m["name"] == "fleet_msamples_per_s")["workloads"].append(STUB)
    bench["per_layer"].append(dict(
        name="stub.products", unit="products", better="higher",
        source="program_span", layer="stub", moves="fleet_msamples_per_s",
        workloads=[STUB]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))


def test_a_new_kind_needs_no_edit_of_the_harness(tmp_path):
    _stub_copy(tmp_path)
    tests = tmp_path / "lrpt_bench" / "tests"
    env = dict(os.environ, METEOR_DEMOD_PLATFORM="cpu",
               PYTHONPATH=os.pathsep.join([str(tmp_path), str(R.ROOT)]))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly",
         str(tests / "test_lrpt_contract.py"),
         str(tests / "test_lrpt_stub.py")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert " failed" not in out.stdout and " passed" in out.stdout


def test_per_layer_reads_only_the_cells_a_metric_lists():
    bench = json.loads(json.dumps(BENCH))
    m = next(m for m in bench["per_layer"] if m["name"] == "fleet.fir_ms")
    m["workloads"] = ["qpsk72k.fleet128"]
    names = lambda cell: [m["name"] for m in
                          R.Run(bench, cell, 1, 1.0, False, None).per_layer()]
    assert "fleet.fir_ms" in names("qpsk72k.fleet128")
    assert "fleet.fir_ms" not in names("oqpsk80k.fleet128")


def test_each_accepted_cell_reads_the_metrics_it_read_before():
    """Before the lists, a cell read every per-layer metric whose `moves`
    it reports."""
    counts = {"qpsk72k.fleet128": 12, "oqpsk80k.fleet128": 12,
              "qpsk72k.pass10min": 14, "oqpsk80k.pass10min": 14}
    for cell, n in counts.items():
        run = R.Run(BENCH, cell, 1, 1.0, False, None)
        e2e = set(run.end_to_end_names())
        before = [m["name"] for m in BENCH["per_layer"] if m["moves"] in e2e]
        assert [m["name"] for m in run.per_layer()] == before
        assert len(before) == n
