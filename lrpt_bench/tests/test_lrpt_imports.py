"""What a run loads: nothing whose top-level name is jax, jaxlib, flax or
meteor_demod_tpu (names compared whole: meteor_demod_tpu_torch begins with
meteor_demod_tpu), and the reference loads nothing of the program."""

import json
import subprocess
import sys

from lrpt_bench import run as R

FORBIDDEN = {"jax", "jaxlib", "flax", "meteor_demod_tpu"}


def loaded_by(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=R.ROOT, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    bench = json.loads((R.ROOT / "BENCHMARK.json").read_text())
    kinds = sorted({json.loads((R.HERE / "traffic" / f"{w['traffic']}.json")
                               .read_text())["kind"]
                    for w in bench["workloads"]})
    readers = "; ".join(f"R.load_reader({m['name']!r})"
                        for m in bench["per_layer"])
    code = ("import lrpt_bench.run as R, lrpt_bench.trace\n"
            + "".join(f"import lrpt_bench.drivers.{k}\n" for k in kinds)
            + readers + "\n"
            "import meteor_demod_tpu_torch.cli, "
            "meteor_demod_tpu_torch.parallel.mesh, "
            "meteor_demod_tpu_torch.demod.turbo")
    names = loaded_by(code)
    assert "meteor_demod_tpu_torch" in names and "lrpt_bench" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = sorted(p.stem for p in (R.HERE / "reference").glob("*.py")
                  if p.stem != "__init__")
    names = loaded_by("".join(f"import lrpt_bench.reference.{m}\n"
                              for m in mods))
    assert "lrpt_bench" in names
    assert not names & (FORBIDDEN | {"meteor_demod_tpu_torch"})
