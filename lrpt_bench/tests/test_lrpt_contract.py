"""BENCHMARK.json against the contract: every cell's files are found, and
every name and unit is in the allowed characters."""

import json
import re

import pytest

from lrpt_bench import run as R

BENCH = json.loads((R.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_files():
    for w in BENCH["workloads"]:
        run = R.Run(BENCH, w["name"], 1, 1.0, False, None)
        assert run.cfg["name"] == w["config"]
        driver = run.driver()
        assert set(run.mix["limits"]) == set(driver.NUMBERS)
        small = driver.SMALL.get("limits", run.mix["limits"])
        assert set(small) == set(driver.NUMBERS)
        assert set(driver.CONTROL) == {"window_s", "seeds"}
        assert len(driver.CONTROL["seeds"]) == 3
        for name in run.mix["limits"]:
            assert run.limit(name) >= 0        # one for this configuration
        assert run.end_to_end_names(), w["name"]
        assert "setup_s" in run.end_to_end_names()
        assert run.per_layer(), w["name"]
        for m in run.per_layer():
            assert callable(R.load_reader(m["name"]))
    for c in BENCH["configs"]:
        assert (R.ROOT / c["file"]).exists()


def test_every_reduced_key_states_its_published_value():
    """A configuration cut from its source lists each key it changed in
    `reduced`; its file holds the key and, under "published", the source's
    value of it."""
    for c in BENCH["configs"]:
        cfg = json.loads((R.ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key), key
            assert key in cfg, (c["name"], key)
            assert key in cfg.get("published", {}), (c["name"], key)


def test_kernel_map_loads():
    from lrpt_bench.trace import kernel_map, layer_of
    km = kernel_map()
    assert layer_of("(anonymous namespace)::block_demod_kernel(float)",
                    km) == "recurrence"
    assert layer_of("block_demod_oqpsk_kernel", km) == "recurrence"
    assert layer_of("void cudnn::cnn::conv2d_grouped_direct_kernel", km) \
        == "fir"
    assert layer_of("Memcpy HtoD (Pinned -> Device)", km) == "copy"


def test_names_and_units_are_in_the_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]])
    for n in names:
        assert NAME.match(n), n
    for group in (BENCH["configs"], BENCH["workloads"],
                  BENCH["end_to_end"] + BENCH["per_layer"]):
        assert len({g["name"] for g in group}) == len(group)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metric_sets_follow_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
    workloads = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
    assert all(set(m.get("workloads", [])) <= workloads
               for m in BENCH["end_to_end"])


def test_every_per_layer_metric_lists_cells_that_report_what_it_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["workloads"], m["name"]
        assert len(set(m["workloads"])) == len(m["workloads"]), m["name"]
        for cell in m["workloads"]:
            assert cell in cells, (m["name"], cell)
            assert R.reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_chain_tail_reads_the_windows_chains():
    read = R.load_reader("fleet.chain_p95_ms")
    chains = [0.040] * 95 + [0.080] * 5
    assert read({"window": {"chain_s": chains}}) == pytest.approx(42.0)
    assert read({"window": {"chain_s": []}}) is None
