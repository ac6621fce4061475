"""The port's scaling harness (meteor_demod_tpu_torch/scaling.py) in all
three modes on the CPU at a tiny size: 2048-sample blocks, 2 streams a
device (a process, a shard), 1 timed step. `overhead`'s bare step must do
the fleet's work, outputs and carry bitwise. `multiprocess` runs two real
gloo jobs over localhost, 1 process and 2, each process pinned to its own
cores; every process's last outputs and carry must be bitwise the single
process's and the job's telemetry counts twice one process's. `shards` runs
1 and 2 shards on the CPU; the first shard's rows must be bitwise the
one-device fleet's."""

import json

import pytest

from meteor_demod_tpu_torch import scaling

ARGS = ["--device", "cpu", "--spd", "2", "--block", "2048", "--steps", "1"]


def _run(capsys, mode, *extra) -> dict:
    assert scaling.main(["--mode", mode, *ARGS, *extra]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_overhead_mode(capsys):
    r = _run(capsys, "overhead")
    assert (r["mode"], r["device"], r["card"]) == ("overhead", "cpu", "cpu")
    assert (r["spd"], r["block_len"], r["steps"]) == (2, 2048, 1)
    assert r["fleet_step_ms"] > 0 and r["plain_step_ms"] > 0
    assert r["overhead_ms"] == pytest.approx(r["fleet_step_ms"]
                                             - r["plain_step_ms"])
    assert r["same_work_bitwise"] is True
    # Unclipped: a fleet step read faster than the bare one shows as such.
    assert r["efficiency_lower_bound"] == pytest.approx(
        r["plain_step_ms"] / r["fleet_step_ms"])
    assert r["overhead_fraction"] == pytest.approx(
        1 - r["efficiency_lower_bound"])
    assert 1 < r["warm_steps"] <= 65          # warmed to lock


def test_shards_mode(capsys):
    r = _run(capsys, "shards", "--devices", "1,2")
    assert r["mode"] == "shards" and [row["devices"] for row in r["rows"]] \
        == [1, 2]
    for row in r["rows"]:
        assert row["first_shard_bitwise"] is True
        assert row["shards_on"] == ["cpu"]
        assert row["streams"] == 2 * row["devices"]
        assert row["msamples_per_s"] > 0
    assert r["rows"][0]["efficiency_vs_first"] == 1.0


def test_multiprocess_mode(capsys):
    r = _run(capsys, "multiprocess")
    assert r["mode"] == "multiprocess" and r["process_devices"] == ["cpu",
                                                                     "cpu"]
    assert r["rows_bitwise_one_process"] is True and not r["shared_card"]
    assert len(r["two_process_msamples_per_s"]) == 2
    assert r["one_process_msamples_per_s"] > 0
    assert r["efficiency_2proc_vs_1proc"] == pytest.approx(
        min(r["two_process_msamples_per_s"])
        / r["one_process_msamples_per_s"])
    assert all(n >= 1 for n in r["cores_per_process"])
