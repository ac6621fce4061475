"""The serving host moved between the two packages, on the CPU: the JAX
package's host (scripts/serve_fleet.py) stopped with its dead antenna parked
and resumed by the port's (python -m meteor_demod_tpu_torch.serve_fleet
--resume), and the other way round.

Four streams in one group, chains of 2 blocks of 1024: two 16-bit WAV passes
that lock in a few chains (120 Hz, 20 dB: the pass of the CLI tests), a dead
antenna and a synthesized pass whose carrier the sweep does not reach in the
run. --park-after-s 0.02 parks the dead antenna in the JAX host once the
passes lock. Both hosts get --band 6 and --park-after-s, the JAX host's
flags, which the port records in its checkpoint's JAX fields.

Contract, per stream, against the uninterrupted host of the package that
wrote the first part: a locked stream's .s has the uninterrupted length and
the bytes up to the cut bitwise; after the cut the other package
demodulates, and its bytes are held to the JAX host's own contract for rows
another program computed (the -T contract: mean |byte difference| < 2),
since a timing gate firing within rounding of a FIR tick can fire a tick
apart in the two packages and move a stretch of soft bytes by more than 1.
An unlocked stream writes only its end-of-run partial ring (the writer drops
pre-lock rings), whose length follows the count of pre-lock noise decisions:
held on its lock, it stays under one ring in every run.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from meteor_demod_tpu.sim import synth_psk, write_wav

from meteor_demod_tpu_torch.constants import RING_SYMBOLS
from meteor_demod_tpu_torch.io.checkpoint import jax_fields_missing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 1024
CHAINS = 12          # of the passes; the host serves 13: a source learns
SYNTH_CHAINS = 14    # that it has ended from a short read, so the passes'
                     # 13th chain is their zero level, the synth streams' not
CUT = 8
LIVE, UNLOCKED = (0, 1), (2, 3)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("migrate")
    paths = []
    for i in range(2):
        n = CHAINS * 2 * L
        x, _ = synth_psk(n // 3 + 64, 230400, carrier_hz=120.0,
                         amplitude=6000.0, snr_db=20.0, seed=4 + i)
        paths.append(str(d / f"pass{i}.wav"))
        write_wav(paths[-1], x[:n], 230400, 16)
    return paths


def _host(package, wavs, out_dir, extra):
    """One host run; its stdout. The JAX host, once it has parked a stream,
    dies in the interpreter's teardown (SIGSEGV or SIGABRT: its park
    worker's daemon thread is still inside XLA), after it has written and
    closed every .s file and printed its summary: that run counts when the
    summary line is there."""
    cmd = ([os.path.join(REPO, "scripts", "serve_fleet.py")]
           if package == "jax"
           else ["-m", "meteor_demod_tpu_torch.serve_fleet"])
    env = dict(os.environ, METEOR_DEMOD_PLATFORM="cpu", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)   # one CPU device: a group of 4 on one mesh
    proc = subprocess.run(
        [sys.executable, *cmd, "--inputs", *wavs, "--synth", "2", "--dead",
         "1", "--seconds", str(SYNTH_CHAINS * 2 * L / 230400 + 1e-6),
         "--group-size", "4", "--block-len", str(L), "--chain", "2",
         "--status-every", "1", "--park-after-s", "0.02", "--band", "6",
         "--out-dir", out_dir, *extra],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    done = "chains served" in proc.stdout.splitlines()[-1]
    assert proc.returncode == 0 or (package == "jax" and done and
                                    proc.returncode in (-11, -6)), (
        package, extra, proc.returncode, proc.stderr[-3000:])
    return proc.stdout


def _files(d):
    return [np.fromfile(os.path.join(d, f"stream{i:03d}.s"), np.int8)
            for i in range(4)]


@pytest.fixture(scope="module")
def straight(wavs, tmp_path_factory):
    """Each host straight through, and its .s files."""
    d = tmp_path_factory.mktemp("straight")
    out = {p: _host(p, wavs, str(d / p), []) for p in ("jax", "port")}
    assert "13 chains served" in out["jax"]
    return {p: _files(str(d / p)) for p in out}


def _stopped(package, wavs, d):
    """The host stopped after CUT chains with a checkpoint; its bytes per
    stream at the cut, from the writers' side file."""
    ck = os.path.join(d, "ck.npz")
    out = _host(package, wavs, os.path.join(d, "s"),
                ["--checkpoint", ck, "--max-blocks", str(CUT)])
    assert f"checkpoint saved at chain {CUT}" in out
    with np.load(ck + ".writers.npz") as z:
        side = {k: (z[k].dtype, z[k].shape) for k in z.files}
        at_cut = z["bytes_out"].copy()
    return ck, side, at_cut


def _hold(got, ref, at_cut):
    for i in LIVE:
        assert len(ref[i]) > 4 * RING_SYMBOLS, i
        assert len(got[i]) == len(ref[i]), i
        n = int(at_cut[i])
        np.testing.assert_array_equal(got[i][:n], ref[i][:n])
        diff = np.abs(got[i].astype(np.int16) - ref[i].astype(np.int16))
        assert diff.mean() < 2.0, (i, diff.mean(), diff.max())
    for i in UNLOCKED:
        assert max(len(got[i]), len(ref[i])) < 2 * RING_SYMBOLS, i


def test_jax_host_moves_to_port(wavs, straight, tmp_path):
    """A JAX host stopped with its dead antenna parked resumes on the port:
    the stream's host carry goes back onto its lane and the rest of every
    stream comes out of the port."""
    ck, side, at_cut = _stopped("jax", wavs, str(tmp_path))
    with np.load(ck) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
    assert list(meta["groups"][0]["parked"]) == ["2"]
    out = _host("port", wavs, str(tmp_path / "s"),
                ["--checkpoint", ck, "--resume"])
    assert f"resumed at chain {CUT}" in out and "13 chains served" in out
    _hold(_files(str(tmp_path / "s")), straight["jax"], at_cut)
    # The side file is now the port's (rewritten at its last save).
    with np.load(ck + ".writers.npz") as z:
        assert {k: (z[k].dtype, z[k].shape) for k in z.files} == side


def test_port_host_moves_to_jax(wavs, straight, tmp_path):
    """A port host's checkpoint carries the JAX host's --band and
    --park-after-s in its JAX fields; the JAX host resumes it, parks the
    dead antenna as it would have, and writes the rest of every stream. The
    side file the JAX host rewrites at its last save has the port's
    layout."""
    ck, side, at_cut = _stopped("port", wavs, str(tmp_path))
    assert jax_fields_missing(ck) == []
    with np.load(ck) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
    assert meta["band"] == 6 and meta["groups"][0]["parked"] == {}
    assert meta["groups"][0]["park_after"] == round(0.02 * 230400 / (2 * L))
    out = _host("jax", wavs, str(tmp_path / "s"),
                ["--checkpoint", ck, "--resume"])
    assert f"resumed at chain {CUT}" in out
    assert "chain 13: locked 2/4, parked 1" in out     # the dead antenna
    _hold(_files(str(tmp_path / "s")), straight["port"], at_cut)
    with np.load(ck + ".writers.npz") as z:
        assert {k: (z[k].dtype, z[k].shape) for k in z.files} == side
