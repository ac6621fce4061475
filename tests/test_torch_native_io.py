"""The port's native I/O (meteor_demod_tpu_torch/io/native.py: the C++
decoder and quantizer of native/meteor_io.cc, compiled into the package's
_build/) against numpy, bitwise; the cases of tests/test_native_io.py plus a
property of the quantizer, its edges, empty inputs and the wiring into
io/wav.py decode_iq and demod/pipeline.py quantize_symbols."""

import os
import stat
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import example, given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from meteor_demod_tpu_torch.demod.pipeline import quantize, quantize_symbols
from meteor_demod_tpu_torch.io import native, wav
from meteor_demod_tpu_torch import sharedlib
from meteor_demod_tpu_torch.sim import encode_iq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SYM = [("re", np.float32), ("im", np.float32), ("locked_once", np.int32)]


@pytest.fixture
def lib():
    """The library; skip only where no C++ compiler exists (as the module
    then runs numpy)."""
    if native.find_cxx() is None:
        pytest.skip("no C++ compiler: the numpy paths run")
    assert native.available()


def _numpy_decode(raw: bytes, bps: int) -> np.ndarray:
    if bps == 8:
        a = np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128
    elif bps == 16:
        a = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    else:
        a = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    return (a[0:len(a) // 2 * 2:2] + 1j * a[1:len(a) // 2 * 2:2]
            ).astype(np.complex64)


def _numpy_quantize(re, im) -> np.ndarray:
    want = np.empty(2 * len(re), dtype=np.int8)
    want[0::2] = np.trunc(np.clip(re * np.float32(0.5), -127, 127)
                          ).astype(np.int8)
    want[1::2] = np.trunc(np.clip(im * np.float32(0.5), -127, 127)
                          ).astype(np.int8)
    return want


@pytest.mark.parametrize("bps", [8, 16, 32])
def test_native_decode_matches_numpy(lib, bps):
    rng = np.random.default_rng(1)
    x = ((rng.standard_normal(5001) + 1j * rng.standard_normal(5001))
         * (90 if bps == 8 else 6000)).astype(np.complex64)
    raw = encode_iq(x, bps)
    pairs = native.decode_iq_f32(raw, bps)
    assert pairs.dtype == np.float32 and pairs.shape == (5001, 2)
    got = pairs.view(np.complex64).reshape(len(pairs))
    np.testing.assert_array_equal(got, _numpy_decode(raw, bps))
    # decode_iq takes the native path and gives the same samples.
    np.testing.assert_array_equal(wav.decode_iq(raw, bps), got)


def test_native_decode_drops_partial_sample(lib):
    raw = bytes(range(10))      # 2.5 16-bit samples
    assert len(native.decode_iq_f32(raw, 16)) == 2
    assert len(native.decode_iq_f32(raw[:9], 8)) == 4
    np.testing.assert_array_equal(wav.decode_iq(raw, 16),
                                  _numpy_decode(raw, 16))


def test_native_quantize_matches_numpy(lib):
    rng = np.random.default_rng(2)
    re = (rng.standard_normal(4096) * 200).astype(np.float32)
    im = (rng.standard_normal(4096) * 200).astype(np.float32)
    np.testing.assert_array_equal(native.quantize_soft(re, im),
                                  _numpy_quantize(re, im))


_EDGES = [127.5, -127.5, 0.5, -0.5, -0.0, 1e30, -1e30, 254.0, -254.0,
          255.99998, -255.99998, 1.9999999, -1.9999999]


@settings(max_examples=200, deadline=None)
@given(hnp.arrays(np.float32, st.integers(0, 64),
                  elements=st.one_of(st.sampled_from(_EDGES),
                                     st.floats(width=32, allow_nan=False,
                                               allow_infinity=False))))
@example(np.array(_EDGES, np.float32))
@example(np.zeros(0, np.float32))
def test_quantize_soft_property(re):
    """Any finite float32 components, the clamp and truncation edges and
    empty input: the C++ bytes are numpy's, and quantize_symbols (on a
    strided symbol array) gives them too."""
    if native.find_cxx() is None:
        pytest.skip("no C++ compiler")
    im = re[::-1].copy()
    want = _numpy_quantize(re, im)
    np.testing.assert_array_equal(native.quantize_soft(re, im), want)
    sym = np.zeros(len(re), dtype=_SYM)
    sym["re"], sym["im"] = re, im
    got = quantize_symbols(sym)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0::2], quantize(re).astype(np.int8))


@pytest.mark.parametrize("bps", [8, 16, 32])
def test_empty_and_odd_lengths_behave_like_numpy(lib, bps, monkeypatch):
    """Zero-length and odd-length inputs: the native and numpy paths of
    decode_iq agree, and a length numpy cannot view raises on both."""
    width = bps // 8
    for n in (0, 1, width, 2 * width, 2 * width + 1, 3 * width, 8 * width):
        raw = bytes((7 * i) % 256 for i in range(n))
        monkeypatch.setattr(native, "decode_iq_f32", lambda r, b: None)
        try:
            want = wav.decode_iq(raw, bps)
        except ValueError:
            want = None
        monkeypatch.undo()
        if want is None:
            with pytest.raises(ValueError):
                wav.decode_iq(raw, bps)
            continue
        got = wav.decode_iq(raw, bps)
        assert got.dtype == np.complex64
        np.testing.assert_array_equal(got, want)
    assert len(native.quantize_soft(np.zeros(0, np.float32),
                                    np.zeros(0, np.float32))) == 0
    assert len(quantize_symbols(np.zeros(0, dtype=_SYM))) == 0


def test_library_is_built_into_the_package(lib):
    """From native/meteor_io.cc into meteor_demod_tpu_torch/_build/, keyed
    by the source and the flags; never native/libmeteor_io.so, and without
    -march=native."""
    path = native.library_path()
    assert path.parent == sharedlib.BUILD_DIR
    assert path.parent == Path(REPO) / "meteor_demod_tpu_torch" / "_build"
    assert path.exists() and path.name.startswith("libmeteor_io_")
    assert native.SOURCE == Path(REPO) / "native" / "meteor_io.cc"
    assert "-march=native" not in native.CXX_FLAGS
    # The library the module loaded is that one (another module of this
    # process may have loaded native/libmeteor_io.so: the JAX package does).
    assert native._library()._name == str(path)
    with open(f"/proc/{os.getpid()}/maps") as f:
        assert str(path) in f.read()


def test_no_compiler_falls_back_to_numpy(monkeypatch):
    monkeypatch.setattr(native, "find_cxx", lambda: None)
    native._library.cache_clear()
    try:
        assert not native.available()
        assert native.decode_iq_f32(b"\x00" * 8, 16) is None
        assert native.quantize_soft(np.ones(2, np.float32),
                                    np.ones(2, np.float32)) is None
        raw = encode_iq(np.arange(6, dtype=np.complex64) * (3 - 2j), 16)
        np.testing.assert_array_equal(wav.decode_iq(raw, 16),
                                      _numpy_decode(raw, 16))
        sym = np.zeros(3, dtype=_SYM)
        sym["re"], sym["im"] = [300.0, -3.0, 1.5], [-0.5, 254.0, -1e30]
        np.testing.assert_array_equal(
            quantize_symbols(sym), _numpy_quantize(sym["re"], sym["im"]))
    finally:
        native._library.cache_clear()


def test_failing_compiler_raises_with_its_output(monkeypatch, tmp_path):
    """A compiler that is present but fails raises with its output and
    leaves no library: no silent numpy fallback."""
    cxx = tmp_path / "g++"
    cxx.write_text("#!/bin/sh\necho 'meteor_io.cc:1: error: broken' >&2\n"
                   "exit 1\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="error: broken"):
            native.available()
        assert os.listdir(tmp_path / "build") == []
    finally:
        native._library.cache_clear()


def test_new_modules_import_without_jax():
    """io.native, soak and scaling import with jax and the JAX package
    blocked, and pull neither in."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['meteor_demod_tpu'] = None\n"
        "import meteor_demod_tpu_torch.io.native\n"
        "import meteor_demod_tpu_torch.soak\n"
        "import meteor_demod_tpu_torch.scaling\n"
        "bad = [m for m in sys.modules if m.startswith(('jax.', 'jaxlib', "
        "'meteor_demod_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
