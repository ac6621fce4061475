"""The CUDA recurrence kernel (meteor_demod_tpu_torch/csrc/block_demod.cu)
against its plain torch version, and the contracts of its wrapper and build.

Tests marked `gpu` need a CUDA card and nvcc, and skip without them. This
file imports neither jax nor meteor_demod_tpu, so it runs on the card's
machine (where tests/conftest.py, which imports jax, cannot load):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_card.py

Kernel vs plain is bitwise: both round every operation once, in the numpy
oracle's order.
"""

import os
import stat

import numpy as np
import pytest
import torch

from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod.backend import make_batch_demod
from meteor_demod_tpu_torch.demod.pipeline import StreamDemodulator
from meteor_demod_tpu_torch.demod.state import batch_carry, carry_to_numpy
from meteor_demod_tpu_torch.dsp.fir import (iq_to_f32, make_fir_banks,
                                            polyphase_fir_block)
from meteor_demod_tpu_torch.kernels import _build
from meteor_demod_tpu_torch.kernels.block_demod import (block_demod,
                                                        block_demod_torch)
from meteor_demod_tpu_torch.sim import synth_psk

L = 1024
CFG = DemodConfig(samplerate=230400, block_len=L)
_OUT = ("sym_re", "sym_im", "valid", "locked_once")


@pytest.fixture
def cuda_device():
    """The CUDA card; decided here, when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


def _iq(batch: int, n: int) -> np.ndarray:
    """(batch, n, 2) float32: QPSK streams with carriers 60..+, SNR 15-24
    dB and DC offsets; the last stream is noise only."""
    xs = [synth_psk(n // 3 + 64, 230400, carrier_hz=60.0 + 7 * b,
                    amplitude=6000.0, snr_db=15.0 + b % 10, seed=b % 16,
                    dc_offset=20 - 5j)[0][:n] for b in range(batch)]
    rng = np.random.default_rng(batch)
    xs[-1] = (1500 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
              ).astype(np.complex64)
    return iq_to_f32(np.stack(xs))


def _host(carry, out) -> tuple[dict, dict]:
    return carry_to_numpy(carry), {k: getattr(out, k).cpu().numpy()
                                   for k in _OUT}


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 4, 130])
def test_kernel_matches_plain_bitwise(cuda_device, batch):
    """Two chained blocks, each chain carrying its own carry: every output
    and carry leaf bitwise; one launch per block."""
    x = torch.tensor(_iq(batch, 2 * L), device=cuda_device)
    banks = torch.as_tensor(make_fir_banks(CFG), device=cuda_device)
    kc = pc = batch_carry(CFG, batch, cuda_device)
    tail = kc.fir_tail
    for i in range(2):
        Ft, tail = polyphase_fir_block(x[:, i * L:(i + 1) * L], tail, banks)
        before = block_demod.launches
        kc, ko = block_demod(CFG, kc, Ft)
        assert block_demod.launches == before + 1
        pc, po = block_demod_torch(CFG, pc, Ft)
        (kcn, kon), (pcn, pon) = _host(kc, ko), _host(pc, po)
        assert kon["valid"].sum() > 0.9 * batch * L / 3.2
        for k in _OUT:
            np.testing.assert_array_equal(kon[k], pon[k], err_msg=k)
        for k in kcn:
            np.testing.assert_array_equal(kcn[k], pcn[k], err_msg=k)


@pytest.mark.gpu
def test_backend_auto_launches_kernel_on_card(cuda_device):
    x = torch.tensor(_iq(4, L), device=cuda_device)
    before = block_demod.launches
    kc, ko = make_batch_demod(CFG, 4, cuda_device)(
        batch_carry(CFG, 4, cuda_device), x)
    assert block_demod.launches == before + 1
    pc, po = make_batch_demod(CFG, 4, cuda_device, backend="torch")(
        batch_carry(CFG, 4, cuda_device), x)
    assert block_demod.launches == before + 1
    (kcn, kon), (pcn, pon) = _host(kc, ko), _host(pc, po)
    for k in _OUT:
        np.testing.assert_array_equal(kon[k], pon[k], err_msg=k)
    for k in kcn:
        np.testing.assert_array_equal(kcn[k], pcn[k], err_msg=k)


@pytest.mark.gpu
def test_stream_demodulator_card_matches_cpu(cuda_device):
    """StreamDemodulator on the card against StreamDemodulator on the CPU:
    same symbols and lock history; values within the FIR's float32
    rounding (cuDNN and the CPU sum the 65 taps in different orders)."""
    x = _iq(1, 12 * L + 777)[0].view(np.complex64)[:, 0]
    ref = StreamDemodulator(CFG, "cpu")
    want = np.concatenate([ref.process(x), ref.finish()])
    d = StreamDemodulator(CFG, cuda_device)
    got = np.concatenate([d.process(x), d.finish()])
    assert d.fallback_blocks == 0 and len(got) == len(want)
    np.testing.assert_array_equal(got["locked_once"], want["locked_once"])
    np.testing.assert_allclose(got["re"], want["re"], rtol=5e-4, atol=0.05)
    np.testing.assert_allclose(got["im"], want["im"], rtol=5e-4, atol=0.05)
    assert d.pll_locked == ref.pll_locked


@pytest.mark.gpu
def test_wrapper_rejects_bad_inputs_on_card(cuda_device):
    carry = batch_carry(CFG, 4, cuda_device)
    Ft = torch.zeros((CFG.block_ticks, 2, 4), device=cuda_device)
    before = block_demod.launches
    with pytest.raises(ValueError, match="contiguous"):
        block_demod(CFG, carry, Ft.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="float32"):
        block_demod(CFG, carry, Ft.double())
    with pytest.raises(ValueError, match="carry leaves"):
        block_demod(CFG, batch_carry(CFG, 3, cuda_device), Ft)
    carry.locked = carry.locked.float()
    with pytest.raises(ValueError, match="carry.locked"):
        block_demod(CFG, carry, Ft)
    assert block_demod.launches == before


def test_wrapper_rejects_other_devices():
    Ft = torch.empty((CFG.block_ticks, 2, 2), device="meta")
    with pytest.raises(ValueError, match="no block_demod kernel"):
        block_demod(CFG, batch_carry(CFG, 2, "meta"), Ft)


def test_backend_selection_errors():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        make_batch_demod(CFG, 1, "cpu", backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        make_batch_demod(CFG, 1, "cpu", backend="pallas")
    oq = DemodConfig(samplerate=230400, symrate=80000.0, oqpsk=True)
    with pytest.raises(NotImplementedError):
        make_batch_demod(oq, 1, "cpu")
    Ft = torch.zeros((oq.block_ticks, 2, 1))
    with pytest.raises(NotImplementedError):
        block_demod_torch(oq, batch_carry(oq, 1), Ft)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_failed_nvcc_raises_with_its_output(monkeypatch, tmp_path):
    """A compile error surfaces nvcc's output and leaves no library."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'broken.cu(3): error: expected a ;' >&2\n"
                    "exit 2\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "broken.cu").write_text("int x\n")
    monkeypatch.setenv("PATH", str(nvcc.parent))
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="expected a ;"):
        _build.build("broken")
    assert os.listdir(tmp_path / "build") == []


def test_library_is_keyed_by_source(monkeypatch, tmp_path):
    (tmp_path / "k.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    (tmp_path / "k.cu").write_text("// two\n")
    assert _build.library_path("k") != first
    assert first.parent == _build.BUILD_DIR
