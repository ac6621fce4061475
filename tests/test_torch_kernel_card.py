"""The CUDA recurrence kernels (meteor_demod_tpu_torch/csrc/block_demod.cu:
QPSK and OQPSK) against their plain torch versions, and the contracts of
their wrappers and build.

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
                                                        block_demod_oqpsk,
                                                        block_demod_torch)
from meteor_demod_tpu_torch.sim import synth_psk

import torch_adversarial_inputs as adv

L = 1024
CFG = DemodConfig(samplerate=230400, block_len=L)
OQ_CFG = DemodConfig(samplerate=230400, symrate=80000.0, oqpsk=True,
                     block_len=L)
_OUT = ("sym_re", "sym_im", "valid", "locked_once")
# The other BASELINE.json configurations: hi-fi (a larger K), PLL bandwidth
# 0.5 and 2, and a 1 kHz carrier deviation limit (CLI -d 1k).
VARIANTS = {
    "hifi": dict(rrc_order=64, interp=10),
    "pll_bw_0.5": dict(pll_bw=0.5),
    "pll_bw_2": dict(pll_bw=2.0),
    "freq_max_1k": dict(freq_max=1000.0),
}


def variant_cfg(mode: str, name: str) -> DemodConfig:
    """The variant `name` of the QPSK (72 ksym/s) or OQPSK (80 ksym/s)
    config; freq_max is given in Hz and converted as the CLI does."""
    symrate = 80000.0 if mode == "oqpsk" else 72000.0
    kw = dict(VARIANTS[name])
    if "freq_max" in kw:
        kw["freq_max"] = kw["freq_max"] * 2 * np.pi / symrate
    return DemodConfig(samplerate=230400, symrate=symrate,
                       oqpsk=mode == "oqpsk", block_len=L, **kw)


@pytest.fixture
def cuda_device():
    """The CUDA card; decided here, when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


def _iq(batch: int, n: int, cfg: DemodConfig = CFG) -> np.ndarray:
    """(batch, n, 2) float32: (O)QPSK streams at cfg's symbol rate with
    carriers 60..+, SNR 15-24 dB and DC offsets; the last stream is noise
    only."""
    xs = [synth_psk(int(n * cfg.symrate / 230400) + 64, 230400,
                    symrate=cfg.symrate, oqpsk=cfg.oqpsk,
                    carrier_hz=60.0 + 7 * b, amplitude=6000.0,
                    snr_db=15.0 + b % 10, seed=b % 16,
                    dc_offset=20 - 5j)[0][:n] for b in range(batch)]
    rng = np.random.default_rng(batch)
    xs[-1] = (1500 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
              ).astype(np.complex64)
    return iq_to_f32(np.stack(xs))


def _host(carry, out) -> tuple[dict, dict]:
    return carry_to_numpy(carry), {k: getattr(out, k).cpu().numpy()
                                   for k in _OUT}


# Stream counts that take every path of the kernels' tick staging: one stream
# (31 lanes only copy), 4-byte pieces (3, 33, 130), 16-byte pieces (4, 256),
# a ragged last warp (3, 4, 33, 130) and whole warps (256); 105 is the lane
# count turbo's -T 0 gives a 120 s recording (4-byte pieces, ragged warp).
BATCHES = [1, 3, 4, 33, 105, 130, 256]


@pytest.mark.gpu
@pytest.mark.parametrize("batch", BATCHES)
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


def _kernel_vs_plain(cfg, x, n_blocks, carry=None, min_valid=0.9):
    """n_blocks chained blocks of x on the card, kernel and plain each
    carrying their own carry (from `carry`, else the initial one): every
    output and carry leaf bitwise, one launch per block on cfg's kernel and
    none on the other. Returns the entry slots and the kernel's outputs of
    each block."""
    dev = x.device
    banks = torch.as_tensor(make_fir_banks(cfg), device=dev)
    B = x.shape[0]
    kc = pc = batch_carry(cfg, B, dev) if carry is None else carry
    tail = kc.fir_tail
    mine, other = ((block_demod_oqpsk, block_demod) if cfg.oqpsk
                   else (block_demod, block_demod_oqpsk))
    seen = []
    for i in range(n_blocks):
        Ft, tail = polyphase_fir_block(
            x[:, i * cfg.block_len:(i + 1) * cfg.block_len], tail, banks)
        before = (mine.launches, other.launches)
        slot_in = kc.slot.cpu().numpy()
        kc, ko = block_demod(cfg, kc, Ft)
        assert (mine.launches, other.launches) == (before[0] + 1, before[1])
        pc, po = block_demod_torch(cfg, pc, Ft)
        (kcn, kon), (pcn, pon) = _host(kc, ko), _host(pc, po)
        rows = cfg.steps_per_block + (1 if cfg.oqpsk else 0)
        assert kon["valid"].shape == (B, rows)
        assert kon["valid"].sum() > min_valid * B * cfg.block_len * (
            cfg.symrate / 230400)
        for k in _OUT:
            np.testing.assert_array_equal(kon[k], pon[k], err_msg=k)
        for k in kcn:
            np.testing.assert_array_equal(kcn[k], pcn[k], err_msg=k)
        seen.append((slot_in, kon))
    return seen


@pytest.mark.gpu
@pytest.mark.parametrize("batch", BATCHES)
def test_oqpsk_kernel_matches_plain_bitwise(cuda_device, batch):
    """OQPSK: two chained blocks, every output row (the pre-fire's row 0
    included) and carry leaf bitwise; one launch of the OQPSK kernel per
    block. From 130 streams on the pre-fire runs: some stream enters block
    1 with a split symbol, and its row 0 holds a symbol."""
    x = torch.tensor(_iq(batch, 2 * L, OQ_CFG), device=cuda_device)
    seen = _kernel_vs_plain(OQ_CFG, x, 2)
    if batch >= 130:
        slot_in, out = seen[1]
        assert (slot_in == 2).any()
        np.testing.assert_array_equal(out["valid"][:, 0],
                                      (slot_in == 2).astype(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["qpsk", "oqpsk"])
def test_three_chained_blocks_with_pre_fire(cuda_device, mode):
    """Three chained blocks at 130 streams; for OQPSK the pre-fire (which
    reads its tick before the first step) runs at the entry of block 1 or
    block 2, wherever a stream enters with a split symbol."""
    cfg = OQ_CFG if mode == "oqpsk" else CFG
    x = torch.tensor(_iq(130, 3 * L, cfg), device=cuda_device)
    seen = _kernel_vs_plain(cfg, x, 3)
    if cfg.oqpsk:
        assert any((slot_in == 2).any() for slot_in, _ in seen)
        for slot_in, out in seen:
            np.testing.assert_array_equal(out["valid"][:, 0],
                                          (slot_in == 2).astype(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(adv.INPUTS))
def test_adversarial_inputs_kernel_matches_plain_bitwise(cuda_device, name):
    """The inputs of tests/test_torch_adversarial.py (a full-scale 16-bit
    cold start, onset after 5 blocks of silence, a symbol clock 1.5 x
    2**-12 fast), one stream through every block: they drive the gate's
    O(1) estimate and its min(rem, K) non-fire step hardest. Every output
    and carry leaf bitwise."""
    cfg = adv.CFG
    x = adv.INPUTS[name](cfg)
    _kernel_vs_plain(cfg, torch.tensor(iq_to_f32(x)[None], device=cuda_device),
                     len(x) // cfg.block_len)


def _crafted(cfg, batch, dev, **leaves):
    """The initial carry with the first streams' leaves replaced."""
    carry = batch_carry(cfg, batch, dev)
    for k, vals in leaves.items():
        leaf = getattr(carry, k).clone()
        leaf[:len(vals)] = torch.tensor(vals, dtype=leaf.dtype, device=dev)
        setattr(carry, k, leaf)
    return carry


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["qpsk", "oqpsk"])
def test_stream_outside_the_staged_span(cuda_device, mode):
    """Streams whose timing phase starts far ahead of or behind the others
    consume ticks out of step with their warp, so fired ticks fall outside
    the span the warp has staged and are read from global memory; the
    result is the plain version's all the same."""
    cfg = OQ_CFG if mode == "oqpsk" else CFG
    x = torch.tensor(_iq(36, 2 * L, cfg), device=cuda_device)
    for phase in ([0.0, 200.0], [0.0, 0.0, -300.0], [150.0] * 33):
        carry = _crafted(cfg, 36, cuda_device, t_phase=phase)
        _kernel_vs_plain(cfg, x, 2, carry, min_valid=0.8)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["qpsk", "oqpsk"])
def test_timing_frequency_outside_the_clamp(cuda_device, mode):
    """A crafted carry whose timing frequency is outside t_center*(1 +-
    2**-12), zero, negative or NaN: the O(1) gate's estimate proves
    nothing there and the kernel runs the serial search; bitwise equal to
    the plain version (NaN leaves included)."""
    cfg = OQ_CFG if mode == "oqpsk" else CFG
    tc = float(cfg.timing_freq)
    x = torch.tensor(_iq(8, 2 * L, cfg), device=cuda_device)
    carry = _crafted(cfg, 8, cuda_device, t_freq=[
        tc * 1.3, tc * 0.6, 0.0, -tc, float("nan"), tc * 3])
    _kernel_vs_plain(cfg, x, 2, carry, min_valid=0.2)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("mode", ["qpsk", "oqpsk"])
def test_config_variants_kernel_matches_plain_bitwise(cuda_device, mode,
                                                      name):
    cfg = variant_cfg(mode, name)
    x = torch.tensor(_iq(6, 2 * L, cfg), device=cuda_device)
    _kernel_vs_plain(cfg, x, 2)


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
def test_backend_auto_launches_oqpsk_kernel_on_card(cuda_device):
    """make_batch_demod on the card picks the OQPSK kernel for an OQPSK
    config; backend='torch' launches nothing and agrees bitwise."""
    x = torch.tensor(_iq(4, L, OQ_CFG), device=cuda_device)
    before = (block_demod.launches, block_demod_oqpsk.launches)
    kc, ko = make_batch_demod(OQ_CFG, 4, cuda_device)(
        batch_carry(OQ_CFG, 4, cuda_device), x)
    assert (block_demod.launches, block_demod_oqpsk.launches) == (
        before[0], before[1] + 1)
    pc, po = make_batch_demod(OQ_CFG, 4, cuda_device, backend="torch")(
        batch_carry(OQ_CFG, 4, cuda_device), x)
    assert block_demod_oqpsk.launches == before[1] + 1
    (kcn, kon), (pcn, pon) = _host(kc, ko), _host(pc, po)
    for k in _OUT:
        np.testing.assert_array_equal(kon[k], pon[k], err_msg=k)
    for k in kcn:
        np.testing.assert_array_equal(kcn[k], pcn[k], err_msg=k)


@pytest.mark.gpu
def test_oqpsk_stream_demodulator_card_matches_cpu(cuda_device):
    """OQPSK StreamDemodulator on the card against the CPU's: same symbols
    and lock history; values within the FIR's float32 rounding."""
    x = _iq(1, 12 * L + 777, OQ_CFG)[0].view(np.complex64)[:, 0]
    ref = StreamDemodulator(OQ_CFG, "cpu")
    want = np.concatenate([ref.process(x), ref.finish()])
    before = block_demod_oqpsk.launches
    d = StreamDemodulator(OQ_CFG, cuda_device)
    got = np.concatenate([d.process(x), d.finish()])
    assert block_demod_oqpsk.launches - before >= 12
    assert d.fallback_blocks == 0 and len(got) == len(want)
    np.testing.assert_array_equal(got["locked_once"], want["locked_once"])
    np.testing.assert_allclose(got["re"], want["re"], rtol=5e-4, atol=0.05)
    np.testing.assert_allclose(got["im"], want["im"], rtol=5e-4, atol=0.05)
    assert d.pll_locked == ref.pll_locked


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
    # OQPSK selects the plain recurrence on the CPU (no launch; (1, S+1)
    # rows) and the OQPSK kernel on the card
    # (test_backend_auto_launches_oqpsk_kernel_on_card).
    before = (block_demod.launches, block_demod_oqpsk.launches)
    _, out = make_batch_demod(OQ_CFG, 1, "cpu")(
        batch_carry(OQ_CFG, 1, "cpu"), torch.zeros((1, L, 2)))
    assert out.valid.shape == (1, OQ_CFG.steps_per_block + 1)
    assert (block_demod.launches, block_demod_oqpsk.launches) == before
    with pytest.raises(ValueError, match="no block_demod kernel"):
        block_demod(OQ_CFG, batch_carry(OQ_CFG, 2, "meta"),
                    torch.empty((OQ_CFG.block_ticks, 2, 2), device="meta"))


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


# ---------------------------------------------------------- the fleet driver

@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [CFG, OQ_CFG], ids=["qpsk", "oqpsk"])
def test_fleet_driver_card_matches_cpu_decisions(cuda_device, cfg):
    """FleetDemodulator on the card (chained, raw i16 ingest) against the
    same fleet on the CPU: one kernel launch per block, decisions bitwise,
    values within the FIRs' difference (cuDNN against the CPU convolution)."""
    from meteor_demod_tpu_torch.parallel.mesh import FleetDemodulator
    kernel = block_demod_oqpsk if cfg.oqpsk else block_demod
    B, K, n_chains = 8, 3, 4
    raw = np.round(_iq(B, n_chains * K * L, cfg)).astype(np.int16)
    card = FleetDemodulator(cfg, B, cuda_device, chain_blocks=K, ingest="i16")
    host = FleetDemodulator(cfg, B, "cpu", chain_blocks=K, ingest="i16")
    before = kernel.launches
    for c in range(n_chains):
        span = np.ascontiguousarray(raw[:, c * K * L:(c + 1) * K * L])
        got, want = card.process_blocks(span), host.process_blocks(span)
        np.testing.assert_array_equal(got.valid, want.valid)
        np.testing.assert_array_equal(got.locked_once, want.locked_once)
        v = want.valid.astype(bool)
        np.testing.assert_allclose(got.sym_re[v], want.sym_re[v], rtol=5e-4,
                                   atol=0.05)
        np.testing.assert_allclose(got.sym_im[v], want.sym_im[v], rtol=5e-4,
                                   atol=0.05)
        assert card.telemetry["symbols"] == host.telemetry["symbols"]
        assert card.telemetry["locked_streams"] == host.telemetry[
            "locked_streams"]
    assert kernel.launches - before == n_chains * K
    assert card.recovered_streams == host.recovered_streams == 0
    a, b = carry_to_numpy(card.carry), carry_to_numpy(host.carry)
    for k in ("locked", "locked_once", "flags", "slot", "tick"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.gpu
def test_packed_output_on_card_matches_host_quantizer(cuda_device):
    """The device quantizer's int8 rows equal, bitwise, quantize_symbols on
    the float rows of the same fleet run unpacked on the card, through a
    forced flag's oracle recovery too; and on edge values the card's
    quantize equals numpy's."""
    from meteor_demod_tpu_torch.demod.pipeline import (quantize,
                                                       quantize_symbols)
    from meteor_demod_tpu_torch.parallel.mesh import FleetDemodulator
    B, K = 8, 2
    x = _iq(B, 2 * K * L)
    plain = FleetDemodulator(CFG, B, cuda_device, chain_blocks=K)
    packed = FleetDemodulator(CFG, B, cuda_device, chain_blocks=K,
                              packed_output=True)
    for c in range(2):
        if c == 1:
            for f in (plain, packed):
                f.carry.flags[3] |= 2
        span = x[:, c * K * L:(c + 1) * K * L]
        a, b = plain.process_blocks(span), packed.process_blocks(span)
        np.testing.assert_array_equal(b.valid, a.valid)
        np.testing.assert_array_equal(b.locked_once, a.locked_once)
        for s in range(B):
            v = a.valid[s].astype(bool)
            sym = np.zeros(int(v.sum()), dtype=[("re", np.float32),
                                                ("im", np.float32),
                                                ("locked_once", np.int32)])
            sym["re"], sym["im"] = a.sym_re[s][v], a.sym_im[s][v]
            want = quantize_symbols(sym)
            np.testing.assert_array_equal(b.sym_i[s][v], want[0::2])
            np.testing.assert_array_equal(b.sym_q[s][v], want[1::2])
    assert packed.recovered_streams == plain.recovered_streams == 1
    edge = np.float32([254.0, 253.99, 254.01, -254.0, -255.5, 1.999, -1.999,
                       0.0, -0.0, 300.0, -300.0, 1e30, np.inf, -np.inf,
                       1e-40, np.nan])
    with np.errstate(invalid="ignore"):
        got = quantize(torch.tensor(edge, device=cuda_device))
        np.testing.assert_array_equal(got.cpu().numpy(), quantize(edge))
        np.testing.assert_array_equal(
            got.to(torch.int8).cpu().numpy()[:-1],
            quantize(edge).astype(np.int8)[:-1])


# -------------------------------------------------------------------- turbo

@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [CFG, OQ_CFG], ids=["qpsk", "oqpsk"])
def test_turbo_on_card_equals_sequential_decisions(cuda_device, cfg):
    """demod_array_turbo on the card (7 lanes x 24 blocks and a tail, its
    passes launching the mode's kernel with B = 7) against demod_array on the
    card: converged with no fallback, the same symbol count, locked_once and
    the sign of every component. Then a span from the stream's carry
    mid-way: all lanes verified for QPSK, and the soft bytes' signs those of
    the sequential symbols."""
    from meteor_demod_tpu_torch.demod.pipeline import demod_array, quantize
    from meteor_demod_tpu_torch.demod.turbo import (demod_array_turbo,
                                                    demod_span_turbo)
    kernel = block_demod_oqpsk if cfg.oqpsk else block_demod
    lanes, kb = 7, 24
    n = lanes * kb * L + 3000
    x = synth_psk(int(n * cfg.symrate / 230400) + 64, 230400,
                  symrate=cfg.symrate, oqpsk=cfg.oqpsk, carrier_hz=150.0,
                  amplitude=6000.0, snr_db=18.0, seed=31)[0][:n]
    seq = demod_array(cfg, x, cuda_device)
    before = kernel.launches
    res = demod_array_turbo(cfg, x, chunks=lanes, device=cuda_device,
                            strict=True)
    assert kernel.launches - before >= 12 + 2 * kb
    assert res.converged and res.passes <= 4 and not res.fell_back
    assert len(res.symbols) == len(seq)
    np.testing.assert_array_equal(res.symbols["locked_once"],
                                  seq["locked_once"])
    for k in ("re", "im"):
        np.testing.assert_array_equal(np.sign(res.symbols[k]),
                                      np.sign(seq[k]))

    head = 2 * kb * L
    d = StreamDemodulator(cfg, cuda_device)
    first = [d.process(x[:head])]
    d.sync()
    first += d._backlog
    n_head = sum(len(p) for p in first)
    carry0 = {k: v[0] for k, v in carry_to_numpy(d._carry).items()}
    span = demod_span_turbo(cfg, carry0, iq_to_f32(x[head:head + 4 * kb * L]),
                            chunks=4, device=cuda_device)
    assert span.verified_lanes >= (1 if cfg.oqpsk else 4)
    want = seq[n_head:n_head + len(span.symbols)]
    np.testing.assert_array_equal(span.symbols["locked_once"],
                                  want["locked_once"])
    for k in ("re", "im"):
        np.testing.assert_array_equal(np.sign(quantize(span.symbols[k])),
                                      np.sign(quantize(want[k])))


# ------------------------------------------------------ shards on one card

@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [CFG, OQ_CFG], ids=["qpsk", "oqpsk"])
def test_shards_sharing_a_card_equal_one_device(cuda_device, cfg):
    """FleetDemodulator over 2 and 4 shards on one card against the fleet
    on the card alone: every chain's outputs, the carry and the integer
    telemetry bitwise, through a flag forced into one shard and recovered
    there. Then demod_array_turbo's lanes over 2 shards against one device,
    bitwise."""
    from meteor_demod_tpu_torch.demod.turbo import demod_array_turbo
    from meteor_demod_tpu_torch.parallel.mesh import FleetDemodulator
    B, K, n_chains, flagged = 8, 3, 4, 5
    raw = np.round(_iq(B, n_chains * K * L, cfg)).astype(np.int16)
    dev = torch.device("cuda", torch.cuda.current_device())
    fleets = [FleetDemodulator(cfg, B, dev, chain_blocks=K, ingest="i16",
                               packed_output=True)]
    fleets += [FleetDemodulator(cfg, B, mesh=[dev] * n, chain_blocks=K,
                                ingest="i16", packed_output=True)
               for n in (2, 4)]
    for c in range(n_chains):
        if c == 2:
            for f in fleets:
                per = f._shards.per
                f._carries[flagged // per].flags[flagged % per] |= 2
        span = raw[:, c * K * L:(c + 1) * K * L]
        one, *sharded = [f.process_blocks(span) for f in fleets]
        for n, got in zip((2, 4), sharded):
            for k in ("sym_i", "sym_q", "valid", "locked_once"):
                np.testing.assert_array_equal(
                    getattr(got, k), getattr(one, k),
                    err_msg=f"{n} shards, chain {c}, {k}")
    want = carry_to_numpy(fleets[0].carry)
    for f in fleets[1:]:
        assert f.recovered_streams == fleets[0].recovered_streams == 1
        got = carry_to_numpy(f.carry)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k, v in fleets[0].telemetry.items():
            if k != "mean_agc_gain":
                assert f.telemetry[k] == v, k

    lanes, kb = 8, 24
    n = lanes * kb * L + 3000
    x = synth_psk(int(n * cfg.symrate / 230400) + 64, 230400,
                  symrate=cfg.symrate, oqpsk=cfg.oqpsk, carrier_hz=150.0,
                  amplitude=6000.0, snr_db=18.0, seed=31)[0][:n]
    one = demod_array_turbo(cfg, x, chunks=lanes, device=dev, strict=True)
    two = demod_array_turbo(cfg, x, chunks=lanes, mesh=[dev] * 2,
                            strict=True)
    assert two.passes == one.passes
    np.testing.assert_array_equal(two.gauges, one.gauges)
    for k in ("re", "im", "locked_once"):
        np.testing.assert_array_equal(two.symbols[k], one.symbols[k],
                                      err_msg=k)
