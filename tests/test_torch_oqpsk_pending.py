"""The OQPSK `pending=` stitch of demod/turbo.py end to end on the CPU.

_assemble_oqpsk_gauge(pending=) appends the pending half-value of the carry
a recording ends with. Under an odd last gauge a carry with slot == 2 holds a
fired half-value that sits on a gauge-0 Q instant: the half that completes
the sequential stream's last symbol. Without it the turbo output is one
symbol short (a reference-side defect, ROADMAP list C).

The fixture was found by a search over seeds and lengths: seed 33 at 120 Hz,
18 dB (tests/test_torch_turbo_oqpsk.py's recording, gauges [0 2 1 1]) cut to
4 lanes x 8 blocks of 2048 samples plus a 237-sample tail, which ends in
slot 2 under the last lane's gauge 1. demod_array_turbo(strict=True) must
give the sequential demod_array's symbol count, locked_once and component
signs on every symbol, and the same assembly without `pending` must come
out exactly one symbol short.
"""

import numpy as np

from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod import turbo
from meteor_demod_tpu_torch.demod.pipeline import demod_array
from meteor_demod_tpu_torch.sim import synth_psk

L, CHUNKS, KB, TAIL = 2048, 4, 8, 237
CFG = DemodConfig(samplerate=230400, symrate=80000.0, oqpsk=True,
                  block_len=L)


def test_pending_stitch_matches_sequential(monkeypatch):
    n = CHUNKS * KB * L + TAIL
    x, _ = synth_psk(int(n * CFG.symrate / CFG.samplerate) + 64,
                     CFG.samplerate, symrate=CFG.symrate, oqpsk=True,
                     carrier_hz=120.0, amplitude=6000.0, snr_db=18.0,
                     seed=33)
    x = x[:n]
    calls = []
    real = turbo._assemble_oqpsk_gauge

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(turbo, "_assemble_oqpsk_gauge", spy)
    res = turbo.demod_array_turbo(CFG, x, chunks=CHUNKS, device="cpu",
                                  strict=True)
    assert res.converged and not res.fell_back, res.max_residual
    (args, kw), = calls
    K, pending = args[4], kw["pending"]
    assert int(K[-1]) % 2 == 1, K                 # an odd last gauge
    assert int(pending[0]) == 2, pending          # ending in slot 2

    seq = demod_array(CFG, x, "cpu")
    got = res.symbols
    assert len(got) == len(seq)
    np.testing.assert_array_equal(got["locked_once"], seq["locked_once"])
    for k in ("re", "im"):
        bad = np.nonzero(np.sign(got[k]) != np.sign(seq[k]))[0]
        assert len(bad) == 0, (k, len(bad), bad[:1])
    # The stitch is load-bearing here: without it one symbol is missing.
    without = real(*args, **dict(kw, pending=None))
    assert len(without) == len(seq) - 1
