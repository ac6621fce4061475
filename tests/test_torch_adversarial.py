"""The inputs of tests/test_adversarial.py through the port's stream driver
on the CPU: a full-scale 16-bit cold start, signal onset after 5 blocks of
silence and a symbol clock 1.5 x 2**-12 fast.

On the TPU these drive the candidate window to its edge; the JAX driver
flags the onset block and splices the oracle in. The port reads every fired
tick directly and has no window to miss, so every block must come from the
device path (no block replayed) and be bitwise the port's oracle run block
by block on the port's FIR output: symbols and the final carry. Fed the
same, the JAX package's oracle is bitwise the port's; on its own FIR its
decisions are the port's (tests/torch_oracle_checks.py). These inputs drive the
gate's O(1) estimate and its min(rem, K) non-fire step hardest; the kernel
holds them against the plain recurrence on the card in
tests/test_torch_kernel_card.py.
"""

import pytest

import torch_adversarial_inputs as adv
import torch_oracle_checks as chk


@pytest.mark.parametrize("name", list(adv.INPUTS))
def test_stream_driver_is_the_oracle_bitwise(name):
    cfg = adv.CFG
    x = adv.INPUTS[name](cfg)
    assert len(x) % cfg.block_len == 0
    mine, theirs = chk.both_oracles(cfg, x)
    got = chk.check_stream(cfg, x, mine, theirs)
    if name == "max_timing_skew":
        # Locked, with the timing frequency pinned at the clamp.
        _, st = mine.all()
        assert got["locked_once"][-1] == 1
        t_max = float(cfg.timing_freq) + float(cfg.timing_dev_max)
        assert abs(float(st["t_freq"]) - t_max) < 1e-6, (st["t_freq"], t_max)
    if name == "onset_after_silence":
        # The silent blocks emit symbols too; the tone's take the AGC's
        # boosted gain without a replay.
        assert len(got) > 0.95 * len(x) / cfg.osf
