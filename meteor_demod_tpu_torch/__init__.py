"""meteor_demod_tpu_torch — the LRPT (Meteor-M2) demodulator in PyTorch + CUDA.

The port of meteor_demod_tpu (JAX on a TPU) to PyTorch on an NVIDIA Hopper
card. The same coherent QPSK receive chain (RRC matched filter -> AGC ->
Costas carrier PLL -> Mueller & Muller symbol timing -> lock-gated int8 soft
symbols), with the per-symbol recurrence as a hand-written CUDA kernel
(csrc/block_demod.cu) beside its plain torch version. Module names follow
the JAX package's, so each module's counterpart is easy to find. This
package never imports jax or meteor_demod_tpu.
"""

__version__ = "0.1.0"

from .config import DemodConfig
from .constants import SYM_RATE, RRC_ALPHA, RRC_ORDER, INTERP_FACTOR, PLL_BW, SYM_BW
from .demod.pipeline import StreamDemodulator, demod_array, quantize_symbols

__all__ = [
    "DemodConfig", "StreamDemodulator", "demod_array", "quantize_symbols",
    "SYM_RATE", "RRC_ALPHA", "RRC_ORDER", "INTERP_FACTOR", "PLL_BW", "SYM_BW",
]
