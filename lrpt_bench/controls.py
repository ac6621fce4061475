"""Stand-ins for the program's matched filter, for the readings that set the
correctness check's limit.

The configurations state float32 with TF32 off. The control (tf32_fir) puts
the matched filter in TF32 in the program's place: the samples and the taps
rounded to TF32's 10-bit mantissa (to nearest, ties to even), the products
summed in float32, as a TF32 tensor-core convolution computes them. Setting
cuDNN's own allow_tf32 is no control here: for this one-channel correlation
cuDNN picks a direct kernel that never uses TF32, and the program's output
does not move.

reordered_fir is a sound filter in the configurations' precision that sums
in another order than the program's: float32 products added tap by tap,
oldest first, as upstream's filter.c does. Its runs give lower readings
beside the program's own, so the limit admits any float32 summation order.

Each replaces the program's FIR function for the window only.
"""

from __future__ import annotations

import contextlib

import torch


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (1 sign, 8 exponent, 10 mantissa bits)."""
    i = t.contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return r.view(torch.float32)


def _tap_by_tap(x, tail, banks):
    """polyphase_fir_block's contract, summed tap by tap in float32."""
    B, L, _ = x.shape
    interp, taps = banks.shape
    xin = torch.cat([tail, x], dim=1)
    lhs = xin.permute(0, 2, 1).reshape(2 * B, 1, L + taps - 1)
    acc = torch.zeros((2 * B, interp, L), dtype=torch.float32,
                      device=x.device)
    for k in range(taps):
        acc += lhs[:, :, k:k + L] * banks[None, :, k, None]
    Ft = (acc.view(B, 2, interp, L).permute(3, 2, 1, 0)
          .reshape(L * interp, 2, B))
    return Ft, xin[:, L:].contiguous()


@contextlib.contextmanager
def _fir_in_place(make):
    from meteor_demod_tpu_torch.demod import backend
    orig = backend.polyphase_fir_block
    backend.polyphase_fir_block = make(orig)
    try:
        yield
    finally:
        backend.polyphase_fir_block = orig


def tf32_fir():
    return _fir_in_place(lambda orig: lambda x, tail, banks: orig(
        tf32(x), tf32(tail), tf32(banks)))


def reordered_fir():
    return _fir_in_place(lambda orig: _tap_by_tap)


FIRS = {"tf32": tf32_fir, "reordered": reordered_fir}
