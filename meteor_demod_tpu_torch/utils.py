"""Formatting and CLI helper utilities (reference: utils.c), and the
device every entry point defaults to."""

from __future__ import annotations

import os
import time

import torch

PLATFORM_ENV = "METEOR_DEMOD_PLATFORM"


def select_device(device=None) -> torch.device:
    """The device an entry point runs on. A given `device` is taken as it
    is. None means the CUDA card, or the CPU when METEOR_DEMOD_PLATFORM=cpu;
    it raises when the card is wanted and CUDA is not available, so no
    caller drops to the CPU without asking for it."""
    if device is not None:
        return torch.device(device)
    platform = os.environ.get(PLATFORM_ENV, "").strip().lower()
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("", "cuda", "gpu"):
        raise ValueError(f"{PLATFORM_ENV}={platform!r}: use cpu or cuda")
    if not torch.cuda.is_available():
        raise RuntimeError(f"CUDA is not available; set {PLATFORM_ENV}=cpu "
                           f"to demodulate on the CPU")
    return torch.device("cuda")


def gen_fname(t: float | None = None) -> str:
    """Default output filename LRPT_%Y_%m_%d-%H_%M.s (utils.c:7-19)."""
    return time.strftime("LRPT_%Y_%m_%d-%H_%M.s",
                         time.localtime(t if t is not None else time.time()))


def humanize(count: int) -> str:
    """SI-suffix formatting (utils.c:21-41)."""
    suffix = " kMGTPE"
    if count < 1000:
        return f"{count} {suffix[0]}"
    fcount = float(count)
    exp_3 = 0
    while fcount > 1000:
        fcount /= 1000
        exp_3 += 1
    if fcount > 99.9:
        return f"{fcount:3.0f} {suffix[exp_3]}"
    if fcount > 9.99:
        return f"{fcount:3.1f} {suffix[exp_3]}"
    return f"{fcount:3.2f} {suffix[exp_3]}"


def seconds_to_str(secs: int) -> str:
    """HH:MM:SS (utils.c:43-57)."""
    if secs > 99 * 60 * 60:
        return "00:00:00"
    s = secs % 60
    m = (secs // 60) % 60
    h = secs // 3600
    return f"{h:02d}:{m:02d}:{s:02d}"


def human_to_float(human: str) -> float:
    """k/K/M-suffixed number parsing (utils.c:59-86).

    Parity quirk: the reference stores the result through an int before
    returning it as float, so the value is truncated toward zero.
    """
    try:
        tmp = float(_leading_number(human))
    except ValueError:
        tmp = 0.0
    idx = 0
    while idx < len(human) and (human[idx].isdigit() or human[idx] == "."):
        idx += 1
    suffix = human[idx] if idx < len(human) else ""
    if suffix in ("k", "K"):
        ret = tmp * 1000
    elif suffix == "M":
        ret = tmp * 1000000
    else:
        ret = tmp
    return float(int(ret))


def _leading_number(s: str) -> str:
    # atof semantics: parse the longest valid leading prefix, 0 on failure.
    out = ""
    seen_dot = False
    for i, ch in enumerate(s):
        if ch.isdigit():
            out += ch
        elif ch == "." and not seen_dot:
            out += ch
            seen_dot = True
        elif ch in "+-" and i == 0:
            out += ch
        else:
            break
    return out if out not in ("", "+", "-", ".") else "0"
