"""Formatting and CLI helper utilities (reference: utils.c), the device
every entry point defaults to, the device list of a multi-device one, and
the host <-> card copies."""

from __future__ import annotations

import os
import time

import numpy as np
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


def make_mesh(devices=None) -> list[torch.device]:
    """The devices a multi-device entry point runs on, one shard each.

    None (or "auto") means every visible card as cuda:0..n-1, or ["cpu"]
    under METEOR_DEMOD_PLATFORM=cpu; like select_device it raises when the
    card is wanted and CUDA is not available. A list is taken as given,
    repeats allowed: ["cpu"] * 4 shards on the CPU, ["cuda:0", "cuda:0"]
    runs two shards on one card. A card given without an index gets the
    current one, so that every entry names its card."""
    if devices is None or (isinstance(devices, str) and devices == "auto"):
        if select_device().type == "cpu":
            return [torch.device("cpu")]
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if isinstance(devices, (str, torch.device)):
        raise ValueError(f"a mesh is a list of devices or 'auto', not "
                         f"{devices!r}")
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("a mesh needs at least one device")
    return out


def mesh_devices(device=None, mesh=None) -> list[torch.device]:
    """The device list of an entry point that takes device= (one device, the
    spelling of one-device callers) or mesh= (a list, or "auto"); giving
    both raises. With neither: every visible card (make_mesh())."""
    if device is not None and mesh is not None:
        raise ValueError("give device= or mesh=, not both")
    if device is not None:
        return [select_device(device)]
    return make_mesh(mesh)


# Host <-> card copies go through pinned staging memory: a copy from or to
# pageable memory ran at under 1 GB/s on an H100's host (PERF.md section 6).
# torch's pinned allocator caches its blocks and holds one back while a
# non-blocking copy still reads it, so the buffers are made where they are
# used and cost an allocation only the first time.
STAGE_BYTES = 32 << 20


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array -> a tensor on `device`. On the CPU the array is used
    where it lies; to a card it goes in pieces of whole rows (of its first
    axis), about STAGE_BYTES each, through two pinned buffers in turn, and
    the copies are only queued: work on that card's current stream sees them
    done. Everything runs with `device` made the current card, so the copies
    and the events that guard the pinned buffers are on `device`'s stream,
    whichever card was current before."""
    src = torch.from_numpy(a)
    if device.type != "cuda":
        return src
    with torch.cuda.device(device):
        out = torch.empty(src.shape, dtype=src.dtype, device=device)
        if src.numel() == 0:
            return out
        rows = src.reshape(1) if src.dim() == 0 else src
        dst = out.view(rows.shape)
        n_rows = rows.shape[0]
        piece = max(1, STAGE_BYTES // (rows[0].numel() * rows.element_size()))
        stages = [torch.empty((min(piece, n_rows),) + rows.shape[1:],
                              dtype=rows.dtype, pin_memory=True)
                  for _ in range(min(2, -(-n_rows // piece)))]
        done = [torch.cuda.Event() for _ in stages]
        for i, at in enumerate(range(0, n_rows, piece)):
            n = min(piece, n_rows - at)
            if i >= 2:
                done[i % 2].synchronize()
            stages[i % 2][:n].copy_(rows[at:at + n])
            dst[at:at + n].copy_(stages[i % 2][:n], non_blocking=True)
            done[i % 2].record()
    return out


def to_host(tensors, copy: bool = True) -> list[np.ndarray]:
    """Tensors -> numpy arrays, each from its own device; from a card, all
    queued into pinned memory on the current stream of the tensor's card and
    waited for once, on every card among the tensors. The arrays are copies
    in ordinary memory; with copy=False they are the pinned buffers
    themselves, for a caller that consumes them at once (a kept one holds
    its buffer back from the allocator's cache, and the next call pays for a
    new one)."""
    out = []
    cards = []
    for t in tensors:
        if t.device.type != "cuda":
            out.append(t.numpy())
            continue
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        with torch.cuda.device(t.device):
            host.copy_(t, non_blocking=True)
        out.append(host)
        if t.device not in cards:
            cards.append(t.device)
    for card in cards:
        torch.cuda.synchronize(card)
    return [(h.numpy().copy() if copy else h.numpy())
            if isinstance(h, torch.Tensor) else h for h in out]


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
