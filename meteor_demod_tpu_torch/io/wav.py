"""WAV / raw IQ ingest with reference-compatible semantics.

Mirrors wavfile.c:
- wav_parse (wavfile.c:33-48): reads a fixed 44-byte canonical RIFF header,
  requires "RIFF"/"WAVE" and exactly 2 channels, takes samplerate and bits
  per sample from the header. No fmt/data marker validation (the reference
  does not check them either). On failure the caller rewinds and treats the
  input as raw (main.c:163-166).
- wav_read (wavfile.c:50-80): the reference reads fixed 32 KiB chunks and
  returns EOF when a full chunk cannot be read — i.e. a trailing partial
  chunk is DROPPED. read_samples reproduces that by default so golden
  comparisons line up; pass drop_partial_buffer=False for lossless reads.

Sample formats (wavfile.c:57-73): 8-bit unsigned (offset 128), 16-bit signed,
32-bit float; values are raw counts, not normalized.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass
from typing import BinaryIO, Iterator, Optional

import numpy as np

from ..constants import FILE_BUFFER_SIZE
from . import native

_HEADER_FMT = "<4sI4s4sIHHIIHH4sI"
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)  # 44


@dataclass
class WavInfo:
    samplerate: int
    bps: int


def wav_parse(f: BinaryIO) -> Optional[WavInfo]:
    """Parse the canonical header; None if not a 2-channel WAV.

    Leaves the stream positioned after the header on success; the caller is
    responsible for rewinding on failure (main.c:164-166).
    """
    data = f.read(_HEADER_SIZE)
    if len(data) < _HEADER_SIZE:
        return None
    (riff, _chunk, wave, _fmt, _sub, _afmt, nchan, srate, _brate,
     _balign, bps, _data, _sub2) = struct.unpack(_HEADER_FMT, data)
    if riff != b"RIFF" or wave != b"WAVE":
        return None
    if nchan != 2:
        return None
    if bps == 0:
        return None
    return WavInfo(samplerate=int(srate), bps=int(bps))


def decode_iq(raw: bytes, bps: int) -> np.ndarray:
    """Interleaved I/Q bytes -> complex64, reference scaling (raw counts).

    The C++ decoder of native/meteor_io.cc when it is built (io/native.py),
    numpy otherwise: the same values either way. A length numpy cannot
    view at the width (an odd byte at 16 bits) goes to numpy, which
    raises."""
    if len(raw) % max(bps // 8, 1) == 0:
        pairs = native.decode_iq_f32(raw, bps)
        if pairs is not None:
            return pairs.view(np.complex64).ravel()
    if bps == 8:
        a = np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - np.float32(128)
    elif bps == 16:
        a = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    elif bps == 32:
        a = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"unsupported bits per sample: {bps}")
    # The interleaved float32 pairs ARE the complex64 samples: a view, where
    # building them by arithmetic costs ~1 s on a two-minute recording.
    return a[:(len(a) // 2) * 2].view(np.complex64)


def read_sample_blocks(f: BinaryIO, bps: int,
                       drop_partial_buffer: bool = True) -> Iterator[np.ndarray]:
    """Yield complex64 sample chunks from a stream.

    With drop_partial_buffer=True (default) this is byte-for-byte equivalent
    to looping wav_read (wavfile.c:50-80): only full 32 KiB chunks are
    consumed and a short trailing read is discarded.
    """
    while True:
        raw = f.read(FILE_BUFFER_SIZE)
        if not raw:
            return
        if len(raw) < FILE_BUFFER_SIZE:
            # The reference uses fread(..., 32768, 1, fd), which fails on a
            # short read — but stdio may return a short read only at EOF for
            # regular files; for pipes fread keeps filling. Loop to fill.
            while len(raw) < FILE_BUFFER_SIZE:
                more = f.read(FILE_BUFFER_SIZE - len(raw))
                if not more:
                    break
                raw += more
            if len(raw) < FILE_BUFFER_SIZE and drop_partial_buffer:
                return
        yield decode_iq(raw, bps)


def open_input(path: str):
    """Open an input path ('-' = stdin) and sniff the format.

    Returns (file, WavInfo-or-None, is_stdin). For non-seekable stdin the
    header bytes are pushed back via buffering.
    """
    import sys
    if path == "-":
        raw = sys.stdin.buffer
        head = raw.read(_HEADER_SIZE)
        info = wav_parse(io.BytesIO(head)) if len(head) == _HEADER_SIZE else None
        if info is None:
            # Raw stream: re-prepend the sniffed bytes.
            f = _ChainedReader(head, raw)
        else:
            f = raw
        return f, info, True
    f = open(path, "rb")
    info = wav_parse(f)
    if info is None:
        f.seek(0)
    return f, info, False


class _ChainedReader:
    """Minimal reader that replays a prefix before the underlying stream."""

    def __init__(self, prefix: bytes, stream: BinaryIO):
        self._prefix = prefix
        self._stream = stream

    def read(self, n: int) -> bytes:
        if self._prefix:
            part, self._prefix = self._prefix[:n], self._prefix[n:]
            if len(part) < n:
                part += self._stream.read(n - len(part))
            return part
        return self._stream.read(n)
