"""The pass check's search for its first segment (check_pass.search_all):
found at any place of the .s in every symmetry, the same as align's
sliding window where that window holds the segment, and no match where the
.s does not hold it."""

import numpy as np
import pytest

from lrpt_bench.reference import check_pass

PROBE = 512


def _bytes(rng, n: int) -> np.ndarray:
    """(n, 2) int8 soft bytes, zeros among them as the .s has them."""
    return rng.integers(-127, 128, (n, 2)).astype(np.int8)


def _plant(prog: np.ndarray, ref: np.ndarray, shift: int, tr: int,
           oqpsk: bool) -> None:
    """The reference's bytes in symmetry tr at `shift` of the .s (symbols
    for QPSK, bytes for OQPSK), as decisions_off reads them back."""
    seg = check_pass._transformed(ref, shift, tr, oqpsk).astype(np.int8)
    if oqpsk:
        prog.reshape(-1)[shift:shift + len(seg)] = seg
    else:
        prog[shift:shift + len(ref)] = seg.reshape(-1, 2)


def _noisy(rng, ref: np.ndarray, flip: float) -> np.ndarray:
    """ref with a share `flip` of its bytes negated: a segment that a
    rounding moved a little."""
    return np.where(rng.random(ref.shape) < flip, -ref, ref).astype(np.int8)


@pytest.mark.parametrize("tr", range(4))
def test_qpsk_segment_far_from_its_prediction(tr):
    rng = np.random.default_rng(100 + tr)
    prog, ref = _bytes(rng, 700_000), _bytes(rng, 1024)
    at = 431_017
    _plant(prog, ref, at, tr, False)
    # Pieces smaller than the span, so the place lies past a seam.
    assert check_pass.search_all(prog, ref, 0, 650_000, False,
                                 chunk=1 << 16) == (at, tr, 1.0)
    assert check_pass.decisions_off(prog, ref, at, tr, False)[0] == 0


@pytest.mark.parametrize("parity", (0, 1))
@pytest.mark.parametrize("tr", range(4))
def test_oqpsk_segment_far_from_its_prediction(tr, parity):
    rng = np.random.default_rng(200 + 2 * tr + parity)
    prog, ref = _bytes(rng, 600_000), _bytes(rng, 1024)
    at = 2 * 377_311 + parity                     # bytes: half symbols
    _plant(prog, ref, at, tr, True)
    assert check_pass.search_all(prog, ref, 0, 560_000, True,
                                 chunk=1 << 17) == (at, tr, 1.0)
    assert check_pass.decisions_off(prog, ref, at, tr, True)[0] == 0


@pytest.mark.parametrize("edge", (-1, 0, 1))
@pytest.mark.parametrize("oqpsk", (False, True))
def test_places_at_a_seam_between_pieces(oqpsk, edge):
    """search_all's pieces of `chunk` places meet every step places: a
    segment on either side of a seam, or on it, is found."""
    rng = np.random.default_rng(600 + edge + 10 * oqpsk)
    chunk, unit = 4096, (2 if oqpsk else 1)
    step = chunk - unit * PROBE + 1
    prog, ref = _bytes(rng, 20_000), _bytes(rng, 1024)
    at = step + edge
    _plant(prog, ref, at, 1, oqpsk)
    assert check_pass.search_all(prog, ref, 0, 15_000, oqpsk,
                                 chunk=chunk) == (at, 1, 1.0)


@pytest.mark.parametrize("oqpsk", (False, True))
def test_the_span_ends_at_end(oqpsk):
    """The last place searched is symbol `end` itself."""
    rng = np.random.default_rng(700 + oqpsk)
    unit, end = (2 if oqpsk else 1), 9_000
    prog, ref = _bytes(rng, 20_000), _bytes(rng, 1024)
    _plant(prog, ref, unit * end, 2, oqpsk)
    assert check_pass.search_all(prog, ref, 0, end, oqpsk) == (unit * end, 2,
                                                            1.0)
    assert check_pass.search_all(prog, ref, 0, end - 1, oqpsk)[2] < 0.9


@pytest.mark.parametrize("oqpsk", (False, True))
def test_the_span_starts_at_start(oqpsk):
    """The first place searched is symbol `start` itself: a place before it
    is not found, though the .s holds it."""
    rng = np.random.default_rng(800 + oqpsk)
    unit, start = (2 if oqpsk else 1), 7_000
    prog, ref = _bytes(rng, 40_000), _bytes(rng, 1024)
    _plant(prog, ref, unit * start, 3, oqpsk)
    assert check_pass.search_all(prog, ref, start, 30_000, oqpsk,
                                 chunk=1 << 13) == (unit * start, 3, 1.0)
    assert check_pass.search_all(prog, ref, start + 1, 30_000, oqpsk)[2] < 0.9


@pytest.mark.parametrize("per_block", (2560.0, 2844.444))
def test_the_first_span_bounds_the_offset(per_block):
    """From the .s's first symbol (or the prediction less the reference's
    acquisition, whichever is later) to the segment's place had the program
    written from the first sample, plus the margin (or the prediction plus
    the acquisition, whichever is earlier)."""
    E, s, search = 285, 570, 8192
    room = int(E * per_block)
    pred = int(200_000 + (s - E) * per_block)
    lo, hi = check_pass.first_span(pred, s, per_block, E, search)
    assert (lo, hi) == (pred - room,
                        min(pred + room, int(s * per_block) + search))
    assert lo > 0 and pred - 12_862 > lo and hi >= pred + search
    # A prediction near the .s's start: the span starts at its first symbol.
    assert check_pass.first_span(1_000, s, per_block, E, search)[0] == 0


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("oqpsk", (False, True))
def test_equals_the_sliding_window_near_the_prediction(oqpsk, seed):
    rng = np.random.default_rng(300 + seed + 10 * oqpsk)
    search, pred = 8192, 120_000 + int(rng.integers(0, 5000))
    prog, ref = _bytes(rng, 200_000), _bytes(rng, 1024)
    unit = 2 if oqpsk else 1
    at = unit * (pred + int(rng.integers(-search, search - PROBE)))
    at += int(rng.integers(0, 2)) if oqpsk else 0
    _plant(prog, _noisy(rng, ref, 0.04), at, int(rng.integers(0, 4)), oqpsk)
    wide = check_pass.search_all(prog, ref, 0, pred + search, oqpsk)
    assert wide == check_pass.align(prog, ref, pred, oqpsk, search)
    assert wide[0] == at and 0.9 < wide[2] < 1.0


@pytest.mark.parametrize("oqpsk", (False, True))
def test_no_match_where_the_segment_is_not_held(oqpsk):
    rng = np.random.default_rng(400 + oqpsk)
    prog, ref = _bytes(rng, 300_000), _bytes(rng, 1024)
    _, _, agree = check_pass.search_all(prog, ref, 0, 290_000, oqpsk)
    assert 0.5 < agree < 0.9


def test_a_s_shorter_than_the_probe_has_no_place():
    rng = np.random.default_rng(500)
    assert check_pass.search_all(_bytes(rng, 100), _bytes(rng, 1024),
                                 0, 10_000, False) == (None, None, -1.0)
