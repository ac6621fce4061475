"""Curses TUI: live constellation, PLL status, I/O progress, log window.

Functional equivalent of the reference's ncurses frontend (tui.c): a banner
row, an ASCII-density IQ constellation (`.` → `-` → `+` → `#`, tui.c:166-201),
a PLL status pane (lock state, AGC gain, carrier freq, symbol rate,
tui.c:139-160), data-in/data-out panes (tui.c:204-247), and a timestamped
scrolling log (tui.c:116-136). 'q' quits; the getch timeout doubles as the
refresh throttle (tui.c:95-113); terminal resize relayouts (tui.c:59-90).

Unlike the reference, the constellation source is not racy shared memory: the
writer keeps a snapshot of the last full symbol ring (io/writer.py). The loop
reads the worker's host-side telemetry only and never touches the device.
"""

from __future__ import annotations

import curses
import time

from .. import __version__
from ..utils import humanize, seconds_to_str

CONSTELL_MAX = 31
_DENSITY = {".": "-", "-": "+", "+": "#", "#": "#"}


class Tui:
    def __init__(self, scr, upd_interval_ms: int):
        self.scr = scr
        self.upd = upd_interval_ms
        curses.noecho()
        curses.cbreak()
        try:
            curses.curs_set(0)
        except curses.error:
            pass
        curses.use_default_colors()
        curses.start_color()
        curses.init_pair(1, -1, -1)
        curses.init_pair(2, curses.COLOR_GREEN, -1)
        curses.init_pair(3, curses.COLOR_RED, -1)
        self._log_lines: list[str] = []
        self.layout()

    # -- layout (tui.c:59-90) ------------------------------------------------
    def layout(self) -> None:
        self.scr.erase()
        self.scr.refresh()
        nr, nc = self.scr.getmaxyx()
        iq = min(CONSTELL_MAX, min(nr, nc // 3)) | 0x3
        self.iq_size = iq
        right_w = max(10, nc - iq - 2)
        self.w_banner = curses.newwin(1, nc, 0, 0)
        self.w_iq = curses.newwin(max(3, iq // 2), iq, 2, 0)
        self.w_pll = curses.newwin(3, right_w, 2, iq + 2)
        self.w_filein = curses.newwin(2, right_w, 6, iq + 2)
        self.w_dataout = curses.newwin(2, right_w, 9, iq + 2)
        info_y = max(12, 2 + iq // 2 + 1)
        self.w_info = curses.newwin(max(1, nr - info_y), nc, info_y, 0)
        self.w_info.scrollok(True)
        self.w_info.timeout(self.upd)
        self.w_info.keypad(True)
        try:
            self.w_banner.addstr(
                0, 0, f"\t~ Meteor M2 LRPT Demodulator (CUDA) v{__version__} ~",
                curses.A_BOLD)
        except curses.error:
            pass
        self.w_banner.refresh()
        for line in self._log_lines[-(self.w_info.getmaxyx()[0]):]:
            self._put_log(line)
        self.draw_quadrants()
        self.w_iq.refresh()

    # -- input / throttle (tui.c:95-113) ------------------------------------
    def process_input(self) -> bool:
        """Blocks up to upd_interval ms; True if the user asked to quit."""
        ch = self.w_info.getch()
        if ch == curses.KEY_RESIZE:
            self.layout()
        elif ch == ord("q"):
            return True
        self.w_info.refresh()
        return False

    def wait_for_key(self) -> None:
        self.w_info.timeout(-1)
        self.w_info.getch()
        self.w_info.timeout(self.upd)

    # -- panes ---------------------------------------------------------------
    def print_info(self, msg: str) -> None:
        line = f"({time.strftime('%H:%M:%S')}) {msg}"
        self._log_lines.append(line)
        self._put_log(line)

    def _put_log(self, line: str) -> None:
        try:
            self.w_info.addstr(line + "\n")
        except curses.error:
            pass
        self.w_info.refresh()

    def update_pll(self, freq: float, rate: float, locked: bool,
                   gain: float) -> None:
        w = self.w_pll
        w.erase()
        try:
            w.addstr(0, 0, "PLL status: ", curses.A_BOLD)
            if locked:
                w.addstr("Locked", curses.A_BOLD | curses.color_pair(2))
            else:
                w.addstr("Acquiring...", curses.A_BOLD | curses.color_pair(3))
            w.addstr(1, 0, "Gain\tCarrier freq\tSymbol rate")
            w.addstr(2, 0, f"{gain:.3f}\t{freq:+7.1f} Hz\t{rate:7.1f} Hz")
        except curses.error:
            pass
        w.refresh()

    def draw_quadrants(self) -> None:
        nr, nc = self.w_iq.getmaxyx()
        try:
            self.w_iq.vline(0, nc // 2, curses.ACS_VLINE, nr)
            self.w_iq.hline(nr // 2, 0, curses.ACS_HLINE, nc)
            self.w_iq.addch(nr // 2, nc // 2, curses.ACS_PLUS)
        except curses.error:
            pass

    def draw_constellation(self, dots) -> None:
        """dots: interleaved int8 I,Q array (the last full symbol ring)."""
        w = self.w_iq
        nr, nc = w.getmaxyx()
        w.erase()
        for i in range(0, len(dots) - 1, 2):
            # int() truncates toward zero like the C division (tui.c:176-178);
            # floor division would displace negative-quadrant dots by a cell.
            x = int(int(dots[i]) * nc / 255)
            y = int(int(dots[i + 1]) * nr / 255)
            row, col = nr // 2 - y, x + nc // 2
            if not (0 <= row < nr and 0 <= col < nc):
                continue
            try:
                prev = chr(w.inch(row, col) & 0xFF)
                w.addch(row, col, _DENSITY.get(prev, "."))
            except curses.error:
                pass
        self.draw_quadrants()
        w.refresh()

    def update_file_in(self, byterate: float, done: int, total: int) -> None:
        pct = (done / total * 100) if total else 0.0
        w = self.w_filein
        w.erase()
        try:
            w.addstr(0, 0, "Data in", curses.A_BOLD)
            w.addstr(1, 0, f"{seconds_to_str(int(done // max(1, byterate)))}/"
                           f"{seconds_to_str(int(total // max(1, byterate)))}"
                           f" ({pct:.1f}%)")
        except curses.error:
            pass
        w.refresh()

    def update_data_out(self, nbytes: int) -> None:
        w = self.w_dataout
        w.erase()
        try:
            w.addstr(0, 0, "Data out", curses.A_BOLD)
            w.addstr(1, 0, f"{humanize(nbytes)}B")
        except curses.error:
            pass
        w.refresh()


def run_tui(runner, upd_interval_ms: int) -> None:
    """Main-thread TUI loop over a running DemodRunner (main.c:222-244)."""

    def loop(scr):
        tui = Tui(scr, upd_interval_ms)
        opts = runner.opts
        tui.print_info(f"Input: {opts.input_path}, output: "
                       f"{opts.output_fname}")
        tui.print_info("Demodulator initialized")
        byterate = 2 * runner.demod.cfg.samplerate * runner.bps / 8
        while not runner.done.is_set():
            if tui.process_input():
                runner.stop.set()
                break
            _, freq_hz, rate_hz, locked = runner.status_tuple()
            tui.update_file_in(byterate, runner.bytes_read, runner.file_len)
            tui.update_data_out(runner.writer.bytes_out)
            tui.update_pll(freq_hz, rate_hz, locked, runner.demod.agc_gain)
            tui.draw_constellation(runner.writer.last_ring)
        tui.print_info("Demodulation complete")
        tui.print_info("Press any key to exit...")
        tui.wait_for_key()

    curses.wrapper(loop)
