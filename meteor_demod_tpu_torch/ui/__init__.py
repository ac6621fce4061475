"""Terminal frontends: the curses TUI (tui.py)."""
