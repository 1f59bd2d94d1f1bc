"""Terminal session management and raw-mode keyboard input — a copy of
``terminal_raytracer_tpu/runtime/terminal.py`` (whose package imports jax).

Replaces the reference's crossterm usage (reference: src/lib.rs:354-367,
390-407, 567-570) with termios/tty — and fixes its one real defect: the
reference never restores the terminal on panic (SURVEY.md §5.3); here the
guard is a context manager that restores cooked mode, cursor and screen on
*any* exit path, including exceptions and SIGTERM.
"""

from __future__ import annotations

import os
import select
import signal
import sys
import time
from typing import Optional

HIDE_CURSOR = b"\x1b[?25l"
SHOW_CURSOR = b"\x1b[?25h"
CLEAR = b"\x1b[2J\x1b[1;1H"  # one-time clear (lib.rs:367)
HOME = b"\x1b[1;1H"  # per-frame cursor home, no clear (lib.rs:497)

# Escape sequences for arrow keys (raw mode).
_ARROWS = {b"[A": "up", b"[B": "down", b"[C": "right", b"[D": "left"}


def terminal_size(default=(80, 24)):
    try:
        sz = os.get_terminal_size()
        if sz.columns <= 0 or sz.lines <= 2:  # unset pty winsize etc.
            return default
        return sz.columns, sz.lines
    except OSError:
        return default


class TerminalSession:
    """Raw-mode guard + non-blocking key reader.

    Keys map to the reference's controls (lib.rs:393-404): w/a/s/d move,
    arrows steer, ESC exits. Returns canonical names: 'w', 'a', 's', 'd',
    'up', 'down', 'left', 'right', 'esc'.
    """

    def __init__(self, stream=None):
        self._stream = stream if stream is not None else sys.stdin
        self._fd: Optional[int] = None
        self._saved = None
        self._installed_sigterm = False

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self):
        out = sys.stdout
        if self._stream.isatty():
            import termios
            import tty

            self._fd = self._stream.fileno()
            self._saved = termios.tcgetattr(self._fd)
            tty.setcbreak(self._fd)
            # Restore on SIGTERM too, then re-raise default behavior.
            self._old_term = signal.signal(signal.SIGTERM, self._on_sigterm)
            self._installed_sigterm = True
        out.buffer.write(HIDE_CURSOR + CLEAR)
        out.flush()
        return self

    def __exit__(self, *exc):
        self.restore()
        return False

    def _on_sigterm(self, signum, frame):
        self.restore()
        signal.default_int_handler(signum, frame)

    def restore(self):
        out = sys.stdout
        try:
            out.buffer.write(SHOW_CURSOR + b"\x1b[0m\r\n")
            out.flush()
        except Exception:
            pass
        if self._saved is not None:
            import termios

            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)
            self._saved = None
        if self._installed_sigterm:
            signal.signal(signal.SIGTERM, self._old_term)
            self._installed_sigterm = False

    # -- input ---------------------------------------------------------------

    def poll_key(self, timeout: float = 0.001) -> Optional[str]:
        """Read one key if available within `timeout` seconds (the
        reference polls at 1 ms, lib.rs:390)."""
        if self._fd is None:
            return None
        r, _, _ = select.select([self._fd], [], [], timeout)
        if not r:
            return None
        ch = os.read(self._fd, 1)
        if ch == b"\x1b":
            # Arrow = ESC [ A..D; a lone ESC (no follow-up) = exit. Over a
            # slow ssh/pty the continuation bytes can straggle, so wait up
            # to ~30 ms and read incrementally until the 2-byte sequence
            # completes (a 1 ms window misreads arrows as ESC).
            seq = b""
            deadline = time.monotonic() + 0.030
            while len(seq) < 2:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                r, _, _ = select.select([self._fd], [], [], remaining)
                if not r:
                    break
                seq += os.read(self._fd, 2 - len(seq))
            if not seq:
                return "esc"
            return _ARROWS.get(seq, None)
        try:
            return ch.decode("ascii").lower()
        except UnicodeDecodeError:
            return None

    # -- output --------------------------------------------------------------

    @staticmethod
    def write_frame(payload: bytes, status: str, height: int):
        """Home the cursor, write the frame, then the status line at row
        height+1 (lib.rs:497,551-558) — one write() each, like the
        reference's single print! + flush."""
        out = sys.stdout.buffer
        out.write(HOME + payload)
        out.write(f"\x1b[{height + 1};1H{status}\r\n".encode())
        sys.stdout.flush()
