"""TTY-aware human log handler and the ``-v`` flag."""

from __future__ import annotations

import logging
import sys
import time

_RESET = "\x1b[0m"
_LEVEL_COLORS = {
    logging.DEBUG: "\x1b[36m",  # cyan
    logging.INFO: "\x1b[32m",  # green
    logging.WARNING: "\x1b[33m",  # yellow
    logging.ERROR: "\x1b[31m",  # red
    logging.CRITICAL: "\x1b[35m",  # magenta
}


class HumanFormatter(logging.Formatter):
    """`HH:MM:SS LEVEL message` with a colored level on a TTY
    (logger_ctl.go:78-139)."""

    def __init__(self, color: bool) -> None:
        super().__init__()
        self.color = color

    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        level = record.levelname
        msg = record.getMessage()
        if self.color:
            c = _LEVEL_COLORS.get(record.levelno, "")
            out = f"{ts} {c}{level:<5}{_RESET} {msg}"
        else:
            out = f"{ts} {level:<5} {msg}"
        if record.exc_info:
            out += "\n" + self.formatException(record.exc_info)
        return out


def add_flags(parser) -> None:
    """The `-v` flag (flags.go:26): 0=info, >=1 debug."""
    parser.add_argument(
        "-v",
        "--verbosity",
        type=int,
        default=0,
        help="log verbosity: 0 info, >=1 debug",
    )


def setup(verbosity: int = 0, stream=None) -> None:
    """Install the human handler on the root logger (idempotent)."""
    stream = stream if stream is not None else sys.stderr
    color = hasattr(stream, "isatty") and stream.isatty()
    handler = logging.StreamHandler(stream)
    handler.setFormatter(HumanFormatter(color))
    root = logging.getLogger()
    root.handlers = [
        h for h in root.handlers if not getattr(h, "_kwok_log", False)
    ]
    handler._kwok_log = True
    root.addHandler(handler)
    root.setLevel(logging.DEBUG if verbosity > 0 else logging.INFO)
