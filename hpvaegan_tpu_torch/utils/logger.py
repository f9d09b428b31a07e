"""Console + logbook logging with indentation blocks.

The port of the JAX package's `utils/logger.py` (reference
src/utils/logger.py:70-139, progress_bar.py:77-100): a LOGBOOK level (1000)
that the console leaves out and the file logbook keeps, ANSI colours
stripped in the file, and a LoggingBlock that indents nested sections.
`configure_logging` also registers a SIGUSR1 stack dump, as the JAX
package's does (scripts/train_watchdog.sh sends SIGUSR1 before it kills a
stalled run).
"""

from __future__ import annotations

import faulthandler
import io
import logging
import re
import signal

_ANSI_RE = re.compile(r"\x1b\[[0-9;]*m")
LOGBOOK_LEVEL = 1000
logging.addLevelName(LOGBOOK_LEVEL, "LOGBOOK")


class _Indent:
    level = 0


def logbook(message: str) -> None:
    """One line at the LOGBOOK level: in the file, not on the console."""
    logging.log(LOGBOOK_LEVEL, "%s", message)


class _IndentFormatter(logging.Formatter):
    def __init__(self, fmt, strip_ansi=False):
        super().__init__(fmt, datefmt="%Y-%m-%d %H:%M:%S")
        self.strip_ansi = strip_ansi

    def format(self, record):
        msg = super().format(record)
        if self.strip_ansi:
            msg = _ANSI_RE.sub("", msg)
        return ("  " * _Indent.level) + msg


_stack_dump_registered = False


def register_stack_dump() -> None:
    """From now on `kill -USR1 <pid>` dumps every thread's Python stack to
    stderr and the process runs on: where a rank waits in a collective,
    for one. Once a process: the train and eval CLIs call it on every
    rank, and `configure_logging` (the primary's) finds it done."""
    global _stack_dump_registered
    if _stack_dump_registered:
        return
    try:
        faulthandler.register(signal.SIGUSR1, all_threads=True)
        _stack_dump_registered = True
    except (AttributeError, ValueError, io.UnsupportedOperation):
        pass  # no SIGUSR1 on this platform, or no usable stderr


def configure_logging(filename: str = None) -> None:
    """Console (INFO and up, LOGBOOK left out) and, with `filename`, a file
    logbook of everything, ANSI-stripped; and the SIGUSR1 stack dump
    (`register_stack_dump`), as the JAX package's configure_logging."""
    register_stack_dump()
    root = logging.getLogger()
    root.setLevel(logging.DEBUG)
    root.handlers = []
    for noisy in ("matplotlib", "PIL"):
        logging.getLogger(noisy).setLevel(logging.WARNING)

    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    console.addFilter(lambda rec: rec.levelno != LOGBOOK_LEVEL)
    console.setFormatter(_IndentFormatter("%(asctime)s %(message)s"))
    root.addHandler(console)

    if filename:
        fh = logging.FileHandler(filename)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(_IndentFormatter("%(asctime)s %(message)s",
                                         strip_ansi=True))
        root.addHandler(fh)


class LoggingBlock:
    """Indented log section (reference logger.py:123-139)."""

    def __init__(self, title: str, emph: bool = False):
        self.title = title
        self.emph = emph

    def __enter__(self):
        if self.emph:
            logging.info("\x1b[1m%s\x1b[0m", self.title)
        else:
            logging.info("%s", self.title)
        _Indent.level += 1
        return self

    def __exit__(self, *exc):
        _Indent.level = max(0, _Indent.level - 1)
        return False
