"""Progress lines through `logging`, in place of the JAX package's tqdm bars
(`utils/progress.py` there).

A `Progress` logs "desc: n/total" at INFO at most every EVERY_S seconds,
and on close one line with the count, the elapsed seconds and it/s, which
the console and the file logbook both keep: the logbook records each
scale's rate, as the reference's closing tqdm line does
(src/utils/progress_bar.py:12-158).
"""

from __future__ import annotations

import logging
import time

EVERY_S = 10.0


class Progress:
    def __init__(self, total: int, desc: str = "", initial: int = 0):
        """`initial`: iterations done before (a resumed scale's)."""
        self.total, self.desc = total, desc
        self.n = self.initial = initial
        self.t0 = self.t_last = time.perf_counter()

    def update(self, n: int = 1) -> None:
        self.n += n
        now = time.perf_counter()
        if now - self.t_last >= EVERY_S:
            self.t_last = now
            logging.info("%s: %d/%d", self.desc, self.n, self.total)

    def close(self) -> None:
        secs = time.perf_counter() - self.t0
        logging.info("%s: %d/%d [%.1f s, %.2f it/s]", self.desc, self.n,
                     self.total, secs,
                     (self.n - self.initial) / max(secs, 1e-9))
