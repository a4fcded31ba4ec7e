"""Terminal progress bars (counterpart of ``trackmaker_tpu/utils/progress.py``):
dependency-free REC/PLAY/SEND/RECV bars driven by sample counts."""

from __future__ import annotations

import sys
import time


class ProgressBar:
    def __init__(self, label: str, total: int, width: int = 40,
                 stream=None, min_interval: float = 0.05):
        self.label = label
        self.total = max(total, 1)
        self.width = width
        self.pos = 0
        self.stream = stream or sys.stderr
        self._last = 0.0
        self._min_interval = min_interval
        self._start = time.time()

    def set_position(self, pos: int) -> None:
        self.pos = min(pos, self.total)
        self._draw()

    def inc(self, n: int = 1) -> None:
        self.set_position(self.pos + n)

    def _draw(self, force: bool = False) -> None:
        now = time.time()
        if not force and now - self._last < self._min_interval:
            return
        self._last = now
        frac = self.pos / self.total
        filled = int(frac * self.width)
        bar = "#" * filled + "-" * (self.width - filled)
        self.stream.write(
            f"\r{self.label:>8} [{bar}] {self.pos}/{self.total}"
            f" ({100 * frac:5.1f}%)")
        self.stream.flush()

    def finish(self, msg: str = "") -> None:
        self.pos = self.total
        self._draw(force=True)
        dt = time.time() - self._start
        self.stream.write(f" {msg} ({dt:.1f}s)\n")
        self.stream.flush()
