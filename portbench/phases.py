"""The set-up's phases and their seconds, in order (printed on standard
error beside each run's result)."""

from __future__ import annotations

import time


class Phases(list):
    """[(phase, seconds), ...]; ``mark`` closes the phase that ran since the
    last mark (or since the list was made)."""

    def __init__(self):
        super().__init__()
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.append((name, now - self.t))
        self.t = now
