"""A seeded uniform sample of a stream of unknown length (reservoir sampling)."""

from __future__ import annotations


class Reservoir:
    """Keeps ``k`` of the items offered, each offered item equally likely."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            self.items[j] = item
