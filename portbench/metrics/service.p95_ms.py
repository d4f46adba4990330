"""service.p95_ms: the 95th percentile (nearest rank) of the time from
``submit`` to the resolved future, over every request resolved in the
window (the benchmark's host clock)."""

import math


def read(run):
    lat = sorted(run.latencies)
    if len(lat) < 200:  # at least ten past the 95th percentile
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
