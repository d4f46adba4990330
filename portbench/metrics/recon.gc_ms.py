"""recon.gc_ms: the ms of Python's collections (the program's ``host.gc``
spans) per second of the traced stretch."""

from portbench.spans import gc_ms_per_s


def read(run):
    return gc_ms_per_s(run)
