"""planner.convert_ms: the mean length (ms) of the program's ``planner.convert``
span, one a ``plan_batch`` call, over the calls that began in the traced
stretch (giga_tpu_torch/utils/profiling.py)."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms(run, "planner.convert")
