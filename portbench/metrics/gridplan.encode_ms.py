"""gridplan.encode_ms: the batched program's encode (the stem, the grid and
the 3D U-Net) a batch (ms), from its "start" mark to its "encode" mark
(CUDA events, ``GIGAPlanner.marks``), over every batch of the traced run's
window."""

from portbench.drivers.plan_grid import mean_stage_ms


def read(run):
    return mean_stage_ms(run, ["encode"])
