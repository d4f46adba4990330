"""gridplan.decode_ms: the batched program's lattice decode (the trilinear
sampling of the grid on the 40^3 query lattice, the trunk and the heads) a
batch (ms), from its "encode" mark to its "decode" mark (CUDA events,
``GIGAPlanner.marks``), over every batch of the traced run's window."""

from portbench.drivers.plan_grid import mean_stage_ms


def read(run):
    return mean_stage_ms(run, ["features", "decode"])
