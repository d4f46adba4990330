"""grid_decode_roofline: the grid decode's share (%) of its roofline: the
least time of the trilinear sampling, the trunk and the heads on the cell's
batch of 40^3 lattices (frozen counts, portbench/frozen/grid_work.py: 395
GFLOP and 721 MB at B=64, bound by operations, 5.90 ms) over
``gridplan.decode_ms``, whatever computes it."""

from portbench.drivers.plan_grid import mean_stage_ms
from portbench.frozen import grid_work, work


def read(run):
    ms = mean_stage_ms(run, ["features", "decode"])
    if ms is None:
        return None
    m = run.config["model"]
    bound, _ = work.bound(*grid_work.grid_decode_work(
        run.traffic["batch_size"], run.settings["resolution"], m["grid_resolution"], m["c_dim"],
        m["hidden_size"], 3, m["n_blocks"], 4))
    return 100.0 * bound / ms
