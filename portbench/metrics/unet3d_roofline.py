"""unet3d_roofline: the 3D U-Net's share (%) of its roofline: the least time
of its convolutions at the cell's batch (frozen counts,
portbench/frozen/grid_work.py: 1.948 TFLOP and 7.75 GB at B=64, bound by
operations, 29.07 ms) over ``gridplan.encode_ms`` (the stem and the grid
included), whatever computes it."""

from portbench.drivers.plan_grid import mean_stage_ms
from portbench.frozen import grid_work, work


def read(run):
    ms = mean_stage_ms(run, ["encode"])
    if ms is None:
        return None
    m, B = run.config["model"], run.traffic["batch_size"]
    shape = (m["grid_resolution"], m["c_dim"], m["unet3d_f_maps"], m["unet3d_num_levels"])
    bound, _ = work.bound(B * grid_work.unet3d_flops(*shape), B * grid_work.unet3d_bytes(*shape))
    return 100.0 * bound / ms
