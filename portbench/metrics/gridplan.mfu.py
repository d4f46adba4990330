"""gridplan.mfu: giga_grid's batched planning program's share (%) of the
card's float32 peak: the frozen operation count of one scene (the stem, the
3D U-Net and the lattice decode: 36.72 GFLOP, portbench/frozen/grid_work.py)
times the scenes resolved in the window, over the window and over 67
TFLOP/s."""

from portbench.frozen import grid_work, work


def read(run):
    if not run.completed:
        return None
    m = run.config["model"]
    flops = grid_work.grid_plan_flops(
        R=run.settings["resolution"], G=m["grid_resolution"], C=m["c_dim"], H=m["hidden_size"],
        f_maps=m["unet3d_f_maps"], num_levels=m["unet3d_num_levels"], n_blocks=m["n_blocks"])
    return 100.0 * flops * run.completed / run.window_s / work.PEAK_FP32_FLOPS
