"""plan.mfu: the batched planning program's share (%) of the card's float32
peak: the frozen operation count of one scene (K1's stem and pooling, the
U-Net, the lattice sampling and projections, K2's trunk) times the scenes
resolved in the window, over the window and over 67 TFLOP/s."""

from portbench.frozen import work


def read(run):
    if not run.completed:
        return None
    m = run.config["model"]
    flops = work.giga_plan_flops(R=run.settings["resolution"], P=m["plane_resolution"],
                                 C=m["c_dim"], H=m["hidden_size"], n_blocks=m["n_blocks"],
                                 depth=m["unet_depth"], start=m["unet_start_filts"])
    return 100.0 * flops * run.completed / run.window_s / work.PEAK_FP32_FLOPS
