"""recon.mfu: the band program's share (%) of the card's float32 peak: the
frozen operation count of one mesh (the encoder and the occupancy decoder
on the generation lattice) times the meshes of the window, over the window
and over 67 TFLOP/s."""

from portbench.frozen import work


def read(run):
    if not run.completed:
        return None
    g, m = run.settings, run.config["model"]
    flops = work.giga_geo_mesh_flops(n=g["resolution0"] * 2 ** g["upsampling_steps"] + 1,
                                     P=m["plane_resolution"], C=m["c_dim"],
                                     H=m["hidden_size"], n_blocks=m["n_blocks"],
                                     depth=m["unet_depth"], start=m["unet_start_filts"])
    return 100.0 * flops * run.completed / run.window_s / work.PEAK_FP32_FLOPS
