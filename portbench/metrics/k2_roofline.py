"""k2_roofline: K2's (csrc/dense_decode.cu, float32) share (%) of its
roofline: the least time of its work at the service's batch (frozen
counts: 267 GFLOP and 787 MB at B=64, bound by operations) over its mean
time by name in the traced stretch."""

from portbench.frozen import kernels, work
from portbench.trace import mean_kernel_s


def read(run):
    t = mean_kernel_s(run, kernels.K2_F32)
    if t is None:
        return None
    m = run.config["model"]
    ms, _ = work.bound(*work.dense_decode_work(run.traffic["batch_size"],
                                               run.settings["resolution"], 3,
                                               m["hidden_size"], m["n_blocks"], 4))
    return 100.0 * ms * 1e-3 / t
