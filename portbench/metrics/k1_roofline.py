"""k1_roofline: K1's (csrc/stem_pool.cu, float32) share (%) of its
roofline: the least time of its work at the service's batch (frozen
counts: 7.60 GFLOP and 55.7 MB at B=64, bound by operations) over its mean
time by name in the traced stretch."""

from portbench.frozen import kernels, work
from portbench.trace import mean_kernel_s


def read(run):
    t = mean_kernel_s(run, kernels.K1_F32)
    if t is None:
        return None
    m = run.config["model"]
    ms, _ = work.bound(*work.stem_pool_work(run.traffic["batch_size"], m["grid_resolution"],
                                            m["c_dim"]))
    return 100.0 * ms * 1e-3 / t
