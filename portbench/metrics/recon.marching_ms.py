"""recon.marching_ms: the host's marching tetrahedra a mesh (ms), the
generator's own ``batch_stats[b]["time (marching cubes)"]``, over every
mesh of the window."""


def read(run):
    if not run.marching_s:
        return None
    return 1e3 * sum(run.marching_s) / len(run.marching_s)
