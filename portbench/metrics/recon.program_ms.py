"""recon.program_ms: the band program's time a batch (ms), from a CUDA event
recorded before ``generate_meshes`` (the upload included) to the
generator's own ``marks`` event after the band, over every batch of the
traced run's window."""


def read(run):
    if not run.program_s:
        return None
    return 1e3 * sum(run.program_s) / len(run.program_s)
