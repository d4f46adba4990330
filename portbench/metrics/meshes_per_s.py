"""meshes_per_s: meshes returned inside the window (whole batches; the
window closes when the batch that passes its length returns), over the
window's length (host clock)."""


def read(run):
    return run.completed / run.window_s if run.completed else None
