"""scenes_per_s: scenes whose future resolved to a grasp list inside the
window, over the window's length (host clock)."""


def read(run):
    return run.completed / run.window_s if run.completed else None
