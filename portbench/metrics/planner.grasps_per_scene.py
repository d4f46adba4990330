"""planner.grasps_per_scene: the mean number of grasps in the lists that
resolved in the window: the host's conversion work a scene."""


def read(run):
    return sum(run.grasps) / len(run.grasps) if run.grasps else None
