"""Helpers of the port's simulator tests: the kinematic pybullet double
(tests/torch_fake_pybullet.py for the port, tests/fake_pybullet.py for the
JAX package) installed for one package at a time, and the heuristic planner
of tests/test_sim_integration.py with the port's types.

The two doubles are separate modules, each with its own registry of
clients; a world made under one must be driven under the same one, so a
test runs the JAX side inside ``double("jax")`` and the port inside
``double("torch")``."""

import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
for p in (REPO, REPO / "tests"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

SIM_URDF_ROOT = REPO / "tests" / "fixtures" / "urdfs"


@contextlib.contextmanager
def double(package: str):
    """Install the pybullet double of ``package`` ("jax" or "torch") as
    ``pybullet`` and into that package's btsim, with fresh client state;
    undone on exit."""
    if package == "jax":
        import tests.fake_pybullet as fake
        from giga_tpu.sim import btsim
    else:  # a top-level module, as chip_smoke imports it
        import torch_fake_pybullet as fake
        from giga_tpu_torch.sim import btsim
    fake.reset_module_state()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "pybullet", fake)
        mp.setitem(sys.modules, "pybullet_utils", fake.pybullet_utils)
        mp.setitem(sys.modules, "pybullet_utils.bullet_client", fake.bullet_client)
        mp.setattr(btsim, "_pb", fake)
        mp.setattr(btsim, "_bullet_client", fake.bullet_client)
        mp.setattr(btsim, "PYBULLET_AVAILABLE", True)
        yield fake


@pytest.fixture
def torch_pb():
    """The port's double installed for one test."""
    with double("torch") as fake:
        yield fake


def port_heuristic_plan_fn(state, *args, **kw):
    """tests/test_sim_integration.py::heuristic_plan_fn with the port's
    types: its grasps (each at the top-down TOP_DOWN rotation) rebuilt from
    their translations and widths."""
    from giga_tpu_torch.core.grasp import Grasp
    from giga_tpu_torch.core.transform import Rotation, Transform
    from tests.test_sim_integration import TOP_DOWN, heuristic_plan_fn

    grasps, scores, toc = heuristic_plan_fn(state, *args, **kw)
    top_down = Rotation.from_euler("x", np.pi)
    assert all(np.array_equal(g.pose.rotation.as_quat(), TOP_DOWN.as_quat()) for g in grasps)
    return [Grasp(Transform(top_down, g.pose.translation), g.width) for g in grasps], scores, toc


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU work of these tests (TSDF fusion, planning) on one
    thread: the driver runs test files in parallel processes, where torch's
    thread pool per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
