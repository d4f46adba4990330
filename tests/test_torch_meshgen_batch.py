"""The port's MeshGenerator entry points against the JAX package's, on the
CPU: ``generate_mesh`` in each strategy, the band overflow's full-grid
fallback, ``generate_meshes`` against JAX's and against per-scene meshes,
normals, ``refine_mesh``, the postprocess options, ``eval_occ_logits`` and
the device check. The fixtures, tolerances and helpers are
tests/test_torch_meshgen.py's (its docstring states the rules); these cases
live in a file of their own so that each file runs in its own worker under
``pytest -n --dist loadfile``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from giga_tpu_torch.geometry.generation import MeshGenerator, fetch
from giga_tpu_torch.models.registry import get_network
from test_torch_meshgen import (  # noqa: F401  (fixtures)
    TOL_LOGIT,
    TOL_NORMALS,
    TOL_REFINE_VERTS,
    assert_meshes,
    chip_smoke,
    generators,
    jax_net,
    scenes,
    shipped,
)


@pytest.mark.parametrize("strategy,res0,steps", [("dense", 16, 1), ("refine", 16, 1),
                                                 ("refine", 8, 2)])
def test_generate_mesh_matches_jax(jax_net, shipped, scenes, strategy, res0, steps):
    j, t = generators(jax_net, shipped, resolution0=res0, upsampling_steps=steps,
                      strategy=strategy)
    mj, sj = j.generate_mesh(scenes[0])
    mt, st = t.generate_mesh(scenes[0])
    assert_meshes(mt, mj, f"{strategy} {res0}x{steps}")
    for key in ("refine (device)", "refine tier", "refine cells (band/points-per-level)"):
        assert st.get(key) == sj.get(key), key
    assert st["path"] == ("band" if strategy == "dense" else "refine (device)")


def test_band_overflow_falls_back_as_jax(jax_net, shipped, scenes):
    """A band past its budget: the full-grid decode and extract_mesh, in both."""
    j, t = generators(jax_net, shipped, resolution0=16, upsampling_steps=1, strategy="dense")
    j.band_cells = t.band_cells = 4
    j._band = jax.jit(j._build_band_eval(33))
    mj = j.generate_mesh(scenes[0], return_stats=False)
    mt, st = t.generate_mesh(scenes[0])
    assert st["path"] == "full grid"
    assert_meshes(mt, mj, "full grid")
    (grid,) = fetch(t.dense_program(t._planes))
    jgrid = np.asarray(j._dense(j.params, j._planes))
    assert grid.dtype == jgrid.dtype == np.float16
    diff = grid.astype(np.float64) - jgrid
    step = np.spacing(np.maximum(np.abs(grid), np.abs(jgrid))).astype(np.float64)
    assert (np.abs(diff) <= step + TOL_LOGIT * (1 + np.abs(jgrid))).all()


@pytest.mark.parametrize("strategy", ["dense", "refine"])
def test_generate_meshes_matches_jax_and_per_scene(jax_net, shipped, scenes, strategy):
    """The batched path: JAX's meshes, and its own per-scene meshes by
    test_band_generation's gates; a scene past the budget falls back alone."""
    j, t = generators(jax_net, shipped, resolution0=16, upsampling_steps=1, strategy=strategy)
    got = t.generate_meshes(scenes)
    for b, (m, mj) in enumerate(zip(got, j.generate_meshes(scenes))):
        assert_meshes(m, mj, f"{strategy} batched, scene {b}")
    singles = [t.generate_mesh(g) for g in scenes]
    assert [s["path"] for s in t.batch_stats] == [s["path"] for _, s in singles]
    assert chip_smoke.compare_batched(got, [m for m, _ in singles], strategy) <= 5e-3
    if strategy == "dense":
        counts = fetch(*t.band_program_batched(t.upload(scenes)))[2]
        assert counts.min() < counts.max()
        t.band_cells = int(counts.min())  # past one scene's band only
        fell = t.generate_meshes(scenes)
        paths = [s["path"] for s in t.batch_stats]
        assert "full grid" in paths and "band" in paths
        chip_smoke.compare_batched(fell, got, "band overflow in a batch")


def test_estimate_normals_matches_jax(jax_net, shipped, scenes):
    """Normals within TOL_NORMALS of JAX's, and no farther from a float64
    evaluation of the same field (the port's net in double) than JAX's:
    float32 itself puts each some 1e-5 from it at the vertices of small
    gradient (printed: JAX's 2.2e-5, the port's 6.3e-6), so two float32
    evaluations cannot be held to 1e-5 of each other."""
    import copy

    j, t = generators(jax_net, shipped, resolution0=16, upsampling_steps=1, strategy="dense")
    mj = j.generate_mesh(scenes[0], return_stats=False)
    t.generate_mesh(scenes[0])
    got, ref = t.estimate_normals(mj.vertices), j.estimate_normals(mj.vertices)
    np.testing.assert_allclose(got, ref, atol=TOL_NORMALS, rtol=0)
    assert np.allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    net64 = copy.deepcopy(t.net).double()
    planes64 = {k: v.double() for k, v in t._planes.items()}
    with torch.enable_grad():
        p = torch.tensor(mj.vertices, requires_grad=True)
        (g,) = torch.autograd.grad(net64.decode_occupancy(planes64, p[None]).sum(), p)
    exact = -g.numpy() / np.linalg.norm(g.numpy(), axis=-1, keepdims=True)
    print(f"normals from float64: JAX's {np.abs(ref - exact).max():.3g}, the port's "
          f"{np.abs(got - exact).max():.3g}; apart {np.abs(got - ref).max():.3g}")
    assert np.abs(got - exact).max() <= np.abs(ref - exact).max()


def test_refine_mesh_matches_jax(jax_net, shipped, scenes):
    """Two RMSprop steps of the vertex refinement with JAX's Dirichlet draws
    given to the port's step: vertices within TOL_REFINE_VERTS; the port's
    own draws move them as far."""
    j, t = generators(jax_net, shipped, resolution0=8, upsampling_steps=1, strategy="dense")
    mesh = j.generate_mesh(scenes[0], return_stats=False)
    t.encode(scenes[0])
    key = jax.random.PRNGKey(0)
    weights = []
    for _ in range(2):
        key, sub = jax.random.split(key)
        weights.append(np.asarray(jax.random.dirichlet(sub, jnp.ones(3), (len(mesh.faces),))))
    ref = j.refine_mesh(mesh, 2)
    got = t.refine_mesh(mesh, 2, weights=weights)
    np.testing.assert_array_equal(got.faces, ref.faces)
    np.testing.assert_allclose(got.vertices, ref.vertices, atol=TOL_REFINE_VERTS, rtol=0)
    moved = np.abs(ref.vertices - mesh.vertices).max()
    own = np.abs(t.refine_mesh(mesh, 2).vertices - mesh.vertices).max()
    assert moved > 10 * TOL_REFINE_VERTS and 0.5 * moved < own < 2 * moved


def test_simplify_and_refinement_options(jax_net, shipped, scenes):
    """simplify_nfaces and refinement_step run in the postprocess as in JAX."""
    kw = dict(resolution0=8, upsampling_steps=1, strategy="dense", simplify_nfaces=300)
    j, t = generators(jax_net, shipped, **kw)
    mj, sj = j.generate_mesh(scenes[0])
    mt, st = t.generate_mesh(scenes[0])
    assert len(mt.faces) == len(mj.faces) <= 300 and "time (simplify)" in st
    t.refinement_step = 1
    mr, sr = t.generate_mesh(scenes[0])
    assert "time (refine)" in sr and len(mr.faces) == len(mt.faces)
    assert 0 < np.abs(mr.vertices - mt.vertices).max() < 1e-2


def test_eval_occ_logits_matches_jax(jax_net, shipped, scenes):
    j, t = generators(jax_net, shipped, resolution0=8, upsampling_steps=1, strategy="dense",
                      points_batch_size=20000)
    j.encode(scenes[0])
    t.encode(scenes[0])
    pts = np.random.RandomState(0).uniform(-0.5, 0.5, (50000, 3)).astype(np.float32)
    got, ref = t.eval_occ_logits(pts), j.eval_occ_logits(pts)
    assert got.shape == ref.shape == (50000,)
    np.testing.assert_allclose(got, ref, atol=TOL_LOGIT * (1 + np.abs(ref).max()), rtol=0)
    assert t.eval_occ_logits(pts[:0]).shape == (0,)


def test_device_none_needs_a_card(monkeypatch, shipped):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MeshGenerator(get_network("giga_geo")[0], shipped)
    with pytest.raises(ValueError):
        MeshGenerator(get_network("giga_geo")[0], shipped, device="cpu", strategy="octree")
