"""giga_grid's golden file, train step and mesh band in the port against the
JAX package's float64 programs, on the CPU (the rules and the helpers are
tests/test_torch_grid.py's; these cases live in a file of their own so that
each file runs in its own worker under ``pytest -n --dist loadfile``).

``giga_tpu_torch/testdata/golden_plan_giga_grid.npz`` carries JAX's seeded
weights and its float64 programs' candidates on chip_smoke's first scenes
to the card (chip_smoke.py phase 29); this file asserts that it is current.
Rewrite it with

    JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write grid
"""

import copy
import sys
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from giga_tpu.geometry.generation import MeshGenerator as JMeshGenerator  # noqa: E402
from giga_tpu.models.registry import get_network as jax_get_network  # noqa: E402
from giga_tpu.train import trainer as jt  # noqa: E402
from giga_tpu_torch.geometry.generation import MeshGenerator, fetch  # noqa: E402
from giga_tpu_torch.models.convert import flax_to_state_dict  # noqa: E402
from giga_tpu_torch.models.registry import get_network  # noqa: E402
from giga_tpu_torch.train import trainer as tt  # noqa: E402
from test_torch_grid import (  # noqa: E402,F401  (fixtures)
    N_GOLDEN,
    TOL,
    f64,
    grid_net,
    grid_params,
    jax_grid_candidates,
)


def golden_grid_arrays() -> dict:
    """JAX's seeded giga_grid params (under "params/") and the candidates of
    its float64 single-scene ("call_") and batched ("batch_") programs on
    chip_smoke's first N_GOLDEN scenes."""
    jnet, _ = jax_get_network("giga_grid")
    z, p = jnp.zeros((1, 40, 40, 40)), jnp.zeros((1, 1, 3))
    params = jax.device_get(jnet.init(jax.random.PRNGKey(0), z, p, p))
    tsdf = chip_smoke.make_scenes(N_GOLDEN)
    call, batch = jax_grid_candidates(params, tsdf)
    out = chip_smoke.flatten_params(params)
    for prefix, cands in (("call_", call), ("batch_", batch)):
        for f in cands._fields:
            out[prefix + f] = np.asarray(getattr(cands, f),
                                         np.int32 if f == "count" else np.float32)
    out["tsdf"] = tsdf
    return out


def test_grid_golden_file_is_current(grid_params):
    stored = np.load(REPO / chip_smoke.GOLDEN_GRID)
    flat = chip_smoke.flatten_params(grid_params)
    assert set(flat) == {k for k in stored.files if k.startswith("params/")}
    for k, v in flat.items():
        np.testing.assert_array_equal(stored[k], v, err_msg=k)
    tsdf = stored["tsdf"]
    np.testing.assert_allclose(tsdf, chip_smoke.make_scenes(N_GOLDEN), atol=1e-6)
    call, batch = jax_grid_candidates(grid_params, tsdf)
    for prefix, cands in (("call_", call), ("batch_", batch)):
        ref = type(cands)(*(stored[prefix + f] for f in cands._fields))
        chip_smoke.compare_candidates(cands, ref, range(N_GOLDEN), 40, f"golden {prefix}",
                                      tol=1e-6)


def test_train_step_matches_jax(grid_params, grid_net):
    """One fp32 step (mm sampler) at B=4 with 16 occupancy points a sample
    against JAX's step in float64: loss terms within 1e-5 * (1 + |b|), each
    gradient leaf within TOL_TRAIN_GRAD_F64 * (1 + max |g|), PR 14's bound
    for a float32 gradient against a float64 one (chip_smoke.py); the port's
    distance is printed."""
    from test_torch_train import batch, jax_state, leaf_errors

    net = copy.deepcopy(grid_net)
    cfg = net.cfg
    jnet, jcfg, jstate = jax_state("giga_grid", net)
    b = batch()
    loss_fn = jt.make_loss_fn(jt._with_sampler(jnet, jcfg, "mm"), jcfg)
    with jax.enable_x64(True):
        (_, (jterms, _)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            f64(jax.device_get(jstate.params)),
            {k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32 else v)
             for k, v in b.items()})
    state = tt.create_train_state(net, device="cpu")
    (_, (terms, _)), grads = tt.make_value_and_grad(net, cfg)(state.params,
                                                               tt.to_device(b, "cpu"))
    for k in jterms:
        ref = float(jterms[k])
        assert abs(float(terms[k]) - ref) <= 1e-5 * (1 + abs(ref)), k
    ref = flax_to_state_dict(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                          jax.device_get(jgrads)))
    errs = leaf_errors(dict(zip(state.params, grads)), ref)
    print(f"gradients from JAX's float64 step: the port {max(errs.values()):.3g} "
          f"* (1 + max |g|)")
    assert max(errs.values()) <= chip_smoke.TOL_TRAIN_GRAD_F64, sorted(
        errs.items(), key=lambda e: -e[1])[:3]
    state.apply_gradients(grads)
    assert state.step == 1 and all(torch.isfinite(v).all() for v in state.params.values())


def test_mesh_band_33_matches_jax(grid_params):
    """MeshGenerator on giga_grid: the 33^3 band program against JAX's run in
    float64 (same cells, corners within one float16 step + 2e-5 (1 + |b|)),
    and ``refine`` takes the host path in both, scene by scene."""
    jnet, _ = jax_get_network("giga_grid")
    tsdf = chip_smoke.make_scenes(1)[0]
    kw = dict(resolution0=16, upsampling_steps=1, strategy="dense")
    with jax.enable_x64(True):
        j = JMeshGenerator(jnet, f64(grid_params), **kw)
        # JAX's encode() casts the TSDF to float32; its float64 planes directly
        planes = jnet.apply(j.params, jnp.asarray(tsdf[None], jnp.float64), method="encode")
        ref = jax.device_get(j._band(j.params, planes))
    gen = MeshGenerator(get_network("giga_grid")[0], grid_params, device="cpu", **kw)
    gen.encode(tsdf)
    got = fetch(*gen.band_program(gen._planes))
    n = int(ref[2])
    assert int(got[2]) == n > 0
    np.testing.assert_array_equal(got[0], ref[0])
    a, b = got[1][:n].astype(np.float64), ref[1][:n].astype(np.float64)
    step = np.spacing(np.maximum(np.abs(got[1][:n]), np.abs(ref[1][:n]))).astype(np.float64)
    assert (np.abs(a - b) <= step + TOL * (1 + np.abs(b))).all()
    refine = MeshGenerator(get_network("giga_grid")[0], grid_params, device="cpu",
                           resolution0=8, upsampling_steps=1, strategy="refine")
    mesh, stats = refine.generate_mesh(tsdf)
    assert stats["path"] == "refine (host)" and len(mesh.faces) > 0
    meshes = refine.generate_meshes(np.stack([tsdf, tsdf]))
    assert [s["path"] for s in refine.batch_stats] == ["refine (host)"] * 2
    np.testing.assert_array_equal(meshes[0].faces, mesh.faces)
