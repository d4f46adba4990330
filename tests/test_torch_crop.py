"""The port's crop model and sliding-window reconstruction (models/crop.py,
geometry/sliding_window.py) against the JAX package's on the CPU, at
tests/test_crop_model.py's and tests/test_sliding_window.py's sizes, JAX's
side jitted.

Crop indices are held equal, on points at and next to cell edges. The crop
model's logits are held within 2e-5 * (1 + |b|) and its gradients within
1e-5 * (1 + max |g|) of JAX's on the same weights; three Adam steps of it
(the port's ``Adam(lr=5e-4)``, optax.adam's arithmetic) within the same
bounds of ``optax.adam(5e-4)``'s. ``SlidingWindowGenerator`` on the analytic
sphere gives JAX's mesh exactly; ``CropGenerator`` on a small scene gives
JAX's crops (the same draws from one seed) within 2e-5 * (1 + |b|), and so
its mesh: the same faces where no corner changes sign.
"""

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
from giga_tpu.core.config import EncoderConfig as JEncoderConfig  # noqa: E402
from giga_tpu.core.config import UNet3DConfig as JUNet3DConfig  # noqa: E402
from giga_tpu.geometry import sliding_window as JSW  # noqa: E402
from giga_tpu.models import crop as JC  # noqa: E402
from giga_tpu_torch.core.config import EncoderConfig, UNet3DConfig  # noqa: E402
from giga_tpu_torch.geometry import sliding_window as TSW  # noqa: E402
from giga_tpu_torch.models import crop as TC  # noqa: E402
from giga_tpu_torch.train.trainer import Adam  # noqa: E402
from torch_points import close, close_grads, jax_fwd_grad, jax_grads_as_port, port_grads, seeded  # noqa: E402,E501


def tiny(m, reso=8, hidden=16, n_blocks=2, grid=False):
    """tests/test_crop_model.py's tiny_net (unit size 0.05) in package ``m``;
    ``grid``: TestCropGeneratorGridWiring's grid-only configuration."""
    cfg, u3 = (JEncoderConfig, JUNet3DConfig) if m is JC else (EncoderConfig, UNet3DConfig)
    enc = (cfg(c_dim=16, plane_resolution=reso, plane_types=("grid",), grid_resolution=8,
               unet3d=u3(f_maps=8, num_levels=2, num_groups=2)) if grid
           else cfg(c_dim=16, plane_resolution=reso))
    return m.CropOccupancyNet(enc, hidden_dim=hidden, n_blocks=n_blocks, unit_size=0.05)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_crop_indices_at_cell_edges():
    """Points on every cell edge of an 8-cell crop (u * reso an integer),
    an ulp either side of them, and past the crop: plane and grid ids and
    the query coordinates equal JAX's."""
    reso = 8
    vol = (np.array([0.1, -0.2, 0.05], np.float32), np.array([0.5, 0.2, 0.45], np.float32))
    edges = vol[0] + (vol[1] - vol[0]) * (np.arange(-1, reso + 2) / reso)[:, None]
    pts = np.concatenate([edges, np.nextafter(edges, np.inf), np.nextafter(edges, -np.inf)])
    rng = np.random.RandomState(0)
    pts = np.stack([pts[rng.permutation(len(pts)), d] for d in range(3)], -1)[None]
    pts = pts.astype(np.float32)
    jidx = JC.crop_plane_indices(jnp.asarray(pts), vol, reso)
    tidx = TC.crop_plane_indices(_t(pts), tuple(_t(v) for v in vol), reso)
    for t in ("xz", "xy", "yz"):
        np.testing.assert_array_equal(tidx[t].numpy(), np.asarray(jidx[t]))
    np.testing.assert_array_equal(TC.crop_grid_indices(_t(pts), tuple(_t(v) for v in vol), reso)
                                  .numpy(), np.asarray(JC.crop_grid_indices(pts, vol, reso)))
    jq = JC.crop_query_coords(jnp.asarray(pts), vol, ("xz", "xy", "yz", "grid"))
    tq = TC.crop_query_coords(_t(pts), tuple(_t(v) for v in vol), ("xz", "xy", "yz", "grid"))
    for t in jq:
        np.testing.assert_array_equal(tq[t].numpy(), np.asarray(jq[t]))


def _batch(rng, surface, lo_hi=(0.0, 0.4), T=64, N=32):
    p = rng.uniform(*lo_hi, (1, T, 3)).astype(np.float32) if surface is None else surface
    q = rng.uniform(*lo_hi, (1, N, 3)).astype(np.float32)
    vol = (np.full(3, lo_hi[0], np.float32), np.full(3, lo_hi[1], np.float32))
    return p, q, vol


def test_grid_crop_model_forward_and_grad():
    """The grid-only model of TestCropGeneratorGridWiring on
    tests/test_crop_model.py::test_forward_shapes_and_grads' inputs. The
    planes model's gradients are held by test_three_adam_steps_match_optax
    (its parameters after three steps)."""
    rng = np.random.RandomState(0)
    p, q, vol = _batch(rng, None)
    jnet, tnet = tiny(JC, grid=True), tiny(TC, grid=True)
    idx = {"grid": JC.crop_grid_indices(p, vol, 8)}
    q_n = JC.crop_query_coords(jnp.asarray(q), vol, ("grid",))
    ref, gref = jax_fwd_grad(jnet, seeded(tnet), p, idx, q, q_n)
    tv = tuple(_t(a) for a in vol)
    out = tnet(_t(p), {"grid": TC.crop_grid_indices(_t(p), tv, 8)}, _t(q),
               TC.crop_query_coords(_t(q), tv, ("grid",)))
    assert out.shape == (1, 32)
    close(out, ref)
    close_grads(port_grads(tnet, out), jax_grads_as_port(gref))


def test_three_adam_steps_match_optax():
    """tests/test_crop_model.py's training step (sigmoid cross-entropy on the
    crop's occupancy, Adam 5e-4) three times on seeded crops of a sphere."""
    import optax

    from giga_tpu.geometry.native import check_mesh_contains
    from giga_tpu.utils.synthetic import icosphere

    mesh = icosphere(0.12, np.array([0.2, 0.2, 0.2]), subdivisions=2)
    rng = np.random.RandomState(0)
    surface, _ = mesh.sample_surface(4000, rng=rng)
    batches = []
    for _ in range(3):
        lo = rng.uniform(-0.05, 0.25, 3).astype(np.float32)
        in_lo, in_hi = lo - 0.05, lo + 0.25
        crop = surface[np.all((surface >= in_lo) & (surface <= in_hi), axis=1)]
        p = crop[rng.randint(0, len(crop), 256)].astype(np.float32)[None]
        q = rng.uniform(lo, lo + 0.2, (1, 128, 3)).astype(np.float32)
        occ = check_mesh_contains(mesh, q[0]).astype(np.float32)[None]
        batches.append((p, q, occ, (in_lo.astype(np.float32), in_hi.astype(np.float32))))
    jnet, tnet = tiny(JC), tiny(TC)
    v = seeded(tnet)
    opt = optax.adam(5e-4)

    @jax.jit
    def step(params, state, p, q, occ, lo, hi):
        def loss_fn(pp):
            logits = jnet.apply({"params": pp}, p, JC.crop_plane_indices(p, (lo, hi), 8), q,
                                JC.crop_query_coords(q, (lo, hi)))
            return optax.sigmoid_binary_cross_entropy(logits, occ).mean()

        loss, g = jax.value_and_grad(loss_fn)(params)
        upd, state = opt.update(g, state)
        return optax.apply_updates(params, upd), state, loss

    params, state = v["params"], opt.init(v["params"])
    adam = Adam(tnet.parameters(), lr=5e-4, clip_norm=None, skip_nonfinite=False)
    for p, q, occ, (lo, hi) in batches:
        params, state, jloss = step(params, state, p, q, occ, lo, hi)
        tv = (_t(lo), _t(hi))
        logits = tnet(_t(p), TC.crop_plane_indices(_t(p), tv, 8), _t(q),
                      TC.crop_query_coords(_t(q), tv))
        target = _t(occ)
        loss = -(target * torch.nn.functional.logsigmoid(logits)
                 + (1 - target) * torch.nn.functional.logsigmoid(-logits)).mean()
        tnet.zero_grad()
        loss.backward()
        adam.update(list(tnet.parameters()), [x.grad for x in tnet.parameters()])
        close(loss.detach(), jloss)
    got = {k: x.detach().numpy() for k, x in tnet.state_dict().items()}
    ref = jax_grads_as_port(jax.device_get(params))
    close_grads(got, ref)


def test_sliding_window_analytic_sphere_equals_jax():
    """tests/test_sliding_window.py's analytic sphere across 8 crops (24^3
    queries each): the port's mesh is JAX's, and watertight."""
    center, radius = np.array([0.5, 0.5, 0.5]), 0.3
    dirs = np.random.RandomState(0).randn(2000, 3)
    surface = center + dirs / np.linalg.norm(dirs, axis=1, keepdims=True) * radius

    def evaluate(latent, q, vol):
        return (radius - np.linalg.norm(q - center, axis=1)) * 50.0

    meshes = [m.SlidingWindowGenerator(lambda pts, vol: None, evaluate, resolution=24)
              .generate_mesh(surface, query_crop_size=0.45, input_crop_size=0.6)
              for m in (TSW, JSW)]
    np.testing.assert_array_equal(meshes[0].faces, meshes[1].faces)
    np.testing.assert_array_equal(meshes[0].vertices, meshes[1].vertices)
    f = meshes[0].faces
    edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
    assert np.all(np.unique(edges, axis=0, return_counts=True)[1] == 2)
    for key in ("query_vol", "input_vol", "axis_n_crop"):
        np.testing.assert_array_equal(TSW.compute_crop_bounds(surface, 0.45, 0.6)[key],
                                      JSW.compute_crop_bounds(surface, 0.45, 0.6)[key])


def test_crop_generator_matches_jax():
    """Both packages' CropGenerator on 1,500 surface points of a synthetic
    scene (0.2 m query crops, 0.3 m input crops, 16^3 queries, 256 points a
    crop, RandomState(0)): every crop's logits within 2e-5 * (1 + |b|), and
    the mesh: equal faces where no corner changes sign, vertices within
    1e-6 m."""
    objects = chip_smoke.scene_objects(1)[0]
    pts = chip_smoke.surface_mesh(objects).sample_surface(1500, rng=np.random.RandomState(1))[0]
    jnet, tnet = tiny(JC), tiny(TC)
    v = seeded(tnet)
    kw = dict(n_crop_points=256, resolution=16)
    jgen = JC.CropGenerator(jnet, v, rng=np.random.RandomState(0), **kw)
    tgen = TC.CropGenerator(tnet, v, rng=np.random.RandomState(0), device="cpu", **kw)
    (tm, tl), (jm, jl) = (chip_smoke.record_crops(g, pts, 0.2, 0.3) for g in (tgen, jgen))
    res = chip_smoke.compare_crops(tl, jl, "crop generator")
    assert len(tl) > 1 and len(jm.faces) > 0
    if res["flips"] == 0:
        np.testing.assert_array_equal(tm.faces, jm.faces)
        np.testing.assert_allclose(tm.vertices, jm.vertices, atol=1e-6, rtol=0)
