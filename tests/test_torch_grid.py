"""The giga_grid family in the port (models/unet3d.py, the encoder's scatter
path and grid branch, GlobalVoxelEncoder, the grid lattice features of the
planning programs) on the CPU
against the JAX package, on JAX's seeded ``net.init`` weights.

The reference is the JAX package's function evaluated in float64
(``jax.enable_x64``, params and inputs cast): its float32 CPU evaluation of
a GroupNorm model carries flax GroupNorm's float32 statistics error, which
on a TSDF with flat regions is far larger than the port's (1.6e-3 against
6e-7 at the first GroupNorm of giga_grid on chip_smoke's first scene; 2.8e-3
on its grid, against the port's 6e-6; each case prints the distances). The
port's float32 is held within 2e-5 * (1 + |b|) of the float64 reference
(the repo's forward tolerance). Models without a GroupNorm (the triplane scatter path,
GlobalVoxelEncoder) are held to JAX's float32 within 2e-5. Decisions
(counts and positions) are equal, scores and widths within 1e-5.

The golden file, the train step and the mesh band are in
tests/test_torch_grid_golden.py.
"""

import copy
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from giga_tpu.core.config import EncoderConfig as JEncoderConfig  # noqa: E402
from giga_tpu.core.config import PlannerConfig as JPlannerConfig  # noqa: E402
from giga_tpu.core.config import UNet2DConfig as JUNet2DConfig  # noqa: E402
from giga_tpu.core.config import UNet3DConfig as JUNet3DConfig  # noqa: E402
from giga_tpu.inference.planner import (  # noqa: E402
    build_batched_giga_planner_fn as jax_build_batched,
    build_giga_planner_fn as jax_build_single,
)
from giga_tpu.models.encoder import GlobalVoxelEncoder as JGlobalVoxelEncoder  # noqa: E402
from giga_tpu.models.encoder import TriplaneVoxelEncoder as JTriplaneVoxelEncoder  # noqa: E402
from giga_tpu.models.registry import get_network as jax_get_network  # noqa: E402
from giga_tpu.models.unet3d import UNet3D as JUNet3D  # noqa: E402
from giga_tpu_torch.core.config import (  # noqa: E402
    EncoderConfig,
    PlannerConfig,
    UNet2DConfig,
    UNet3DConfig,
    get_config,
)
from giga_tpu_torch.inference.dense_decode import (  # noqa: E402
    decode_affordance_dense,
    lattice_coords,
    lattice_features,
)
from giga_tpu_torch.inference.planner import (  # noqa: E402
    GIGAPlanner,
    State,
    build_batched_giga_planner_fn,
    build_giga_planner_fn,
    program_paths,
)
from giga_tpu_torch.models.convert import (  # noqa: E402
    _unet3d_state_dict,
    _tensors,
    flax_to_state_dict,
)
from giga_tpu_torch.models.encoder import GlobalVoxelEncoder, TriplaneVoxelEncoder  # noqa: E402
from giga_tpu_torch.models.registry import get_network  # noqa: E402
from giga_tpu_torch.models.unet3d import UNet3D, nearest_resize  # noqa: E402

TOL = 2e-5
TOL_SCORE = 1e-5
N_GOLDEN = 4


def f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def jax_ref(fn, params, *args):
    """(fn(params, *args) in float32, the same in float64) as numpy trees;
    ``fn`` jitted by the caller, so each precision is one program."""
    f32 = jax.device_get(fn(params, *(jnp.asarray(a) for a in args)))
    with jax.enable_x64(True):
        d = jax.device_get(fn(f64(params), *(jnp.asarray(np.asarray(a, np.float64))
                                             for a in args)))
    return f32, d


def check_f64(got, ref32, ref64, what: str, tol: float = TOL):
    """The port within ``tol`` * (1 + |b|) of the float64 reference; prints
    its distance and JAX's float32's."""
    got, ref32, ref64 = (np.asarray(a, np.float64) for a in (got, ref32, ref64))
    port = float((np.abs(got - ref64) / (1 + np.abs(ref64))).max())
    jax32 = float((np.abs(ref32 - ref64) / (1 + np.abs(ref64))).max())
    print(f"{what}: the port {port:.3g} * (1 + |b|) from JAX's float64, JAX's float32 "
          f"{jax32:.3g}, the port from JAX's float32 {np.abs(got - ref32).max():.3g}")
    assert port <= tol, what


@pytest.fixture(scope="module")
def grid_params():
    """JAX's seeded giga_grid params (PRNGKey 0), the golden file's."""
    jnet, _ = jax_get_network("giga_grid")
    z, p = jnp.zeros((1, 40, 40, 40)), jnp.zeros((1, 1, 3))
    return jax.device_get(jax.jit(jnet.init)(jax.random.PRNGKey(0), z, p, p))


@pytest.fixture(scope="module")
def grid_net(grid_params):
    net, _ = get_network("giga_grid")
    net.load_state_dict(flax_to_state_dict(grid_params))
    return net.eval()


def test_nearest_resize_matches_jax_formula():
    from giga_tpu.models.unet3d import _nearest_resize

    x = np.random.RandomState(0).rand(1, 12, 7, 5, 3).astype(np.float32)
    ref = np.asarray(_nearest_resize(jnp.asarray(x), (25, 13, 5)))
    got = nearest_resize(torch.from_numpy(x).permute(0, 4, 1, 2, 3), (25, 13, 5))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), ref)


@pytest.mark.parametrize("size", [16, 25])
def test_unet3d_matches_jax(size):
    """f_maps 8, 2 levels, 4 channels in and out, at an even size and at an
    odd one (pooled 25 -> 12, resized back by the JAX index formula)."""
    ju = JUNet3D(4, f_maps=8, num_levels=2)
    x = np.random.RandomState(size).rand(2, size, size, size, 4).astype(np.float32)
    params = jax.device_get(jax.jit(ju.init)(jax.random.PRNGKey(1), jnp.asarray(x)))
    sd = {}
    _unet3d_state_dict(sd, "u", params["params"])
    net = UNet3D(4, 4, f_maps=8, num_levels=2)
    net.load_state_dict({k[2:]: v for k, v in _tensors(sd).items()})
    with jax.default_matmul_precision("highest"):
        ref32, ref64 = jax_ref(jax.jit(ju.apply), params, x)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == ref64.shape == (2, size, size, size, 4)
    check_f64(got, ref32, ref64, f"UNet3D at {size}^3")


def _encoders(jcfg, cfg, shape, seed=0):
    jenc = JTriplaneVoxelEncoder(jcfg)
    x = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    params = jax.device_get(jenc.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    enc = TriplaneVoxelEncoder(cfg)
    sd = {k[len("encoder."):]: v for k, v in flax_to_state_dict(
        {"params": {"encoder": params["params"]}}).items()}
    enc.load_state_dict(sd)
    return jenc, params, enc.eval(), x


def test_encoder_scatter_path_matches_jax():
    """16^3 voxels onto 8^2 planes (the lattice points on cell boundaries
    where 15 divides into 8 cells) and padding 0.1 at 8^3: the scatter-mean
    planes and the U-Net's output within 2e-5 of JAX's float32."""
    for res, pad in ((16, 0.0), (8, 0.1)):
        kw = dict(c_dim=8, plane_resolution=8, padding=pad)
        jenc, params, enc, x = _encoders(
            JEncoderConfig(unet=JUNet2DConfig(depth=2, start_filts=8), **kw),
            EncoderConfig(unet=UNet2DConfig(depth=2, start_filts=8), **kw), (2, res, res, res))
        with jax.default_matmul_precision("highest"):
            ref = jax.device_get(jenc.apply(params, jnp.asarray(x)))
        with torch.no_grad():
            got = enc(torch.from_numpy(x))
        for t in ("xz", "xy", "yz"):
            assert got[t].shape == ref[t].shape == (2, 8, 8, 8)
            np.testing.assert_allclose(got[t].numpy(), ref[t], atol=TOL, rtol=0,
                                       err_msg=f"{res}^3 pad {pad} {t}")


@pytest.mark.parametrize("res", [8, 12])
def test_encoder_grid_branch_matches_jax(res):
    """The grid branch onto an 8^3 grid: the transpose at 8^3 input, the
    scatter-mean at 12^3; 3D U-Net f_maps 8 at 2 levels."""
    u3 = dict(f_maps=8, num_levels=2)
    kw = dict(c_dim=8, plane_types=("grid",), grid_resolution=8)
    jenc, params, enc, x = _encoders(JEncoderConfig(unet3d=JUNet3DConfig(**u3), **kw),
                                     EncoderConfig(unet3d=UNet3DConfig(**u3), **kw),
                                     (2, res, res, res))
    with jax.default_matmul_precision("highest"):
        ref32, ref64 = jax_ref(jax.jit(jenc.apply), params, x)
    with torch.no_grad():
        got = enc(torch.from_numpy(x))["grid"].numpy()
    assert got.shape == (2, 8, 8, 8, 8)
    check_f64(got, ref32["grid"], ref64["grid"], f"grid branch from {res}^3")


def test_global_voxel_encoder_matches_jax():
    jenc = JGlobalVoxelEncoder(c_dim=16)
    x = np.random.RandomState(0).rand(2, 32, 32, 32).astype(np.float32)
    params = jax.device_get(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    enc = GlobalVoxelEncoder(c_dim=16)
    enc.load_state_dict(flax_to_state_dict(params))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jenc.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
        got5 = enc(torch.from_numpy(x)[:, None]).numpy()
    assert got.shape == (2, 16)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    np.testing.assert_array_equal(got, got5)


def test_giga_grid_forward_matches_jax(grid_params, grid_net):
    """GIGANet's forward (encode, affordance and occupancy at points) on a
    random TSDF and on chip_smoke's first scene."""
    jnet, _ = jax_get_network("giga_grid")
    apply = jax.jit(jnet.apply)  # one program a precision for both TSDFs
    rng = np.random.RandomState(0)
    p = rng.uniform(-0.5, 0.5, (1, 64, 3)).astype(np.float32)
    for name, tsdf in (("random", rng.rand(1, 40, 40, 40).astype(np.float32)),
                       ("scene", chip_smoke.make_scenes(1))):
        with jax.default_matmul_precision("highest"):
            ref32, ref64 = jax_ref(apply, grid_params, tsdf, p, p)
        with torch.no_grad():
            got = grid_net(torch.from_numpy(tsdf), torch.from_numpy(p), torch.from_numpy(p))
        assert set(got) == set(ref64) == {"qual", "rot", "width", "occ"}
        for k in got:
            check_f64(got[k].numpy(), ref32[k], ref64[k], f"giga_grid {name} {k}")


def test_lattice_decode_matches_point_decode(grid_net):
    """The planner's trilinear lattice decode equals the module's decode at
    the lattice points (tests/test_planner.py:99-119)."""
    tsdf = torch.from_numpy(np.random.RandomState(1).rand(1, 40, 40, 40).astype(np.float32))
    coords = lattice_coords(40)
    with torch.no_grad():
        planes = grid_net.encode(tsdf)
        pts = torch.stack(torch.meshgrid(coords, coords, coords, indexing="ij"), -1)
        qual_g, rot_g, width_g = grid_net.decode_affordance(planes, pts.reshape(1, -1, 3))
        feats = lattice_features({t: v[0] for t, v in planes.items()}, coords, grid_net.cfg)
        qd, rd, wd = decode_affordance_dense(grid_net.decoder_aff.params(), feats, coords)
    np.testing.assert_allclose(qd.reshape(-1).numpy(), qual_g[0].numpy(), atol=TOL)
    np.testing.assert_allclose(rd.reshape(-1, 4).numpy(), rot_g[0].numpy(), atol=TOL)
    np.testing.assert_allclose(wd.reshape(-1).numpy(), width_g[0].numpy(), atol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_program_paths_take_the_module_for_a_grid_model(dtype):
    """A grid model encodes on the module path; it decodes on K6 in the
    batched float32 program only, elsewhere on the module path."""
    cfg = get_config("giga_grid")
    for batched in (False, True):
        decode = "K6" if batched and dtype == torch.float32 else "module"
        assert program_paths(cfg, PlannerConfig(), dtype, True, batched) == {
            "encode": "module", "decode": decode}
        assert program_paths(cfg, PlannerConfig(), dtype, False, batched) == {
            "encode": "module", "decode": "module"}


def grid_planner_cfg(cls):
    return cls(**{k: v for k, v in chip_smoke.GRID_KW.items()},
               min_width=chip_smoke.GRID_WIDTHS[0], max_width=chip_smoke.GRID_WIDTHS[1])


def jax_grid_candidates(params, tsdf):
    """JAX's float64 single-scene candidates of each scene, and its float64
    batched program's, as numpy GraspCandidates stacked over scenes."""
    jnet, jcfg = jax_get_network("giga_grid")
    pcfg = grid_planner_cfg(JPlannerConfig)
    with jax.enable_x64(True):
        p64 = f64(params)
        single = jax_build_single(jnet, jcfg, pcfg, chip_smoke.SIZE)
        calls = [jax.device_get(single(p64, jnp.asarray(g, jnp.float64), jnp.asarray(g)))[0]
                 for g in tsdf]
        batched = jax_build_batched(jnet, jcfg, pcfg, chip_smoke.SIZE)
        batch = jax.device_get(batched(p64, jnp.asarray(tsdf, jnp.float64),
                                       jnp.asarray(tsdf)))[0]
    call = type(batch)(*(np.stack([np.asarray(getattr(c, f)) for c in calls])
                         for f in batch._fields))
    return call, type(batch)(*(np.asarray(v) for v in batch))


def test_call_and_plan_batch_match_jax(grid_net):
    """GIGAPlanner(model_type="giga_grid").__call__ and plan_batch on the CPU:
    __call__ on the module path, plan_batch on K6's plain version, and
    decisions equal to the golden's (JAX's float64 programs) on its first
    scene."""
    golden = np.load(REPO / chip_smoke.GOLDEN_GRID)
    planner = GIGAPlanner(net=copy.deepcopy(grid_net), model_type="giga_grid", device="cpu",
                          rng=np.random.RandomState(0), **chip_smoke.GRID_KW)
    planner.planner_cfg = dataclasses.replace(planner.planner_cfg,
                                              min_width=chip_smoke.GRID_WIDTHS[0],
                                              max_width=chip_smoke.GRID_WIDTHS[1])
    assert planner._ensure_fn().paths == {"encode": "module", "decode": "module"}
    assert planner._ensure_batched_fn().paths == {"encode": "module", "decode": "K6"}
    tsdf = golden["tsdf"][:1]
    called = planner(State(tsdf=tsdf))[:2]
    batched = planner.plan_batch(tsdf)[0]
    voxel = chip_smoke.SIZE / 40
    for prefix, got in (("call_", called), ("batch_", batched)):
        from giga_tpu_torch.inference.postprocess import GraspCandidates

        ref = planner._to_grasps(GraspCandidates(*(golden[prefix + f][0]
                                                   for f in GraspCandidates._fields)))
        assert len(got[0]) > 0
        chip_smoke.compare_grasps(got, ref, voxel, f"giga_grid {prefix}", tol=TOL_SCORE)


def test_batched_program_equals_single_scene(grid_net):
    pcfg = grid_planner_cfg(PlannerConfig)
    single = build_giga_planner_fn(grid_net, grid_net.cfg, pcfg, chip_smoke.SIZE,
                                   use_kernels=True, return_raw=True)
    batched = build_batched_giga_planner_fn(grid_net, grid_net.cfg, pcfg, chip_smoke.SIZE,
                                            use_kernels=True, return_raw=True)
    tsdf = torch.from_numpy(chip_smoke.make_scenes(2))
    cb, (qual, rot, width) = batched(tsdf, tsdf)
    assert batched.paths["decode"] == "K6"
    rot = rot.permute(0, 2, 1).reshape(2, 40, 40, 40, 4)  # K6 leaves rot (B, 4, R^3)
    for i in range(2):
        c, raw = single(tsdf[i], tsdf[i])
        for a, b in zip(raw, (qual, rot, width)):
            np.testing.assert_allclose(a.numpy(), b[i].numpy(), atol=TOL_SCORE, rtol=0)
        n = int(c.count)
        assert n == int(cb.count[i]) > 0
        np.testing.assert_array_equal(c.positions[:n].numpy(), cb.positions[i, :n].numpy())
