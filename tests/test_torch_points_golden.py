"""The JAX golden of chip_smoke.py's phases 31-32, kept current.

``giga_tpu_torch/testdata/golden_points.npz`` holds, for the first
``POINT_CHECK`` clouds of phase 31 and its seeded weights
(``chip_smoke.point_models``), the JAX package's outputs of each model:
LocalPoolPointnet's planes (float32), the same with its 32^3 grid branch
(float64: a GroupNorm enters), FCDecoder on those planes, PointNet++ in
eval mode (float32) and in train mode (float64, at a batch of POINT_CHECK:
train-mode BatchNorm normalizes by the batch), and LocalPointDecoder on
PointNet++'s features: ``GOLDEN_ENTRIES`` seeded entries and the sum of
each (``chip_smoke.golden_record``). And phase 32's seeded crop model's
logits on the first ``CROP_GOLDEN`` crops of its scene, through JAX's
CropGenerator with the same draws. Rewrite it with

    JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write points
"""

import sys
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from giga_tpu.core.config import DecoderConfig as JDecoderConfig  # noqa: E402
from giga_tpu.core.config import EncoderConfig as JEncoderConfig  # noqa: E402
from giga_tpu.models import crop as jcrop  # noqa: E402
from giga_tpu.models import decoder as jdec  # noqa: E402
from giga_tpu.models import pointnet as jpn  # noqa: E402
from giga_tpu.models import pointnetpp as jpp  # noqa: E402
from giga_tpu.ops.sampling import PLANE_AXES  # noqa: E402
from giga_tpu_torch.models.convert import state_dict_to_flax  # noqa: E402
from test_torch_pointnetpp import jax_fps_x64  # noqa: E402
from torch_points import f64  # noqa: E402


def _variables(model) -> dict:
    return state_dict_to_flax(model.state_dict())


def golden_points_arrays(float64: bool = True) -> dict:
    """The golden's arrays; without ``float64`` the JAX float64 entries
    (lppg_*, pp_train) are left out."""
    n = chip_smoke.POINT_CHECK
    models, x = chip_smoke.point_models(), chip_smoke.point_inputs()
    clouds, pp, q, ppq = (x[k][:n] for k in ("clouds", "pp", "queries", "pp_queries"))
    out = {}
    lpp = jpn.LocalPoolPointnet(JEncoderConfig())
    planes = jax.device_get(jax.jit(lpp.apply)(_variables(models["lpp"]), clouds))
    for t in PLANE_AXES:
        out.update(chip_smoke.golden_record(f"lpp_{t}", planes[t]))
    fc = jdec.FCDecoder(JDecoderConfig())
    out.update(chip_smoke.golden_record("fc", jax.jit(fc.apply)(
        _variables(models["fc"]), planes, q)))
    net = jpp.PointNetPlusPlus(c_dim=32)
    v = _variables(models["pp"])
    feats = jax.device_get(jax.jit(net.apply)(v, pp))[1]
    out.update(chip_smoke.golden_record("pp_eval", feats))
    lpd = jdec.LocalPointDecoder(JDecoderConfig(concat_feat=False), sigma=chip_smoke.POINT_SIGMA)
    out.update(chip_smoke.golden_record("lpd", jax.jit(lpd.apply)(
        _variables(models["lpd"]), pp, feats, ppq)))
    crop = chip_smoke.crop_net()
    gen = jcrop.CropGenerator(jcrop.CropOccupancyNet(), _variables(crop),
                              n_crop_points=chip_smoke.CROP_POINTS,
                              resolution=chip_smoke.CROP_RES,
                              rng=np.random.RandomState(chip_smoke.SEED))
    for i, logits in enumerate(chip_smoke.first_crops(gen, chip_smoke.crop_scene(),
                                                      chip_smoke.CROP_GOLDEN)):
        out[f"crop_{i}"] = np.asarray(logits, np.float32)
    if not float64:
        return out
    lppg = jpn.LocalPoolPointnet(JEncoderConfig(), grid_resolution=chip_smoke.POINT_GRID,
                                 use_grid=True)
    fps = jpp.farthest_point_sample
    jpp.farthest_point_sample = jax_fps_x64  # its scan carry typed for x64
    try:
        with jax.enable_x64(True):
            grid = jax.device_get(jax.jit(lppg.apply)(f64(_variables(models["lppg"])),
                                                      f64(clouds)))
            train = jax.device_get(jax.jit(lambda v, p: net.apply(
                v, p, train=True, mutable=["batch_stats"])[0][1])(f64(v), f64(pp)))
    finally:
        jpp.farthest_point_sample = fps
    for t in grid:
        out.update(chip_smoke.golden_record(f"lppg_{t}", grid[t]))
    out.update(chip_smoke.golden_record("pp_train", train))
    return out


def test_points_golden_file_is_current():
    """JAX's float32 entries and crops regenerated, each within 1e-6 * (1 +
    |b|) of the committed one (the CPU XLA build may sum in another order).
    The float64 entries (JAX's float64 of the grid branch at 32^3 takes
    most of a minute on the CPU) are held within 1e-9 * (1 + |b|) of the
    port's float64 evaluation instead, which equals JAX's
    (tests/test_torch_pointnet.py, test_torch_pointnetpp.py). The file stays
    under 2 MB."""
    import torch

    path = REPO / chip_smoke.GOLDEN_POINTS
    stored, fresh = np.load(path), golden_points_arrays(float64=False)
    assert {k for k in stored.files if not k.startswith(("lppg_", "pp_train"))} == set(fresh)
    for k, v in fresh.items():
        np.testing.assert_allclose(stored[k], v, atol=1e-6, rtol=1e-6, err_msg=k)
    n = chip_smoke.POINT_CHECK
    models, x = chip_smoke.point_models(), chip_smoke.point_inputs()
    with torch.no_grad():
        grid = models["lppg"].double()(torch.from_numpy(x["clouds"][:n]).double())
        train = models["pp"].double().train()(torch.from_numpy(x["pp"][:n]).double())[1]
    for k, a in [(f"lppg_{t}", grid[t]) for t in grid] + [("pp_train", train)]:
        chip_smoke.check_golden(stored, k, a.numpy(), 1e-9)
    assert path.stat().st_size < 2e6
