"""The point models, the crop model and geometry evaluation on the card,
against the same calls on the CPU (chip_smoke.py's phases 31-33 at smaller
sizes).

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_points.py -m cuda
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from giga_tpu_torch.models import pointnetpp as ppm  # noqa: E402
from giga_tpu_torch.models.crop import CropGenerator  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the modules under test run on it")
    return "cuda"


@pytest.mark.parametrize("name", ["lpp", "fc", "pp", "lpd"])
def test_point_models_on_the_card_match_the_cpu(cuda_device, name):
    """Each phase-31 model (its seeded weights) on 2 clouds: outputs within
    2e-5 * (1 + |b|) and gradients within 1e-5 * (1 + max |g|) of the CPU's."""
    models, x = chip_smoke.point_models(), chip_smoke.point_inputs()
    planes = {t: np.random.RandomState(0).randn(2, 40, 40, 32).astype(np.float32)
              for t in ("xz", "xy", "yz")}
    feats = np.random.RandomState(1).randn(2, chip_smoke.PP_POINTS, 32).astype(np.float32)
    args = {"lpp": (x["clouds"][:2],), "fc": (planes, x["queries"][:2]), "pp": (x["pp"][:2],),
            "lpd": (x["pp"][:2], feats, x["pp_queries"][:2])}[name]
    card, cpu = (chip_smoke.fwd_bwd(models[name], args, d) for d in (cuda_device, "cpu"))
    assert chip_smoke.scaled_err(card[0], cpu[0]) <= chip_smoke.TOL_POINT_OUT
    assert chip_smoke.grad_err(card[1], cpu[1]) <= chip_smoke.TOL_POINT_GRAD


def test_fps_and_ball_query_on_the_card(cuda_device):
    """FPS, ball-query and 3-nearest indices of the card against the CPU's
    on phase 31's PointNet++ clouds: FPS equal; any ball-query or 3-nearest
    slot that differs is a tie or a point at the radius (the distances of
    both choices within 1e-6)."""
    xyz = torch.from_numpy(chip_smoke.point_inputs()["pp"][:2])
    out = {}
    for d in (cuda_device, "cpu"):
        p = xyz.to(d)
        fps = ppm.farthest_point_sample(p, 512)
        cent = torch.gather(p, 1, fps[..., None].expand(-1, -1, 3))
        out[d] = (fps.cpu(), ppm.ball_query(0.2, 32, p, cent).cpu(), cent.cpu())
    assert torch.equal(out[cuda_device][0], out["cpu"][0])
    d2 = ppm.square_distance(out["cpu"][2].double(), xyz.double())
    a, b = (torch.gather(d2, 2, out[d][1]) for d in (cuda_device, "cpu"))
    assert float((a - b).abs().max()) <= 1e-6


def test_crop_generator_on_the_card(cuda_device):
    """The phase-32 crop model on a single synthetic scene (0.1 m crops):
    every crop's logits within 2e-5 * (1 + |b|) of the CPU's, same draws."""
    objects = chip_smoke.scene_objects(1)[0]
    pts = chip_smoke.surface_mesh(objects).sample_surface(20000, rng=np.random.RandomState(0))[0]
    logits = {}
    for d in (cuda_device, "cpu"):
        gen = CropGenerator(chip_smoke.crop_net(), n_crop_points=chip_smoke.CROP_POINTS,
                            resolution=16, rng=np.random.RandomState(0), device=d)
        logits[d] = chip_smoke.record_crops(gen, pts, chip_smoke.CROP_QUERY,
                                            chip_smoke.CROP_INPUT)[1]
    chip_smoke.compare_crops(logits[cuda_device], logits["cpu"], "card vs CPU")


def test_eval_geometry_on_the_card(cuda_device, tmp_path):
    """scripts/eval_geometry.py with --roi at --batch 2 on the card against
    the golden JSON of the JAX script."""
    import json

    from giga_tpu_torch.scripts.eval_geometry import main

    proc, raw = chip_smoke.geoeval_fixture(tmp_path)
    logdir = main(chip_smoke.geoeval_args(proc, raw, tmp_path / "out", True, 2, device="cuda"))
    golden = json.loads((REPO / chip_smoke.GOLDEN_GEOEVAL).read_text())["roi=True,batch=2"]
    chip_smoke.compare_geoeval(chip_smoke.geoeval_results(logdir), golden, "card vs JAX")
