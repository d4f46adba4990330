"""The band program's lattice decode on K2 (``MeshGenerator.band_decode``)
against the module path, on the CPU, where K2's wrapper runs its plain
version: the logits, the bands, and which path each generator takes.

K2 sums the fc_p and plane terms in another order than the module path
(the fc_p bias folded into px, the fc_c bias into pxz), so the two float32
decodes differ by a few ulps of a logit: TOL_K2 * (1 + |b|) (printed: 2.8e-6
at 33^3). The band's float16 corners agree to one float16 step of the larger
plus that float32 difference, which is what shows near 0, where float16 steps
are tiny (tests/test_torch_meshgen.py's rule).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from giga_tpu_torch.geometry.generation import MeshGenerator, fetch
from giga_tpu_torch.models.registry import get_network, load_network

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

TOL_K2 = 1e-5


@pytest.fixture(scope="module")
def geo_net():
    return load_network(REPO / chip_smoke.GEO_CHECKPOINT, "giga_geo")[0]


@pytest.fixture(scope="module")
def scenes():
    return chip_smoke.make_scenes(2, seed=5)


def test_k2_band_program_matches_module_path(geo_net, scenes):
    """33^3, B=2: logits within TOL_K2 * (1 + |b|); equal band ids and
    counts, corners within one float16 step + TOL_K2 * (1 + |b|)."""
    k2 = MeshGenerator(geo_net, resolution0=16, upsampling_steps=1, strategy="dense", device="cpu")
    module = MeshGenerator(geo_net, resolution0=16, upsampling_steps=1, strategy="dense",
                           device="cpu")
    module.band_decode = "module"
    assert k2.band_decode == "K2"
    grids = k2.upload(scenes)
    coords = k2.coords(k2.final_n)
    with torch.no_grad():
        planes = k2._cast(k2.net.encode(grids))
        got, ref = (g._decode_batched(planes, coords) for g in (k2, module))
    assert got.shape == ref.shape == (2, 33, 33, 33) and got.dtype == torch.float32
    rel = ((got - ref).abs() / (1 + ref.abs())).max().item()
    print(f"K2 against the module path at 33^3: within {rel:.3g} * (1 + |b|)")
    assert rel <= TOL_K2
    (ids, vals, counts), (rids, rvals, rcounts) = (fetch(*g.band_program_batched(grids))
                                                   for g in (k2, module))
    np.testing.assert_array_equal(counts, rcounts)
    np.testing.assert_array_equal(ids, rids)
    for b, n in enumerate(counts):
        a, r = vals[b, :n], rvals[b, :n]
        step = np.spacing(np.maximum(np.abs(a), np.abs(r))).astype(np.float64)
        excess = np.abs(a.astype(np.float64) - r) - step - TOL_K2 * (1 + np.abs(r))
        assert excess.max(initial=-1.0) <= 0, (b, excess.max())


@pytest.mark.parametrize("model,precision,strategy,expect", [
    ("giga_geo", "fp32", "dense", ("K2", "K2")),
    ("giga_geo", "bf16", "dense", ("module", "module")),
    ("giga_grid", "fp32", "dense", ("module", "module")),
    ("giga_geo", "fp32", "refine", ("K2", "module")),  # the refine chain's decodes
])
def test_decode_path_is_chosen_at_construction(scenes, model, precision, strategy, expect):
    """(``band_decode``, each scene's ``stats["decode"]``) by model,
    precision and strategy, from ``generate_meshes`` and ``generate_mesh``
    alike."""
    gen = MeshGenerator(get_network(model)[0], resolution0=8, upsampling_steps=1,
                        strategy=strategy, precision=precision, device="cpu")
    band, decode = expect
    assert gen.band_decode == band
    gen.generate_meshes(scenes)
    assert [s["decode"] for s in gen.batch_stats] == [decode] * len(scenes)
    _, stats = gen.generate_mesh(scenes[0])
    assert stats["decode"] == decode
