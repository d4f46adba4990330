"""The port's MeshGenerator against the JAX package's, on the CPU, at small
lattices (tests/test_band_generation.py's shapes), on seeded giga_geo
params and on the shipped checkpoint.

Band ids and counts, refine point counts, tiers and paths must be equal.
Corner values (float16) must be equal, or apart by one float16 step of the
larger plus TOL_LOGIT * (1 + |b|): two float32 decodes that sum in another
order round a logit that lies near a float16 rounding boundary to its two
neighbours, and a logit near 0 (where float16 steps are tiny) by the float32
difference itself (``test_float32_logits_match_jax`` holds the two float32
lattice decodes within TOL_LOGIT * (1 + |b|) and prints how far they lie:
1.5e-5 at 65^3). In bf16 the decoder rounds every layer to bf16, and a
flipped rounding of a unit-scale term moves a logit by a bf16 step of that
term: TOL_BF16 * (1 + |b|) there. Each case prints how many corners differ
and by how much at most (``-s``). Vertices from such bands lie within
TOL_VERTEX of JAX's (in the [-0.5, 0.5] frame; each case prints its
largest difference).
"""

from pathlib import Path
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from giga_tpu.geometry.generation import MeshGenerator as JMeshGenerator
from giga_tpu.geometry.generation import compact_mask_anchored
from giga_tpu.models.registry import get_network as jax_get_network
from giga_tpu.models.registry import load_params
from giga_tpu.utils.synthetic import mesh_to_tsdf, random_scene
from giga_tpu_torch.geometry.generation import (
    MeshGenerator,
    compact_mask,
    fetch,
    linspace_f32,
)
from giga_tpu_torch.models.registry import get_network

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

TOL_LOGIT = 3e-5
TOL_BF16 = 2.0 ** -8
TOL_VERTEX = 1e-3
TOL_NORMALS = 3e-5
TOL_REFINE_VERTS = 1e-5
CHECKPOINT = REPO / "checkpoints" / "synthetic_giga_geo.msgpack"


@pytest.fixture(scope="module")
def jax_net():
    return jax_get_network("giga_geo")[0]


@pytest.fixture(scope="module", params=["seeded", "shipped"])
def params(request, jax_net):
    if request.param == "shipped":
        return load_params(CHECKPOINT)
    p = jax_net.init(jax.random.PRNGKey(0), jnp.zeros((1, 40, 40, 40)), None,
                     jnp.zeros((1, 1, 3)))
    return jax.device_get(p)


@pytest.fixture(scope="module")
def shipped():
    return load_params(CHECKPOINT)


@pytest.fixture(scope="module")
def scenes():
    """Two synthetic TSDFs (RandomState 0 and 3, as test_band_generation)."""
    out = []
    for seed in (0, 3):
        r = np.random.RandomState(seed)
        out.append(np.squeeze(mesh_to_tsdf(random_scene(r, 0.3), 0.3, 40, rng=r)))
    return np.stack(out)


def generators(jax_net, params, **kw):
    """(JAX's generator, the port's on the CPU) with the same settings."""
    return (JMeshGenerator(jax_net, params, **kw),
            MeshGenerator(get_network("giga_geo")[0], params, device="cpu", **kw))


def assert_band(got, ref, what: str, tol: float = TOL_LOGIT) -> int:
    """Equal ids and counts; corners within the module's rule. Returns the
    corners that differ."""
    ids, vals, count = got
    rids, rvals, rcount = ref
    n = int(rcount)
    assert int(count) == n, (what, int(count), n)
    np.testing.assert_array_equal(ids, rids, err_msg=what)  # valid prefix and 0 fill
    a, b = vals[:n].astype(np.float64), rvals[:n].astype(np.float64)
    step = np.spacing(np.maximum(np.abs(vals[:n]), np.abs(rvals[:n]))).astype(np.float64)
    excess = np.abs(a - b) - step - tol * (1 + np.abs(b))
    assert excess.max(initial=-1.0) <= 0, (what, excess.max())
    differ = int((a != b).sum())
    print(f"{what}: {n} cells, {differ} of {a.size} corners differ, by "
          f"{np.abs(a - b).max(initial=0.0):.3g} at most")
    return differ


def assert_meshes(got, ref, what: str, tol: float = TOL_VERTEX):
    assert len(got.faces) == len(ref.faces) > 0, what
    np.testing.assert_array_equal(got.faces, ref.faces, err_msg=what)
    np.testing.assert_allclose(got.vertices, ref.vertices, atol=tol, rtol=0, err_msg=what)
    print(f"{what}: vertices within {np.abs(got.vertices - ref.vertices).max():.3g}")


# ------------------------------------------------------------- the primitives

@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("p,density,k_half,k", [
    (8, 0.2, 64, 160), (9, 0.2, 125, 200), (17, 0.05, 729, 400), (16, 0.0, 8, 8),
    (8, 1.0, 64, 512),
    (8, 1.0, 4, 512),    # anchor budget overflows: the count undercounts
    (4, 1.0, 8, 16),     # count past k
    (12, 0.1, 40, 60)])  # both
def test_compact_mask_matches_jax(p, density, k_half, k, sort):
    """JAX's ids, count and anchor count element for element, overflow
    included; complete and sorted, ``jnp.nonzero``'s ids."""
    mask = np.random.RandomState(p).rand(p, p, p) < density
    idx, count, anchors = compact_mask(torch.from_numpy(mask), k_half, k, sort=sort)
    jidx, jcount, janchors = compact_mask_anchored(jnp.asarray(mask), k_half, k, sort=sort)
    assert (int(count), int(anchors)) == (int(jcount), int(janchors))
    assert idx.dtype == torch.int32 and idx.shape == (k,)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    (ref,) = np.nonzero(mask.reshape(-1))
    if sort and int(count) <= k and int(anchors) <= k_half:
        np.testing.assert_array_equal(idx.numpy()[:len(ref)], ref)


@pytest.mark.parametrize("n", [2, 9, 17, 33, 41, 65, 129, 257])
def test_linspace_matches_jax(n):
    """Bit for bit where n - 1 is a power of two (the generator's lattices),
    within an ulp elsewhere (XLA's CPU division by an approximate
    reciprocal)."""
    got = linspace_f32(-0.5, 0.5, n)
    ref = np.asarray(jnp.linspace(-0.5, 0.5, n, dtype=jnp.float32))
    if (n - 1) & (n - 2) == 0:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=np.spacing(np.float32(0.5)), rtol=0)


def test_budgets_match_jax(jax_net, shipped):
    for r0, steps, strategy in ((32, 2, "auto"), (32, 3, "auto"), (16, 1, "refine"),
                                (8, 2, "dense"), (32, 0, "auto")):
        j, t = generators(jax_net, shipped, resolution0=r0, upsampling_steps=steps,
                          strategy=strategy)
        assert t.strategy == j.strategy and t.band_cells == j.band_cells == 49152
        assert (t.refine_fine_cells, t.refine_point_cells) == (j.refine_fine_cells,
                                                               j.refine_point_cells)
        assert t._refine_tiers == j._refine_tiers


# ---------------------------------------------------------------- the programs

def test_dense_band_matches_jax(jax_net, params, scenes):
    j, t = generators(jax_net, params, resolution0=16, upsampling_steps=1, strategy="dense")
    for i, tsdf in enumerate(scenes):
        j.encode(tsdf)
        t.encode(tsdf)
        assert_band(fetch(*t.band_program(t._planes)),
                    jax.device_get(j._band(j.params, j._planes)), f"dense band, scene {i}")


def test_dense_band_65_matches_jax(jax_net, shipped, scenes):
    """The shipped checkpoint one level deeper (65^3, 2 upsampling steps of 16)."""
    j, t = generators(jax_net, shipped, resolution0=16, upsampling_steps=2, strategy="dense")
    j.encode(scenes[0])
    t.encode(scenes[0])
    assert_band(fetch(*t.band_program(t._planes)), jax.device_get(j._band(j.params, j._planes)),
                "dense band 65^3")


def test_float32_logits_match_jax(jax_net, shipped, scenes):
    """The two float32 lattice decodes behind the band (JAX's XLA
    ``decode_dense`` and the port's) at 65^3: within TOL_LOGIT * (1 + |b|)."""
    from giga_tpu.inference.dense_decode import decode_dense as jax_decode_dense
    from giga_tpu.inference.planner import _lattice_features
    from giga_tpu_torch.inference.dense_decode import decode_dense

    j, t = generators(jax_net, shipped, resolution0=16, upsampling_steps=2, strategy="dense")
    j.encode(scenes[0])
    t.encode(scenes[0])
    n = t.final_n
    coords = jnp.linspace(-0.5, 0.5, n, dtype=jnp.float32)
    planes = {k: v[0] for k, v in j._planes.items()}
    ref = np.asarray(jax_decode_dense(j.params["params"]["decoder_occ"],
                                      _lattice_features(planes, coords, j.net.cfg), coords,
                                      5)[0, ..., 0])
    with torch.no_grad():
        got = decode_dense(t._dec, t._lattice_feats({k: v[0] for k, v in t._planes.items()},
                                                    t.coords(n)), t.coords(n), 5)[0, ..., 0]
    rel = np.abs(got.numpy() - ref) / (1 + np.abs(ref))
    print(f"float32 logits at {n}^3: within {rel.max():.3g} * (1 + |b|)")
    assert rel.max() <= TOL_LOGIT


def test_batched_band_matches_jax(jax_net, params, scenes):
    j, t = generators(jax_net, params, resolution0=16, upsampling_steps=1, strategy="dense")
    ref = jax.device_get(jax.jit(j._build_band_eval_batched(33))(j.params, jnp.asarray(scenes)))
    got = fetch(*t.band_program_batched(t.upload(scenes)))
    for b in range(len(scenes)):
        assert_band([v[b] for v in got], [v[b] for v in ref], f"batched band, scene {b}")


def test_bf16_matches_jax(jax_net, params, scenes):
    """bf16 decoder weights and planes: the band program and the refine chain."""
    j, t = generators(jax_net, params, resolution0=16, upsampling_steps=1, strategy="dense",
                      precision="bf16")
    j.encode(scenes[0])
    t.encode(scenes[0])
    assert t._dec["fc_p_kernel"].dtype == torch.bfloat16
    assert next(t.net.parameters()).dtype == torch.float32  # the encode stays float32
    assert_band(fetch(*t.band_program(t._planes)), jax.device_get(j._band(j.params, j._planes)),
                "bf16 band", TOL_BF16)
    j, t = generators(jax_net, params, resolution0=8, upsampling_steps=2, strategy="refine",
                      precision="bf16")
    j.encode(scenes[0])
    t.encode(scenes[0])
    ids, vals, count_f, counts_p = jax.device_get(j._refine_band_fn(0)(j.params, j._planes))
    got = fetch(*t.refine_program(t._planes, 0))
    np.testing.assert_array_equal(got[3], counts_p)
    assert_band(got[:3], (ids, vals, count_f), "bf16 refine", TOL_BF16)
