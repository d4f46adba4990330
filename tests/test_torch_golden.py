"""The JAX golden files that chip_smoke.py holds the card's plans against.

The card has no JAX, so ``giga_tpu_torch/testdata/golden_plan_giga.npz``
carries the JAX package's candidates for the first chip_smoke scenes,
planned on the CPU with the shipped checkpoint; ``golden_plan_giga_bf16.npz``
those of the JAX package's TPU bf16 batched program on the same scenes
(composed from its functions with the Pallas kernels in interpret mode,
tests/test_torch_bf16.py); ``golden_plan_giga_bf16_fold.npz`` those and the
raw qual of the same program with the decode options ``fold_b1`` and
``hidden_bf16``; and ``golden_call_giga_bf16.npz`` those of the
single-scene program of JAX's ``GIGAPlanner(precision="bf16")``, which its
``__call__`` runs, scene by scene; ``golden_call_giga_ensemble.npz`` the
candidates and raw qual of JAX's float32 checkpoint-ensemble program
(``build_ensemble_giga_planner_fn``) with each combiner, on the shipped
checkpoint and its perturbed copy (``chip_smoke.perturbed_params``), scene
by scene; ``golden_plan_vgn.npz`` the seeded VGN weights
(tests/test_torch_vgn.py::jax_vgn_params) and the candidates of JAX's
``highest`` VGN programs, single-scene (with its raw qual) and batched;
``golden_tsdf_fusion.npz`` chip_smoke's ray-cast depth views of its first
scenes at the simulator's camera settings and JAX's 40^3 ``fuse_views`` of
them; ``golden_train_giga.npz`` the loss terms of three fp32 steps of
JAX's ``make_train_step`` (mm sampler) from the shipped checkpoint on
chip_smoke's seeded batch, the first step's gradients and the params
after the first and the last step as each leaf's sum and seeded entries
(``chip_smoke.leaf_entries``, the port's leaf names);
``golden_mesh_geo.npz`` JAX's mesh-generation bands with the shipped
GIGA-Geo checkpoint on bench.py's first two scenes at 129^3 and the first
at 257^3 through the refine chain (``golden_mesh_arrays``). These
tests regenerate them and assert the committed files are current. Rewrite them all, or those whose names contain the given words,
with

    JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write [vgn fusion ...]
"""

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from test_torch_bf16 import jax_bf16_planner_reference, jax_tpu_reference  # noqa: E402
from test_torch_vgn import jax_candidates, jax_vgn_params  # noqa: E402
from giga_tpu.ops.tsdf import fuse_views  # noqa: E402
from giga_tpu.core.config import PlannerConfig  # noqa: E402
from giga_tpu.inference.planner import (  # noqa: E402
    build_batched_giga_planner_fn,
    build_ensemble_giga_planner_fn,
    stack_params,
)
from giga_tpu.models.registry import get_network, load_params  # noqa: E402
from giga_tpu.train.trainer import (  # noqa: E402
    _with_sampler,
    create_train_state,
    make_loss_fn,
    make_train_step,
)
from giga_tpu_torch.models.convert import flax_to_state_dict  # noqa: E402

N_SCENES = 4
N_FUSION_SCENES = 2
FIELDS = ("scores", "positions", "rotations", "widths", "count")


def golden_arrays() -> dict:
    """The JAX package's candidates for the first N_SCENES chip_smoke scenes."""
    tsdf = chip_smoke.make_scenes(N_SCENES)
    net, cfg = get_network("giga")
    params = load_params(REPO / chip_smoke.CHECKPOINT)
    with jax.default_matmul_precision("highest"):
        fn = build_batched_giga_planner_fn(
            net, cfg, PlannerConfig(**chip_smoke.PLANNER_KW), chip_smoke.SIZE)
        cands, _ = jax.device_get(fn(params, jnp.asarray(tsdf), jnp.asarray(tsdf)))
    out = {f: np.asarray(getattr(cands, f)) for f in FIELDS}
    out["tsdf"] = tsdf
    return out


def golden_bf16_arrays() -> dict:
    """The JAX TPU bf16 batched program's candidates for the first N_SCENES
    chip_smoke scenes."""
    tsdf, (cands, _) = jax_tpu_reference(N_SCENES)
    out = {f: np.asarray(getattr(cands, f)) for f in FIELDS}
    out["tsdf"] = tsdf
    return out


def golden_bf16_fold_arrays() -> dict:
    """The candidates and raw qual (N_SCENES, R, R, R) of the JAX TPU bf16
    batched program with ``fold_b1`` and ``hidden_bf16`` for the first
    N_SCENES chip_smoke scenes."""
    tsdf, (cands, raw) = jax_tpu_reference(N_SCENES, "bf16", fold_b1=True, hidden_bf16=True)
    out = {f: np.asarray(getattr(cands, f)) for f in FIELDS}
    out["qual"] = np.asarray(raw[0], np.float32)
    out["tsdf"] = tsdf
    return out


def golden_call_bf16_arrays() -> dict:
    """The candidates of JAX's bf16 ``GIGAPlanner`` single-scene program for
    the first N_SCENES chip_smoke scenes, one scene a call, stacked as the
    batched files are."""
    tsdf, programs, _ = jax_bf16_planner_reference(N_SCENES)
    out = {f: np.stack([np.asarray(getattr(cands, f)) for cands, _ in programs])
           for f in FIELDS}
    out["tsdf"] = tsdf
    return out


def golden_ensemble_arrays() -> dict:
    """The candidates and raw qual (N_SCENES, R, R, R) of JAX's float32
    ensemble program on [shipped checkpoint, its perturbed copy] for the
    first N_SCENES chip_smoke scenes, one scene a call, stacked as the
    batched files are, each combiner's under its own prefix."""
    tsdf = chip_smoke.make_scenes(N_SCENES)
    net, cfg = get_network("giga")
    params = load_params(REPO / chip_smoke.CHECKPOINT)
    stacked = stack_params([params, chip_smoke.perturbed_params(params)])
    out = {"tsdf": tsdf}
    for combine in ("mean", "max"):
        fn = build_ensemble_giga_planner_fn(net, cfg, PlannerConfig(**chip_smoke.PLANNER_KW),
                                            chip_smoke.SIZE, combine=combine)
        programs = [jax.device_get(fn(stacked, jnp.asarray(g), jnp.asarray(g))) for g in tsdf]
        for f in FIELDS:
            out[f"{combine}_{f}"] = np.stack([np.asarray(getattr(c, f)) for c, _ in programs])
        out[f"{combine}_qual"] = np.stack([np.asarray(raw[0], np.float32) for _, raw in programs])
    return out


def golden_vgn_arrays() -> dict:
    """The seeded VGN weights (flattened under "params/") and JAX's highest
    single-scene candidates (prefix "single_", with the raw qual) and
    batched candidates (prefix "batch_") for the first N_SCENES chip_smoke
    scenes."""
    _, params = jax_vgn_params()
    tsdf, singles, batch = jax_candidates(N_SCENES)
    out = {"tsdf": tsdf, **chip_smoke.flatten_params(params)}
    for f in FIELDS:
        out[f"single_{f}"] = np.stack([np.asarray(getattr(c, f)) for c, _ in singles])
        out[f"batch_{f}"] = np.asarray(getattr(batch, f))
    out["single_qual"] = np.stack([np.asarray(raw[0], np.float32) for _, raw in singles])
    return out


def fusion_inputs(n: int = N_FUSION_SCENES):
    """(depth views (n, V, H, W), extrinsics (V, 4, 4), K (3, 3)), float32:
    chip_smoke's ray-cast views of its first n scenes."""
    views = chip_smoke.camera_views()
    depth = np.stack([[chip_smoke.render_depth(objects, e) for e in views]
                      for objects in chip_smoke.scene_objects(n)])
    w, h, fx, fy, cx, cy = chip_smoke.CAMERA
    K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], np.float32)
    return depth, np.stack([e.as_matrix() for e in views]).astype(np.float32), K


def golden_fusion_arrays() -> dict:
    """chip_smoke's depth views of its first N_FUSION_SCENES scenes and
    JAX's 40^3 fuse_views of each scene's views."""
    depth, extrinsics, K = fusion_inputs()
    fused = [jax.device_get(fuse_views(jnp.asarray(d), jnp.asarray(K), jnp.asarray(extrinsics),
                                       resolution=chip_smoke.RESOLUTION, size=chip_smoke.SIZE,
                                       sdf_trunc=4 * chip_smoke.SIZE / chip_smoke.RESOLUTION))
             for d in depth]
    return {"depth": depth, "extrinsics": extrinsics, "K": K,
            "tsdf": np.stack([np.asarray(t) for t, _ in fused]),
            "weight": np.stack([np.asarray(w) for _, w in fused])}


def train_batch():
    return chip_smoke.train_batch(chip_smoke.SEED, chip_smoke.GOLDEN_TRAIN_BATCH,
                                  chip_smoke.GOLDEN_TRAIN_POINTS)


def golden_train_arrays() -> dict:
    """The loss terms of GOLDEN_TRAIN_STEPS fp32 steps of JAX's
    make_train_step (its default mm sampler) from the shipped checkpoint on
    chip_smoke's seeded batch, and the params after them with the first
    step's gradients (JAX's loss under value_and_grad) as
    ``chip_smoke.leaf_entries``."""
    net, cfg = get_network("giga")

    class Loaded:  # create_train_state's optimizer around the checkpoint
        apply = net.apply

        def init(self, *args):
            return jax.tree.map(jnp.asarray, load_params(REPO / chip_smoke.CHECKPOINT))

    state = create_train_state(Loaded(), cfg, None)
    step = make_train_step(net, cfg)
    batch = {k: jnp.asarray(v) for k, v in train_batch().items()}
    loss_fn = make_loss_fn(_with_sampler(net, cfg, "mm"), cfg)
    with jax.default_matmul_precision("highest"):
        _, grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params, batch)
    grads = {k: v.numpy() for k, v in flax_to_state_dict(jax.device_get(grads)).items()}
    terms, params = [], []
    for _ in range(chip_smoke.GOLDEN_TRAIN_STEPS):
        state, t = step(state, batch)
        terms.append(jax.device_get(t))
        params.append({k: v.numpy() for k, v in
                       flax_to_state_dict(jax.device_get(state.params)).items()})
    names = sorted(terms[0])
    return {"term_names": np.array(names),
            "terms": np.array([[float(t[n]) for n in names] for t in terms], np.float32),
            **chip_smoke.leaf_entries(params[-1], grads, params[0])}


def golden_mesh_arrays() -> dict:
    """JAX's mesh generation with the shipped GIGA-Geo checkpoint on
    bench.py's first two scenes (``RandomState(0)``'s first two
    ``random_scene`` TSDFs): the 129^3 band program's band (cell ids and
    float16 corner values of its valid prefix) and mesh counts for each,
    and the 257^3 refine chain's (tier 0) with its point counts for the
    first."""
    from giga_tpu.geometry.generation import MeshGenerator
    from giga_tpu.utils.synthetic import mesh_to_tsdf, random_scene

    r = np.random.RandomState(0)
    tsdf = np.stack([np.squeeze(mesh_to_tsdf(random_scene(r, 0.3), 0.3, 40, rng=r))
                     for _ in range(2)])
    net, _ = get_network("giga_geo")
    params = load_params(REPO / chip_smoke.GEO_CHECKPOINT)
    gen = MeshGenerator(net, params, resolution0=32, upsampling_steps=2)
    out = {"tsdf": tsdf}
    counts, verts, faces = [], [], []
    for i, grid in enumerate(tsdf):
        gen.encode(grid)
        ids, vals, count = jax.device_get(gen._band(gen.params, gen._planes))
        n = int(count)
        assert n <= gen.band_cells
        out[f"band{i}_ids"], out[f"band{i}_vals"] = ids[:n], vals[:n]
        mesh = gen._mesh_from_band(ids[:n], vals[:n], 0.0, 1.0, {})
        counts.append(n)
        verts.append(len(mesh.vertices))
        faces.append(len(mesh.faces))
    out.update(band_count=np.array(counts), band_verts=np.array(verts),
               band_faces=np.array(faces))
    gen = MeshGenerator(net, params, resolution0=32, upsampling_steps=3, strategy="refine")
    gen.encode(tsdf[0])
    ids, vals, count_f, counts_p = jax.device_get(gen._refine_band_fn(0)(gen.params, gen._planes))
    K_f, K_ps = gen._refine_tiers[0]
    n = int(count_f)
    assert n <= K_f and all(int(c) <= k for c, k in zip(counts_p, K_ps))
    mesh = gen._mesh_from_band(ids[:n], vals[:n], 0.0, 1.0, {})
    out.update(refine_ids=ids[:n], refine_vals=vals[:n], refine_count=np.array(n),
               refine_counts_p=np.asarray(counts_p), refine_verts=np.array(len(mesh.vertices)),
               refine_faces=np.array(len(mesh.faces)))
    return out


def _assert_current(path: str, fresh: dict, prefix: str = ""):
    """Regenerated candidates equal the committed ones: same counts and
    positions, scores/widths/rotations within 1e-6 (the CPU XLA build may
    reassociate sums; the file is meant to be bit-stable in practice).
    ``prefix`` names one set of a file that holds several."""
    stored = np.load(REPO / path)
    np.testing.assert_array_equal(stored[prefix + "count"], fresh[prefix + "count"])
    np.testing.assert_allclose(stored["tsdf"], fresh["tsdf"], atol=1e-6)
    for i, n in enumerate(fresh[prefix + "count"]):
        np.testing.assert_allclose(stored[prefix + "positions"][i, :n],
                                   fresh[prefix + "positions"][i, :n], atol=1e-7)
        for f in ("scores", "widths", "rotations"):
            np.testing.assert_allclose(stored[prefix + f][i, :n], fresh[prefix + f][i, :n],
                                       atol=1e-6)
    assert fresh[prefix + "count"].sum() > 0
    assert (prefix + "qual" in stored) == (prefix + "qual" in fresh)
    if prefix + "qual" in fresh:
        np.testing.assert_allclose(stored[prefix + "qual"], fresh[prefix + "qual"], atol=1e-6)


def test_golden_file_is_current():
    _assert_current(chip_smoke.GOLDEN, golden_arrays())


def test_bf16_golden_file_is_current():
    _assert_current(chip_smoke.GOLDEN_BF16, golden_bf16_arrays())


def test_bf16_fold_golden_file_is_current():
    _assert_current(chip_smoke.GOLDEN_BF16_FOLD, golden_bf16_fold_arrays())


def test_bf16_call_golden_file_is_current():
    _assert_current(chip_smoke.GOLDEN_CALL_BF16, golden_call_bf16_arrays())


def test_ensemble_call_golden_file_is_current():
    fresh = golden_ensemble_arrays()
    for combine in ("mean", "max"):
        _assert_current(chip_smoke.GOLDEN_ENSEMBLE, fresh, f"{combine}_")


def test_vgn_golden_file_is_current():
    fresh = golden_vgn_arrays()
    stored = np.load(REPO / chip_smoke.GOLDEN_VGN)
    for k in fresh:
        if k.startswith("params/"):
            np.testing.assert_array_equal(stored[k], fresh[k], err_msg=k)
    assert {k for k in stored if k.startswith("params/")} == {
        k for k in fresh if k.startswith("params/")}
    for prefix in ("single_", "batch_"):
        _assert_current(chip_smoke.GOLDEN_VGN, fresh, prefix)


def test_fusion_golden_file_is_current():
    """The depth views and JAX's fused volumes: views equal, tsdf within
    1e-6, weights equal."""
    fresh = golden_fusion_arrays()
    stored = np.load(REPO / chip_smoke.GOLDEN_FUSION)
    assert set(stored) == set(fresh)
    for k in ("depth", "extrinsics", "K", "weight"):
        np.testing.assert_array_equal(stored[k], fresh[k], err_msg=k)
    np.testing.assert_allclose(stored["tsdf"], fresh["tsdf"], atol=1e-6, rtol=0)
    assert (fresh["weight"] == chip_smoke.N_VIEWS).any() and (fresh["tsdf"] > 0.5).any()


def test_train_golden_file_is_current():
    """Terms, seeded entries and gradients within 1e-6 * (1 + |b|), sums
    within 1e-6 a value, indices equal."""
    fresh = golden_train_arrays()
    stored = np.load(REPO / chip_smoke.GOLDEN_TRAIN)
    assert set(stored.files) == set(fresh)
    np.testing.assert_array_equal(stored["term_names"], fresh["term_names"])
    np.testing.assert_allclose(stored["terms"], fresh["terms"], atol=1e-6, rtol=1e-6)
    for k in fresh:
        if k.startswith("idx/"):
            np.testing.assert_array_equal(stored[k], fresh[k], err_msg=k)
        elif k.startswith(("val/", "val1/", "sum/", "grad/", "gmax/")):
            n = fresh[k.replace("sum/", "idx/", 1)].size if k.startswith("val/") else 1
            np.testing.assert_allclose(stored[k], fresh[k], atol=1e-6 * n, rtol=1e-6,
                                       err_msg=k)
    assert (REPO / chip_smoke.GOLDEN_TRAIN).stat().st_size < 300_000


def test_port_train_steps_match_golden():
    """The port's fp32 steps on the CPU from the shipped checkpoint meet the
    card's bounds against the JAX golden (chip_smoke.check_train_golden)."""
    import torch

    from giga_tpu_torch.models.registry import load_network
    from giga_tpu_torch.train.trainer import create_train_state as t_state
    from giga_tpu_torch.train.trainer import make_train_step as t_step
    from giga_tpu_torch.train.trainer import make_value_and_grad, to_device

    net, cfg = load_network(REPO / chip_smoke.CHECKPOINT)
    state = t_state(net, device="cpu")
    step = t_step(net, cfg)
    _, grads = make_value_and_grad(net, cfg)(state.params, to_device(train_batch(), "cpu"))
    grads = {k: g.numpy() for k, g in zip(state.params, grads)}
    terms = [step(state, train_batch())[1]]
    first = {k: v.detach().numpy().copy() for k, v in state.params.items()}
    terms += [step(state, train_batch())[1] for _ in range(chip_smoke.GOLDEN_TRAIN_STEPS - 1)]
    errs = chip_smoke.check_train_golden(
        np.load(REPO / chip_smoke.GOLDEN_TRAIN), terms,
        {k: v.detach().numpy() for k, v in state.params.items()}, grads, first)
    assert all(np.isfinite(list(errs.values()))) and isinstance(terms[0]["loss_all"],
                                                                torch.Tensor)
    # the CPU meets the tight bound everywhere, undetermined entries included
    assert errs["free"] <= chip_smoke.TOL_TRAIN_PARAM and errs["n_free"] > 0


def test_mesh_golden_file_is_current():
    """JAX's bands and mesh counts regenerate bit for bit; the file stays
    small."""
    fresh = golden_mesh_arrays()
    stored = np.load(REPO / chip_smoke.GOLDEN_MESH)
    assert set(stored.files) == set(fresh)
    for k, v in fresh.items():
        assert stored[k].dtype == v.dtype, k
        np.testing.assert_array_equal(stored[k], v, err_msg=k)
    assert (REPO / chip_smoke.GOLDEN_MESH).stat().st_size < 4_000_000


def test_port_meshgen_matches_golden():
    """The port's bands on the CPU meet the card's bounds against the JAX
    golden (chip_smoke.compare_bands): at 129^3 for both scenes and at
    257^3 through the refine chain, and so do the meshes' counts."""
    from giga_tpu_torch.geometry.generation import MeshGenerator, fetch
    from giga_tpu_torch.models.registry import load_network
    from giga_tpu_torch.scripts.profile_meshgen import SETTINGS, bench_scenes

    golden = np.load(REPO / chip_smoke.GOLDEN_MESH)
    np.testing.assert_array_equal(bench_scenes(2), golden["tsdf"])
    net, _ = load_network(REPO / chip_smoke.GEO_CHECKPOINT, "giga_geo")
    gen = MeshGenerator(net, **SETTINGS["single"], device="cpu")
    for i, tsdf in enumerate(golden["tsdf"]):
        gen.encode(tsdf)
        ids, vals, count = fetch(*gen.band_program(gen._planes))
        n = int(count)
        assert n == golden["band_count"][i]
        res = chip_smoke.compare_bands((ids[:n], vals[:n]),
                                       (golden[f"band{i}_ids"], golden[f"band{i}_vals"]),
                                       f"scene {i}")
        assert res["only"] == (0, 0)
        mesh = gen._mesh_from_band(ids[:n], vals[:n], {})
        assert (len(mesh.vertices), len(mesh.faces)) == (golden["band_verts"][i],
                                                         golden["band_faces"][i])
    gen = MeshGenerator(net, **SETTINGS["refine"], device="cpu")
    gen.encode(golden["tsdf"][0])
    ids, vals, count_f, counts_p = fetch(*gen.refine_program(gen._planes, 0))
    n = int(count_f)
    np.testing.assert_array_equal(counts_p, golden["refine_counts_p"])
    res = chip_smoke.compare_bands((ids[:n], vals[:n]),
                                   (golden["refine_ids"], golden["refine_vals"]), "refine")
    assert res["only"] == (0, 0) and n == golden["refine_count"]


def test_golden_scenes_are_planner_tsdfs():
    """chip_smoke's analytic scenes follow the planner's TSDF convention:
    values in [0, 1], saturated far from surfaces, some voxels inside."""
    tsdf = chip_smoke.make_scenes(3)
    assert tsdf.shape == (3, 40, 40, 40) and tsdf.dtype == np.float32
    assert tsdf.min() == 0.0 and tsdf.max() == 1.0
    for s in tsdf:
        assert 0.0 < (s < 0.5).mean() < 0.2
    np.testing.assert_array_equal(chip_smoke.make_scenes(5)[:3], tsdf)


if __name__ == "__main__" and "--write" in sys.argv:
    words = sys.argv[sys.argv.index("--write") + 1:]
    for path, arrays in ((chip_smoke.GOLDEN, golden_arrays),
                         (chip_smoke.GOLDEN_BF16, golden_bf16_arrays),
                         (chip_smoke.GOLDEN_BF16_FOLD, golden_bf16_fold_arrays),
                         (chip_smoke.GOLDEN_CALL_BF16, golden_call_bf16_arrays),
                         (chip_smoke.GOLDEN_ENSEMBLE, golden_ensemble_arrays),
                         (chip_smoke.GOLDEN_VGN, golden_vgn_arrays),
                         (chip_smoke.GOLDEN_FUSION, golden_fusion_arrays),
                         (chip_smoke.GOLDEN_TRAIN, golden_train_arrays),
                         (chip_smoke.GOLDEN_MESH, golden_mesh_arrays)):
        if words and not any(w in Path(path).name for w in words):
            continue
        np.savez_compressed(REPO / path, **arrays())
        print("wrote", path)
