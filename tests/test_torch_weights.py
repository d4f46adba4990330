"""The port's checkpoint reader and weight bridge, its isolation from JAX
and the JAX package, and its device rule."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.serialization import msgpack_restore, msgpack_serialize

from giga_tpu.models.registry import get_network as jax_get_network
from giga_tpu.models.torch_convert import convert_giga_state_dict
from giga_tpu_torch.core.config import get_config
from giga_tpu_torch.models.checkpoint import load_params
from giga_tpu_torch.models.checkpoint import msgpack_restore as port_restore
from giga_tpu_torch.models.convert import flax_to_state_dict, to_reference_state_dict
from giga_tpu_torch.models.registry import get_network, infer_model_type, load_network

REPO = Path(__file__).resolve().parents[1]
CHECKPOINTS = ["checkpoints/synthetic_giga_best.msgpack",
               "checkpoints/synthetic_giga_geo.msgpack"]
PACKAGE = REPO / "giga_tpu_torch"


def _assert_same_tree(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), path
        for k in b:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("path", CHECKPOINTS)
def test_checkpoint_reader_matches_flax(path):
    data = (REPO / path).read_bytes()
    _assert_same_tree(port_restore(data), msgpack_restore(data))


def test_checkpoint_reader_msgpack_subset():
    """Scalars, strings, lists, nested maps, numpy scalars and several dtypes."""
    tree = {"a": {"b": np.arange(6, dtype=np.int32).reshape(2, 3),
                  "c": np.float64(2.5), "d": np.zeros((0, 4), np.float32)},
            "e": 7, "f": -3, "g": 1.5, "h": "text", "i": True, "j": None,
            "k": np.array([1e30, -1e-30], np.float32), "l": 2 ** 40, "m": -2 ** 33}
    got = port_restore(msgpack_serialize(tree))
    ref = msgpack_restore(msgpack_serialize(tree))
    assert got.keys() == ref.keys()
    for k in ("e", "f", "g", "h", "i", "j", "l", "m"):
        assert got[k] == ref[k] and type(got[k]) is type(ref[k])
    _assert_same_tree(got["a"]["b"], ref["a"]["b"])
    _assert_same_tree(got["a"]["d"], ref["a"]["d"])
    _assert_same_tree(got["k"], ref["k"])
    assert got["a"]["c"] == 2.5


def test_checkpoint_reader_rejects_unknown_ext():
    with pytest.raises(ValueError):
        port_restore(bytes([0xD4, 0x05, 0x00]))  # fixext1 of type 5


def _roundtrip(params, name):
    net, _ = get_network(name)
    net.load_state_dict(flax_to_state_dict(params))  # every tensor must be claimed
    back = convert_giga_state_dict(to_reference_state_dict(net.state_dict()), get_config(name))
    _assert_same_tree(back["params"], params["params"])


@pytest.mark.parametrize("path,name", zip(CHECKPOINTS, ["giga", "giga_geo"]))
def test_weight_bridge_roundtrips_checkpoints(path, name):
    """flax -> port state -> reference names -> giga_tpu's own converter
    gives back the original flax arrays exactly."""
    _roundtrip(msgpack_restore((REPO / path).read_bytes()), name)


@pytest.mark.parametrize("name", ["giga", "giga_aff"])
def test_weight_bridge_roundtrips_init(name):
    jnet, _ = jax_get_network(name)
    t0, p0 = jnp.zeros((1, 8, 8, 8)), jnp.zeros((1, 1, 3))  # shapes need not be 40^3
    params = jax.device_get(jnet.init(jax.random.PRNGKey(3), t0, p0, p0))
    _roundtrip(params, name)


def test_load_network_shipped_checkpoint():
    assert infer_model_type(CHECKPOINTS[0]) == "giga"
    net, cfg = load_network(REPO / CHECKPOINTS[0])
    assert cfg.name == "giga" and not net.training
    assert tuple(net.encoder.conv_in.weight.shape) == (32, 1, 3, 3, 3)
    assert tuple(net.decoder_aff.fc_c0_kernel.shape) == (3, 96, 32)
    assert tuple(net.decoder_occ.fc_out_kernel.shape) == (1, 32, 1)
    raw = load_params(REPO / CHECKPOINTS[0])["params"]
    np.testing.assert_array_equal(net.encoder.unet.up_convs[0].upconv.weight.detach().numpy(),
                                  raw["encoder"]["unet"]["up0"]["upconv"]["kernel"]
                                  .transpose(0, 3, 1, 2))


def _modules():
    return sorted(".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
                  for p in PACKAGE.rglob("*.py"))


def test_port_imports_without_jax():
    """Every module imports in a process where jax, flax, msgpack, optax,
    orbax and pandas cannot be imported, and none of the JAX package is
    loaded; the modules include VGN, TSDF fusion, perception, meshes,
    visualization, training, mesh generation, the grid family, the point
    and crop models, geometry evaluation on dataset scenes, the simulator,
    the clutter-removal experiments, the renderers, the rollout saver, the
    data-generation chain, the CLIs, the parallel layer, the timing
    utilities, the end-to-end self-check, its documented-scale study and
    the root diagnostics. Using the geometry
    library there loads the port's build and never the JAX package's
    giga_tpu/geometry/_native.so."""
    assert {"giga_tpu_torch.models.vgn", "giga_tpu_torch.ops.tsdf",
            "giga_tpu_torch.core.perception", "giga_tpu_torch.core.device",
            "giga_tpu_torch.geometry.mesh", "giga_tpu_torch.utils.visual",
            "giga_tpu_torch.train.loss", "giga_tpu_torch.train.trainer",
            "giga_tpu_torch.train.checkpoint", "giga_tpu_torch.train.corpus",
            "giga_tpu_torch.train.soup", "giga_tpu_torch.train.data",
            "giga_tpu_torch.core.io", "giga_tpu_torch.utils.tensorboard",
            "giga_tpu_torch.scripts.profile_train", "giga_tpu_torch.geometry.native",
            "giga_tpu_torch.geometry.refine", "giga_tpu_torch.geometry.generation",
            "giga_tpu_torch.geometry.eval", "giga_tpu_torch.utils.synthetic",
            "giga_tpu_torch.utils.synthetic_grasps",
            "giga_tpu_torch.scripts.eval_synthetic_geometry",
            "giga_tpu_torch.scripts.profile_meshgen", "giga_tpu_torch.ops.scatter",
            "giga_tpu_torch.models.unet3d", "giga_tpu_torch.scripts.eval_synthetic_gsr",
            "giga_tpu_torch.scripts.build_corpus", "giga_tpu_torch.scripts.train",
            "giga_tpu_torch.scripts.train_corpus", "giga_tpu_torch.models.pointnet",
            "giga_tpu_torch.models.pointnetpp", "giga_tpu_torch.models.crop",
            "giga_tpu_torch.geometry.sliding_window", "giga_tpu_torch.geometry.voxelize",
            "giga_tpu_torch.geometry.voxelgrid", "giga_tpu_torch.geometry.icp",
            "giga_tpu_torch.geometry.datasets", "giga_tpu_torch.utils.urdf",
            "giga_tpu_torch.utils.implicit", "giga_tpu_torch.sim.noise",
            "giga_tpu_torch.scripts.eval_geometry", "giga_tpu_torch.sim.btsim",
            "giga_tpu_torch.sim.simulation", "giga_tpu_torch.utils.saver",
            "giga_tpu_torch.experiments.clutter_removal",
            "giga_tpu_torch.experiments.clutter_removal_single",
            "giga_tpu_torch.utils.render", "giga_tpu_torch.utils.nvisii_render",
            "giga_tpu_torch.scripts.sim_grasp_multiple",
            "giga_tpu_torch.scripts.sim_grasp_save_scene",
            "giga_tpu_torch.scripts.render_rollouts",
            "giga_tpu_torch.scripts.generate_data_parallel",
            "giga_tpu_torch.scripts.clean_balance_data",
            "giga_tpu_torch.scripts.construct_dataset_parallel",
            "giga_tpu_torch.scripts.save_occ_data_parallel", "giga_tpu_torch.parallel",
            "giga_tpu_torch.parallel.distributed", "giga_tpu_torch.parallel.mesh",
            "giga_tpu_torch.parallel.dryrun", "giga_tpu_torch.utils.benchmark",
            "giga_tpu_torch.utils.profiling", "giga_tpu_torch.scripts.selfcheck_e2e",
            "giga_tpu_torch.scripts.profile_geo", "giga_tpu_torch.scripts.profile_postprocess",
            "giga_tpu_torch.scripts.profile_vgn", "giga_tpu_torch.scripts.measure_meshgen",
            "giga_tpu_torch.scripts.diag_meshgen128",
            "giga_tpu_torch.scripts.diagnose_meshgen256",
            "giga_tpu_torch.scripts.profile_meshgen256",
            "giga_tpu_torch.scripts.selfcheck_scale"} <= set(_modules())
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'flax', 'msgpack', 'optax', 'orbax', 'pandas', 'giga_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'msgpack', 'jaxlib',\n"
        "                                                      'optax', 'orbax', 'pandas')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "from giga_tpu_torch.train.corpus import build_scene\n"
        "import numpy as np\n"
        "build_scene(np.random.RandomState(0), 0.3, 64, 2)\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'giga_tpu/geometry/_native.so' not in maps and 'libgeometry-' in maps\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_sources_name_no_jax_package():
    """No source of the port (or chip_smoke.py) imports giga_tpu.*, jax,
    flax, msgpack, optax, orbax or pandas."""
    pattern = re.compile(r"^\s*(from|import)\s+(giga_tpu(\.|\s|$)|jax|flax|msgpack|optax|orbax|"
                         r"pandas)", re.M)
    files = list(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    assert {PACKAGE / "ops" / "tsdf.py", PACKAGE / "utils" / "visual.py",
            PACKAGE / "geometry" / "mesh.py", PACKAGE / "models" / "vgn.py",
            PACKAGE / "geometry" / "native.py", PACKAGE / "geometry" / "generation.py",
            PACKAGE / "utils" / "synthetic.py", PACKAGE / "models" / "pointnetpp.py",
            PACKAGE / "models" / "crop.py", PACKAGE / "geometry" / "datasets.py",
            PACKAGE / "scripts" / "eval_geometry.py", PACKAGE / "sim" / "noise.py",
            PACKAGE / "sim" / "btsim.py", PACKAGE / "sim" / "simulation.py",
            PACKAGE / "utils" / "saver.py", PACKAGE / "utils" / "render.py",
            PACKAGE / "utils" / "nvisii_render.py",
            PACKAGE / "experiments" / "clutter_removal.py",
            PACKAGE / "experiments" / "clutter_removal_single.py",
            *(PACKAGE / "scripts" / f"{name}.py" for name in (
                "sim_grasp_multiple", "sim_grasp_save_scene", "render_rollouts",
                "generate_data_parallel", "clean_balance_data", "construct_dataset_parallel",
                "save_occ_data_parallel")),
            *(PACKAGE / "parallel" / f"{name}.py" for name in (
                "__init__", "distributed", "mesh", "dryrun")),
            PACKAGE / "utils" / "benchmark.py", PACKAGE / "utils" / "profiling.py",
            *(PACKAGE / "scripts" / f"{name}.py" for name in (
                "selfcheck_e2e", "profile_geo", "profile_postprocess", "profile_vgn",
                "measure_meshgen", "diag_meshgen128", "diagnose_meshgen256",
                "profile_meshgen256", "selfcheck_scale"))} <= set(files)
    for f in files:
        hits = pattern.findall(f.read_text())
        assert not hits, (f, hits)


def test_planner_without_card_raises(monkeypatch):
    """device=None means the card: with no CUDA device the planner raises
    instead of quietly running on the CPU."""
    from giga_tpu_torch.inference.planner import GIGAPlanner, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        GIGAPlanner(REPO / CHECKPOINTS[0])
    assert GIGAPlanner(REPO / CHECKPOINTS[0], device="cpu").device.type == "cpu"


def test_planner_rejects_unported_options():
    """bf16 and checkpoint ensembles are ported: they construct, with a bf16
    net and two stacked members; an ensemble's batched program raises, as
    the JAX package's does. Affordance visualization is ported: the planner
    builds, and __call__ returns (grasps, scores, toc, composed scene)."""
    import chip_smoke
    from giga_tpu_torch.geometry.mesh import TriMesh
    from giga_tpu_torch.inference.planner import GIGAPlanner, State

    path = REPO / CHECKPOINTS[0]
    planner = GIGAPlanner(path, precision="bf16", device="cpu")
    assert next(planner.net.parameters()).dtype == torch.bfloat16
    ens = GIGAPlanner(params=[load_params(path)] * 2, device="cpu")
    assert ens.stacked["decoder_aff.fc_p_kernel"].shape[0] == 2
    with pytest.raises(NotImplementedError):
        ens.plan_batch(np.zeros((1, 40, 40, 40), np.float32))
    viz = GIGAPlanner(path, visualize=True, device="cpu", **chip_smoke.PLANNER_KW)
    out = viz(State(tsdf=chip_smoke.make_scenes(1)),
              scene_mesh=chip_smoke.scene_mesh(chip_smoke.scene_objects(1)[0]))
    assert len(out) == 4 and isinstance(out[3], TriMesh) and len(out[0]) >= 1
    assert len(out[3].face_colors) == len(out[3].faces)


def test_chip_smoke_fails_without_card():
    """Without CUDA chip_smoke.py exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
