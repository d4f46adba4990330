"""The reference's torch ``.pt`` checkpoints in the port
(``models/registry.load_network``, ``models/convert.from_reference_state_dict``)
against the JAX package's converter (giga_tpu/models/torch_convert.py):

  * a ``GoldenGIGA`` state dict saved as tests/test_checkpoint_pt.py saves
    it, loaded by the port and by JAX: the same parameters exactly, and
    outputs within 2e-5 of JAX's and of the golden torch model's;
  * the port's weights written under the reference's names
    (``to_reference_state_dict``) and read back by the port and by JAX's
    ``convert_torch_checkpoint``, for giga, giga_grid and VGN: exact;
  * a GlobalVoxelEncoder's reference state dict against JAX's
    ``convert_global_voxel_encoder_state_dict``: exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from giga_tpu.core.config import get_config as jax_get_config
from giga_tpu.models.registry import load_network as jax_load_network
from giga_tpu.models.torch_convert import (
    convert_global_voxel_encoder_state_dict,
    convert_torch_checkpoint,
)
from giga_tpu_torch.models.convert import (
    flax_to_state_dict,
    from_reference_state_dict,
    state_dict_to_flax,
    to_reference_state_dict,
)
from giga_tpu_torch.models.encoder import GlobalVoxelEncoder
from giga_tpu_torch.models.registry import init_network, load_network
from tests.torch_golden import GoldenGIGA

TOL = 2e-5


def assert_trees_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                      err_msg=path)


def test_golden_giga_pt_loads_as_in_jax(tmp_path):
    torch.manual_seed(0)
    golden = GoldenGIGA().eval()
    path = tmp_path / "best_giga_val.pt"
    torch.save(golden.state_dict(), path)
    net, cfg = load_network(path)
    jnet, _, jparams = jax_load_network(path)
    assert cfg.name == "giga"
    assert_trees_equal(state_dict_to_flax(net.state_dict())["params"],
                       jax.device_get(jparams)["params"])
    rng = np.random.RandomState(0)
    tsdf = rng.rand(1, 40, 40, 40).astype(np.float32)
    p = rng.uniform(-0.4, 0.4, (1, 8, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jnet.apply(jparams, jnp.asarray(tsdf), jnp.asarray(p), jnp.asarray(p))
    with torch.no_grad():
        got = net(torch.from_numpy(tsdf), torch.from_numpy(p), torch.from_numpy(p))
        gold = golden(torch.from_numpy(tsdf), torch.from_numpy(p), torch.from_numpy(p))
    for k in ("qual", "occ"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=TOL, rtol=0)
        np.testing.assert_allclose(got[k].numpy(), gold[k].numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["giga", "giga_grid", "vgn"])
def test_reference_names_round_trip_through_jax(tmp_path, name):
    """Port weights -> reference names -> .pt: the port's load_network gives
    the same state back, and JAX's convert_torch_checkpoint the same flax
    tree as the port's state_dict_to_flax."""
    net, _ = init_network(name, seed=2)
    path = tmp_path / f"best_{name}_val.pt"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in to_reference_state_dict(net.state_dict()).items()}, path)
    loaded, cfg = load_network(path)
    assert cfg.name == name
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    assert_trees_equal(jax.device_get(convert_torch_checkpoint(path, jax_get_config(name))),
                       state_dict_to_flax(net.state_dict()))


def test_reference_decoders_are_zero_padded():
    """The reference's qual and width heads have one output: their fc_out
    rows pad to the stacked out_dim 4 with zeros, as JAX's converter pads."""
    net, cfg = init_network("giga", seed=3)
    ref = to_reference_state_dict(net.state_dict())
    for head in ("decoder_qual", "decoder_width", "decoder_tsdf"):
        ref[f"{head}.fc_out.weight"] = ref[f"{head}.fc_out.weight"][:1]
        ref[f"{head}.fc_out.bias"] = ref[f"{head}.fc_out.bias"][:1]
    state = from_reference_state_dict(ref, cfg)
    jtree = convert_torch_checkpoint.__globals__["convert_giga_state_dict"](
        ref, jax_get_config("giga"))
    assert_trees_equal(state_dict_to_flax(state), jtree)
    assert float(state["decoder_aff.fc_out_kernel"][0, :, 1:].abs().max()) == 0.0


def test_global_voxel_encoder_reference_state_matches_jax():
    torch.manual_seed(4)
    enc = GlobalVoxelEncoder(c_dim=16)
    ref = {k: v.numpy() for k, v in enc.state_dict().items()}
    assert_trees_equal(state_dict_to_flax(from_reference_state_dict(ref)),
                       convert_global_voxel_encoder_state_dict(ref))
    back = flax_to_state_dict(convert_global_voxel_encoder_state_dict(ref))
    for k, v in enc.state_dict().items():
        assert torch.equal(back[k], v), k
