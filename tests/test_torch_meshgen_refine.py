"""The port's MeshGenerator refine chain against the JAX package's, on the
CPU: the chain at one and two levels in both budget tiers, its batched form,
and the fall back past every tier's budget. The fixtures, tolerances and
helpers are tests/test_torch_meshgen.py's (its docstring states the rules);
these cases live in a file of their own so that each file runs in its own
worker under ``pytest -n --dist loadfile``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from giga_tpu_torch.geometry.generation import fetch
from test_torch_meshgen import (  # noqa: F401  (fixtures)
    assert_band,
    assert_meshes,
    generators,
    jax_net,
    params,
    scenes,
    shipped,
)


@pytest.mark.parametrize("res0,steps", [(16, 1), (8, 2)])
def test_refine_chain_matches_jax(jax_net, params, scenes, res0, steps):
    """The single-level and the multi-level chain, each tier."""
    j, t = generators(jax_net, params, resolution0=res0, upsampling_steps=steps,
                      strategy="refine")
    j.encode(scenes[0])
    t.encode(scenes[0])
    for tier in range(2):
        ids, vals, count_f, counts_p = jax.device_get(j._refine_band_fn(tier)(j.params,
                                                                              j._planes))
        got = fetch(*t.refine_program(t._planes, tier))
        np.testing.assert_array_equal(got[3], counts_p)
        assert len(got[3]) == steps and (got[3] > 0).all()
        assert_band(got[:3], (ids, vals, count_f), f"refine {res0}x{steps}, tier {tier}")


def test_batched_refine_matches_jax(jax_net, params, scenes):
    j, t = generators(jax_net, params, resolution0=8, upsampling_steps=2, strategy="refine")
    ref = jax.device_get(j._refine_band_fn(0, batched=True)(j.params, jnp.asarray(scenes)))
    got = fetch(*t.refine_program_batched(t.upload(scenes), 0))
    for b in range(len(scenes)):
        np.testing.assert_array_equal(got[3][b], ref[3][b])
        assert_band([v[b] for v in got[:3]], [v[b] for v in ref[:3]],
                    f"batched refine, scene {b}")


def test_refine_overflow_falls_back_as_jax(jax_net, shipped, scenes):
    """Every tier past its budget: the host refine_grid path in both; a
    first tier past its budget: the second tier in both."""
    j, t = generators(jax_net, shipped, resolution0=16, upsampling_steps=1, strategy="refine")
    full = t._refine_tiers[1]
    j._refine_tiers = t._refine_tiers = [(8, (8,))]
    j._refine_band_cache = {}
    mj, sj = j.generate_mesh(scenes[0])
    mt, st = t.generate_mesh(scenes[0])
    assert not sj.get("refine (device)") and not st.get("refine (device)")
    assert st["path"] == "refine (host)"
    assert_meshes(mt, mj, "host refine", tol=1e-4)
    j._refine_tiers = t._refine_tiers = [(8, (8,)), full]
    j._refine_band_cache = {}
    mj, sj = j.generate_mesh(scenes[0])
    mt, st = t.generate_mesh(scenes[0])
    assert sj["refine tier"] == st["refine tier"] == 1
    assert_meshes(mt, mj, "second tier")
