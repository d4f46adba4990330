"""The design A/B scripts' builds apply to the shipped CUDA sources.

Each build of ``ab_dense_decode`` (K2/K3, both modes), ``ab_stem_pool`` (K1) and
``ab_dense_decode_feats`` (K4) is an edited copy of a shipped source: design
constants rewritten, statements deleted or patched, each edit's old text
found exactly once. An edit of a kernel that renames a constant or rewrites
a patched statement would otherwise break its script only on the card. Here
every build's copy is made on the CPU.
"""

import pytest

from giga_tpu_torch.scripts import ab_dense_decode, ab_dense_decode_feats, ab_stem_pool

SCRIPTS = {
    "ab_dense_decode": (ab_dense_decode, "dense_decode.cu"),
    "ab_stem_pool": (ab_stem_pool, "stem_pool.cu"),
    "ab_dense_decode_feats": (ab_dense_decode_feats, "dense_decode_feats.cu"),
}
CASES = [(script, name) for script, (module, _) in SCRIPTS.items()
         for name in {**module.DESIGNS, **module.ABLATIONS, **getattr(module, "BF16_DESIGNS", {})}]


@pytest.mark.parametrize("script,name", CASES)
def test_ab_build_applies_to_the_shipped_source(tmp_path, script, name):
    module, source = SCRIPTS[script]
    constants, edits = module.build_edits(name)
    copy = ab_dense_decode.edited_copy(tmp_path, source, constants, edits)
    text = copy.read_text()
    for constant, value in constants.items():
        assert f"constexpr int {constant} = {value};" in text
    shipped = (ab_dense_decode.CSRC / source).read_text()
    assert (text != shipped) == bool(constants or edits.get(source))


def test_each_script_times_the_shipped_design_first():
    """The first design of each script is the shipped source unedited."""
    for module, _ in SCRIPTS.values():
        for designs in (module.DESIGNS, getattr(module, "BF16_DESIGNS", module.DESIGNS)):
            first = next(iter(designs))
            constants, edits = module.build_edits(first)
            assert "(shipped)" in first and not constants and not any(edits.values())
