"""The A/B scripts, on the CPU.

Each build of ``ab_dense_decode`` (K2/K3, both modes), ``ab_stem_pool`` (K1) and
``ab_dense_decode_feats`` (K4) is an edited copy of a shipped source: design
constants rewritten, statements deleted or patched, each edit's old text
found exactly once. An edit of a kernel that renames a constant or rewrites
a patched statement would otherwise break its script only on the card. Here
every build's copy is made on the CPU.

``measure_decoder_kernels`` (the decode A/B) takes ``--dtype bf16``; its
four bf16 decodes run here on CPU tensors (the kernels' plain versions) at
a small size, held as the script holds them on the card.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from giga_tpu_torch.core import config as tcfg
from giga_tpu_torch.inference.dense_decode import lattice_coords
from giga_tpu_torch.models.conv_onet import GIGANet
from giga_tpu_torch.scripts import (
    ab_dense_decode, ab_dense_decode_feats, ab_stem_pool, bf16_sum_order, measure_decoder_kernels)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

SCRIPTS = {
    "ab_dense_decode": (ab_dense_decode, "dense_decode.cu"),
    "ab_stem_pool": (ab_stem_pool, "stem_pool.cu"),
    "ab_dense_decode_feats": (ab_dense_decode_feats, "dense_decode_feats.cu"),
}
CASES = [(script, name) for script, (module, _) in SCRIPTS.items()
         for name in {**module.DESIGNS, **module.ABLATIONS, **getattr(module, "BF16_DESIGNS", {}),
                      **getattr(module, "BF16_ABLATIONS", {}),
                      **getattr(module, "OPTION_DESIGNS", {})}]


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


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_build_names_are_unique(script):
    """Every design and ablation of a script has a name of its own: the
    script merges its tables into one, where a repeated name would drop a
    build."""
    module, _ = SCRIPTS[script]
    tables = [module.DESIGNS, module.ABLATIONS, getattr(module, "BF16_DESIGNS", {}),
              getattr(module, "BF16_ABLATIONS", {}), getattr(module, "OPTION_DESIGNS", {})]
    names = [name for table in tables for name in table]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("name", list(ab_dense_decode.TREE_BF16_ABLATIONS))
def test_tree_ablations_edit_the_design_before_this_one(name):
    """--ablate-tree applies TREE_BF16_ABLATIONS to a tree of the bf16
    kernel before its TMA rows. Each edit of a shared header applies to the
    shipped one as well; the row ablation's edits of dense_decode.cu name
    that kernel's tc::rows calls, which the shipped source no longer has."""
    for fname, pairs in ab_dense_decode.TREE_BF16_ABLATIONS[name].items():
        shipped = (ab_dense_decode.CSRC / fname).read_text()
        for old, _ in pairs:
            assert shipped.count(old) == (0 if fname == "dense_decode.cu" else 1), old


def test_each_script_times_the_shipped_design_first():
    """The first design of each script is the shipped source unedited."""
    for module, _ in SCRIPTS.values():
        for designs in (module.DESIGNS, getattr(module, "BF16_DESIGNS", module.DESIGNS),
                        getattr(module, "OPTION_DESIGNS", module.DESIGNS)):
            first = next(iter(designs))
            constants, edits = module.build_edits(first)
            assert "(shipped)" in first and not constants and not any(edits.values())


@pytest.mark.parametrize("argv,dtype", [([], "fp32"), (["--dtype", "fp32"], "fp32"),
                                        (["--dtype", "bf16", "--chunks", "4"], "bf16")])
def test_measure_decoder_kernels_parses_dtype(argv, dtype):
    args = measure_decoder_kernels.parse_args(argv)
    assert args.dtype == dtype and args.batch == 64


def test_measure_decoder_kernels_refuses_other_dtypes():
    with pytest.raises(SystemExit):
        measure_decoder_kernels.parse_args(["--dtype", "fp16"])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_measure_decoder_kernels_needs_a_card(monkeypatch, capsys, dtype):
    """Without a card the script exits 2 in either mode, timing nothing
    (bf16 no longer raises)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert measure_decoder_kernels.main(["--dtype", dtype]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_measure_decoder_kernels_bf16_decodes_on_cpu():
    """The four bf16 decodes of the A/B (module path on bf16 params, K2, K4
    at two x_chunks and K5 in their bf16 modes) and K2's option rows (fold_b1
    with hidden_bf16, resident_bf16) on bf16 lattice features,
    here through the plain versions: float32 volumes of one shape, raw qual
    within the A/B's gates of K2 bf16's."""
    cfg = tcfg.GIGAConfig(
        encoder=tcfg.EncoderConfig(c_dim=8, plane_resolution=8,
                                   unet=tcfg.UNet2DConfig(depth=2, start_filts=4)),
        decoder=tcfg.DecoderConfig(c_dim=8, hidden_size=32, n_blocks=2))
    net = GIGANet(cfg)  # zeros until a checkpoint is loaded: seeded weights instead
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for w in net.parameters():
            w.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, tuple(w.shape)).astype(np.float32)))
    net = net.to(torch.bfloat16)
    R = 8
    coords = lattice_coords(R)
    feats = {t: torch.from_numpy(rng.randn(2, R, R, 8).astype(np.float32)).to(torch.bfloat16)
             for t in ("xz", "xy", "yz")}
    paths = measure_decoder_kernels.decode_paths(net.decoder_aff.params(), coords, 2, [4, 8],
                                                 torch.bfloat16)
    assert list(paths) == ["module path", "K2 projections + trunk", "K4 raw features, x_chunk=4",
                           "K4 raw features, x_chunk=8", "K5 hybrid",
                           "K2 + fold_b1, hidden_bf16", "K2 + resident_bf16"]
    with torch.inference_mode():
        ref = paths["K2 projections + trunk"](feats)
        for name, fn in paths.items():
            qual, rot, width = fn(feats)
            assert all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
                       for v in (qual, rot, width)), name
            assert qual.shape == width.shape == (2, R, R, R)
            worst, _ = chip_smoke.check_qual_bf16(qual.numpy(), ref[0].numpy(), name)
            # bf16 decodes of another design differ somewhere
            assert worst > 0 or name == "K2 projections + trunk", name


def test_measure_decoder_kernels_fp32_option_row_on_cpu():
    """The fp32 A/B's K2 + fold_b1 row, here through the plain versions:
    raw qual within the script's 1e-5 of K2's default path."""
    cfg = tcfg.GIGAConfig(
        encoder=tcfg.EncoderConfig(c_dim=8, plane_resolution=8,
                                   unet=tcfg.UNet2DConfig(depth=2, start_filts=4)),
        decoder=tcfg.DecoderConfig(c_dim=8, hidden_size=32, n_blocks=3))
    net = GIGANet(cfg)
    rng = np.random.RandomState(4)
    with torch.no_grad():
        for w in net.parameters():
            w.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, tuple(w.shape)).astype(np.float32)))
    R = 8
    feats = {t: torch.from_numpy(rng.randn(2, R, R, 8).astype(np.float32))
             for t in ("xz", "xy", "yz")}
    paths = measure_decoder_kernels.decode_paths(net.decoder_aff.params(), lattice_coords(R), 3,
                                                 [8], torch.float32)
    assert list(paths)[-1] == "K2 + fold_b1"
    with torch.inference_mode():
        fold = paths["K2 + fold_b1"](feats)[0]
        default = paths["K2 projections + trunk"](feats)[0]
    diff = float((fold - default).abs().max())
    assert 0 < diff <= measure_decoder_kernels.TOL_OPTION


def test_bf16_sum_order_runs_on_the_cpu(capsys):
    """The sum-order script at one scene on the CPU: one line per bf16 mode
    of K2, the plain versions' float32 against float64 sums, finite and
    within the resident mode's far bound."""
    assert bf16_sum_order.main(["--device", "cpu", "--batch", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == ["dense_decode_bf16", "dense_decode_bf16_fold",
                                               "dense_decode_bf16_resident",
                                               "dense_decode_bf16_resident_fold"]
    for ln in lines:
        rel = float(ln.split("max err/(1+|ref|) ")[1].split(",")[0])
        assert 0 < rel <= chip_smoke.TOL_BF16_RESIDENT_FAR


@pytest.mark.parametrize("argv", [[], ["--bf16"], ["--bf16", "--tree", "parent=."]])
def test_ab_stem_pool_needs_a_card(monkeypatch, capsys, argv):
    """K1's A/B exits 2 without a card in either mode, building nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ab_stem_pool.main(argv) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [[], ["--bf16"], ["--bf16", "--tree", "parent=."]])
def test_ab_dense_decode_feats_needs_a_card(monkeypatch, capsys, argv):
    """K4's A/B exits 2 without a card, the --bf16 parent A/B too, building
    nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ab_dense_decode_feats.main(argv) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_ab_dense_decode_feats_bf16_tells_the_signatures_apart(tmp_path):
    """--bf16 calls a source with the rounding prologue with its bf16
    workspace, an older one (the parent's) with float32 row scratch: the
    shipped source is the first kind, a source without the prologue the
    second."""
    shipped = ab_dense_decode.CSRC / "dense_decode_feats.cu"
    assert ab_dense_decode_feats.takes_workspace(shipped)
    older = tmp_path / "dense_decode_feats.cu"
    older.write_text(shipped.read_text().replace("round_features_kernel", "prologue"))
    assert not ab_dense_decode_feats.takes_workspace(older)


def test_ab_stem_pool_bf16_ablations_edit_the_bf16_kernel_only():
    """The bf16 ablations' edits fall inside stem_pool_bf16_kernel, after the
    float32 kernel, so the float32 mode of an ablation build is the shipped
    one."""
    shipped = (ab_dense_decode.CSRC / "stem_pool.cu").read_text()
    start = shipped.index("stem_pool_bf16_kernel(")
    for edits in ab_stem_pool.BF16_ABLATIONS.values():
        for old, _ in edits:
            assert shipped.index(old) > start


def test_bf16_sum_order_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bf16_sum_order.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
