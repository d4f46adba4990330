#!/usr/bin/env python3
"""Render saved rollout snapshots to PNG frames (counterpart of
scripts/render_rollouts.py; reference scripts/render_rollouts_nvisii.py).

    python3 -m giga_tpu_torch.scripts.render_rollouts ROLLOUT_DIR OUT_DIR
        [--software] [--spp 64]

Run from the repository root. Uses the NViSII path tracer when installed;
otherwise the software rasterizer (utils/render.py), host C++, so rollouts
render anywhere. Every round_* directory of ROLLOUT_DIR (as
``sim_grasp_save_scene`` writes them) becomes OUT_DIR/round_*/NNNNNNNN.png.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def make_renderer(args):
    from giga_tpu_torch.utils.nvisii_render import NVISII_AVAILABLE

    if NVISII_AVAILABLE and not args.software:
        from giga_tpu_torch.utils.nvisii_render import NViSIIRenderer

        return NViSIIRenderer(spp=args.spp)
    from giga_tpu_torch.utils.render import SoftwareRenderer

    return SoftwareRenderer()


def main(args) -> None:
    renderer = make_renderer(args)
    for round_dir in sorted(args.rollout_dir.glob("round_*")):
        renderer.render_rollout(round_dir, args.out_dir / round_dir.name)
    renderer.close()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("rollout_dir", type=Path)
    p.add_argument("out_dir", type=Path)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--software", action="store_true", help="force the software rasterizer")
    p.add_argument("--device", type=str, default=None,
                   help="accepted as every clutter-removal command line takes it; both "
                        "renderers choose their own device (the rasterizer runs on the host)")
    return p


if __name__ == "__main__":
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    main(parser().parse_args())
