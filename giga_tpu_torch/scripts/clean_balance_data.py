#!/usr/bin/env python3
"""Clean + balance a raw grasp dataset (counterpart of
scripts/clean_balance_data.py; reference scripts/clean_balance_data.py).

    python3 -m giga_tpu_torch.scripts.clean_balance_data ROOT

Run from the repository root. Drops grasps outside the workspace margin,
downsamples negatives to match the positive count (numpy's global
generator draws the rows, as pandas' ``np.random.choice`` over the row
labels does), and deletes scene files no longer referenced by any grasp.
Host code only.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def summarize(df, title):
    pos = int((df["label"] == 1).sum())
    print(f"{title}: samples={len(df)} positives={pos} negatives={len(df) - pos}")


def main(args) -> None:
    from giga_tpu_torch.core import io

    df = io.read_df(args.root)
    summarize(df, "Before clean and balance")

    # clean: workspace margin [0.02, 0.28] on every axis
    keep = np.ones(len(df), bool)
    for axis in ("x", "y", "z"):
        keep &= (df[axis] >= 0.02) & (df[axis] <= 0.28)
    rows = np.flatnonzero(keep)  # the kept rows' labels in the file

    # balance: drop random negatives down to the positive count
    labels = df["label"][rows]
    positives, negatives = rows[labels == 1], rows[labels == 0]
    surplus = len(negatives) - len(positives)
    if surplus > 0:
        drop = np.random.choice(negatives, surplus, replace=False)
        rows = rows[~np.isin(rows, drop)]
    df = df.take(rows)
    io.write_df(df, args.root)

    # remove unreferenced scene files
    scenes = set(df["scene_id"])
    for f in (args.root / "scenes").iterdir():
        if f.suffix == ".npz" and f.stem not in scenes:
            print("Removed", f)
            f.unlink()

    summarize(io.read_df(args.root), "After clean and balance")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("root", type=Path)
    return p


if __name__ == "__main__":
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    main(parser().parse_args())
