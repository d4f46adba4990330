"""Dataset IO, byte-compatible with the reference formats (counterpart of
giga_tpu/core/io.py; reference src/vgn/io.py:12-126).

Formats:
    setup.json            {"size", "intrinsic", "max_opening_width", "finger_depth"}
    scenes/<id>.npz       raw: depth_imgs + extrinsics; processed: 40^3 "grid"
    full_scenes/<id>.npz  raw: depth_imgs + extrinsics of every view
    grasps.csv            scene_id, qx, qy, qz, qw, x, y, z, width, label
                          (voxel units i, j, k in place of x, y, z in a
                          processed root)
    occ/<id>/*.npz        points (float16) + occ (bool) shards
    point_clouds/<id>.npz "pc"

The grasp table is read with the ``csv`` module into a ``GraspTable``: one
numpy array per column (``scene_id`` as str, ``label`` as int, every other
column float64), each value correctly rounded (as pandas' ``round_trip``
parser reads it; its default parser can be ~1e-16 off).
"""

from __future__ import annotations

import csv
import json
import uuid
from pathlib import Path

import numpy as np

from giga_tpu_torch.core.grasp import Grasp
from giga_tpu_torch.core.transform import Rotation, Transform

GRASP_CSV_COLUMNS = ["scene_id", "qx", "qy", "qz", "qw", "x", "y", "z", "width", "label"]


class GraspTable:
    """A grasp table: ``columns`` {name: numpy array} in the file's order;
    ``table[name]`` is a column, ``len(table)`` the number of rows."""

    def __init__(self, columns: dict):
        self.columns = columns

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def row(self, i: int, columns) -> np.ndarray:
        """Row ``i`` of the float ``columns`` as float64."""
        return np.array([self.columns[c][i] for c in columns], np.float64)

    def take(self, rows) -> "GraspTable":
        """The table of ``rows`` (indices or a boolean mask), in that order."""
        return GraspTable({k: v[rows] for k, v in self.columns.items()})


# --- setup.json ---------------------------------------------------------------------


def write_setup(root: Path, size, intrinsic, max_opening_width, finger_depth) -> None:
    data = {
        "size": size,
        "intrinsic": intrinsic.to_dict(),
        "max_opening_width": max_opening_width,
        "finger_depth": finger_depth,
    }
    write_json(data, Path(root) / "setup.json")


def read_setup(root: Path):
    from giga_tpu_torch.core.perception import CameraIntrinsic

    data = read_json(Path(root) / "setup.json")
    return (
        data["size"],
        CameraIntrinsic.from_dict(data["intrinsic"]),
        data["max_opening_width"],
        data["finger_depth"],
    )


# --- scene sensor data --------------------------------------------------------------


def write_sensor_data(root: Path, depth_imgs, extrinsics, scene_id: str | None = None) -> str:
    if scene_id is None:
        scene_id = uuid.uuid4().hex
    path = Path(root) / "scenes" / (scene_id + ".npz")
    np.savez_compressed(path, depth_imgs=depth_imgs, extrinsics=extrinsics)
    return scene_id


def write_full_sensor_data(root: Path, depth_imgs, extrinsics, scene_id: str | None = None) -> str:
    if scene_id is None:
        scene_id = uuid.uuid4().hex
    path = Path(root) / "full_scenes" / (scene_id + ".npz")
    np.savez_compressed(path, depth_imgs=depth_imgs, extrinsics=extrinsics)
    return scene_id


def read_sensor_data(root: Path, scene_id: str):
    data = np.load(Path(root) / "scenes" / (scene_id + ".npz"))
    return data["depth_imgs"], data["extrinsics"]


def read_full_sensor_data(root: Path, scene_id: str):
    data = np.load(Path(root) / "full_scenes" / (scene_id + ".npz"))
    return data["depth_imgs"], data["extrinsics"]


# --- grasps.csv ---------------------------------------------------------------------


def write_grasp(root: Path, scene_id: str, grasp: Grasp, label) -> None:
    csv_path = Path(root) / "grasps.csv"
    if not csv_path.exists():
        create_csv(csv_path, GRASP_CSV_COLUMNS)
    qx, qy, qz, qw = grasp.pose.rotation.as_quat()
    x, y, z = grasp.pose.translation
    append_csv(csv_path, scene_id, qx, qy, qz, qw, x, y, z, grasp.width, int(label))


def read_grasp(df: GraspTable, i: int):
    scene_id = df["scene_id"][i]
    orientation = Rotation.from_quat(df.row(i, ("qx", "qy", "qz", "qw")))
    position = df.row(i, ("x", "y", "z"))
    return scene_id, Grasp(Transform(orientation, position), df["width"][i]), df["label"][i]


def read_csv(path: Path, text=("scene_id",), ints=("label",)) -> GraspTable:
    """A csv file as a GraspTable: the ``text`` columns as str, the ``ints``
    as int64, every other column float64."""
    with Path(path).open(newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    columns = {}
    for c, name in enumerate(header):
        col = [r[c] for r in body]
        if name in text:
            columns[name] = np.array(col, dtype=str)
        elif name in ints:
            columns[name] = np.array([int(v) for v in col], np.int64)
        else:
            columns[name] = np.array([float(v) for v in col], np.float64)
    return GraspTable(columns)


def read_df(root: Path) -> GraspTable:
    return read_csv(Path(root) / "grasps.csv")


def write_df(df: GraspTable, root: Path) -> None:
    with (Path(root) / "grasps.csv").open("w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(list(df.columns))
        for i in range(len(df)):
            writer.writerow([_cell(col[i]) for col in df.columns.values()])


def _cell(v) -> str:
    """A value as pandas writes it: shortest round-trip repr of a float."""
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return str(v.item() if isinstance(v, np.generic) else v)


# --- voxel grids / point clouds -----------------------------------------------------


def write_voxel_grid(root: Path, scene_id: str, voxel_grid) -> None:
    np.savez_compressed(Path(root) / "scenes" / (scene_id + ".npz"), grid=voxel_grid)


def read_voxel_grid(root: Path, scene_id: str) -> np.ndarray:
    return np.load(Path(root) / "scenes" / (scene_id + ".npz"))["grid"]


def write_point_cloud(root: Path, scene_id: str, point_cloud, name: str = "point_clouds") -> None:
    np.savez_compressed(Path(root) / name / (scene_id + ".npz"), pc=point_cloud)


def read_point_cloud(root: Path, scene_id: str, name: str = "point_clouds") -> np.ndarray:
    return np.load(Path(root) / name / (scene_id + ".npz"))["pc"]


# --- json / csv primitives ----------------------------------------------------------


def read_json(path: Path):
    with Path(path).open("r") as f:
        return json.load(f)


def write_json(data, path: Path) -> None:
    with Path(path).open("w") as f:
        json.dump(data, f, indent=4)


def create_csv(path: Path, columns) -> None:
    with Path(path).open("w") as f:
        f.write(",".join(columns) + "\n")


def append_csv(path: Path, *args) -> None:
    with Path(path).open("a") as f:
        f.write(",".join(str(a) for a in args) + "\n")
