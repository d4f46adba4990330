"""Minimal URDF reading (counterpart of giga_tpu/utils/urdf.py): the visual
mesh of GIGA's single-link object URDFs (reference usage:
utils/implicit.py:58-63)."""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from giga_tpu_torch.core.transform import Rotation, Transform
from giga_tpu_torch.geometry.mesh import TriMesh, load_mesh


def load_urdf_mesh(urdf_path) -> TriMesh:
    """The visual mesh of a single-link URDF, its scale and origin applied."""
    urdf_path = Path(urdf_path)
    root = ET.parse(urdf_path).getroot()
    links = root.findall("link")
    if len(links) != 1:
        raise ValueError(f"{urdf_path} has {len(links)} links; expected 1")
    visuals = links[0].findall("visual")
    if len(visuals) != 1:
        raise ValueError(f"{urdf_path} has {len(visuals)} visuals; expected 1")
    mesh_el = visuals[0].find("geometry/mesh")
    if mesh_el is None:
        raise ValueError(f"{urdf_path}: only mesh geometry is supported")
    filename, scale = mesh_el.get("filename"), mesh_el.get("scale")
    mesh_path = (urdf_path.parent / filename).resolve()
    if not mesh_path.exists():
        mesh_path = Path(filename)  # absolute or relative to the working directory
    mesh = load_mesh(mesh_path)
    if scale:
        mesh.apply_scale([float(s) for s in scale.split()])
    origin = visuals[0].find("origin")
    if origin is not None:
        xyz = [float(v) for v in (origin.get("xyz") or "0 0 0").split()]
        rpy = [float(v) for v in (origin.get("rpy") or "0 0 0").split()]
        mesh.apply_transform(Transform(Rotation.from_euler("xyz", rpy), np.asarray(xyz)).as_matrix())
    return mesh
