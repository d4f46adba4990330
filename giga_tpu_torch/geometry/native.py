"""Build and load the host geometry library (counterpart of
giga_tpu/geometry/native.py): marching tetrahedra (dense and sparse),
quadric simplification, ray-stabbing mesh containment, surface
voxelization and z-buffered rasterization, in C++ under ``csrc/``.

The sources are compiled by ``g++`` with the JAX package's flags (so the
outputs are bit for bit those of its library) into
``build/giga_tpu_torch/libgeometry-<hash>.so`` at the repository root, the
name a hash of the sources, the flags and the host CPU's features, and
loaded with ``ctypes``. Nothing
is built at import: the first call builds the library (to a temporary
name, then an atomic rename, so processes racing the build never load a
half-written file). A failed build raises with the compiler's output;
nothing falls back to another path. ``contains_plain`` and
``raster_plain`` are numpy versions of the containment test and the
rasterizer, called by name only (by the tests).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "giga_tpu_torch"
SOURCES = ("containment", "marching", "raster", "simplify", "voxelize")
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None

_D = ctypes.POINTER(ctypes.c_double)
_I = ctypes.POINTER(ctypes.c_int64)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_I64 = ctypes.c_int64
_F64 = ctypes.c_double


def _host_tag() -> bytes:
    """The CPU's feature flags: ``-march=native`` builds for this CPU, so a
    build directory shared with another host must not hand it this one's
    library."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("flags")), "").encode()
    except OSError:
        return platform.machine().encode()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _host_tag())
    for name in SOURCES:
        h.update((CSRC / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"libgeometry-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, *(str(CSRC / f"{n}.cpp") for n in SOURCES), "-o", str(tmp)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the geometry library needs a C++ compiler") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build the geometry library:\n{out.stderr}")
    os.replace(tmp, lib)


def get_lib() -> ctypes.CDLL:
    """The bound library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            _lib = _bind(ctypes.CDLL(str(path)))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    out_mesh = [ctypes.POINTER(_D), _I, ctypes.POINTER(_I), _I]
    sigs = {
        "mesh_contains": [_D, _I64, _I, _I64, _D, _I64, _U8],
        "marching_tetrahedra": [_D, _I64, _I64, _I64, _F64, *out_mesh],
        "marching_tetrahedra_cells": [_I, _D, _I64, _I64, _I64, _I64, _F64, *out_mesh],
        "voxelize_surface_exact": [_D, _I64, _I, _I64, _I64, _D, _D, _U8],
        "raster_mesh": [_D, _I64, _I, _I64, _U8, _F64, _F64, _F64, _F64, _I64, _I64,
                        _F64, _F64, _D, _U8, _D],
        "simplify_mesh": [_D, _I64, _I, _I64, _I64, _F64, *out_mesh],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, args
    lib.free_mesh_buffers.restype = None
    lib.free_mesh_buffers.argtypes = [_D, _I]
    return lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _call_mesh(fn, *args, what: str):
    """Run a library function that returns a malloc'd mesh -> (verts (V, 3)
    float64, faces (F, 3) int64), the buffers freed after the copy."""
    verts_p, tris_p = _D(), _I()
    nverts, ntris = ctypes.c_int64(), ctypes.c_int64()
    rc = fn(*args, ctypes.byref(verts_p), ctypes.byref(nverts), ctypes.byref(tris_p),
            ctypes.byref(ntris))
    if rc != 0:
        raise MemoryError(f"{what} allocation failed")
    try:
        nv, nt = nverts.value, ntris.value
        verts = (np.ctypeslib.as_array(verts_p, shape=(nv * 3,)).copy().reshape(nv, 3)
                 if nv else np.zeros((0, 3)))
        tris = (np.ctypeslib.as_array(tris_p, shape=(nt * 3,)).copy().reshape(nt, 3)
                if nt else np.zeros((0, 3), np.int64))
    finally:
        get_lib().free_mesh_buffers(verts_p, tris_p)
    return verts, tris


def check_mesh_contains(mesh, points: np.ndarray) -> np.ndarray:
    """(N,) bool: is each point inside the (assumed watertight) mesh? +z ray
    stabbing (role of the reference's libmesh check_mesh_contains)."""
    points = np.ascontiguousarray(points, dtype=np.float64).reshape(-1, 3)
    verts = np.ascontiguousarray(mesh.vertices, dtype=np.float64)
    faces = np.ascontiguousarray(mesh.faces, dtype=np.int64)
    n = len(points)
    if len(faces) == 0 or n == 0:
        return np.zeros(n, dtype=bool)
    out = np.zeros(n, dtype=np.uint8)
    rc = get_lib().mesh_contains(_ptr(verts, _D), len(verts), _ptr(faces, _I), len(faces),
                                 _ptr(points, _D), n, _ptr(out, _U8))
    if rc != 0:
        raise MemoryError("mesh_contains allocation failed")
    return out.astype(bool)


def marching_tetrahedra(grid: np.ndarray, iso: float):
    """Isosurface of a dense (nx, ny, nz) grid -> (vertices, faces).

    Vertices are in index coordinates; triangles wind so normals point
    toward lower field values (outward for occupancy grids)."""
    grid = np.ascontiguousarray(grid, dtype=np.float64)
    nx, ny, nz = grid.shape
    lib = get_lib()
    return _call_mesh(lib.marching_tetrahedra, _ptr(grid, _D), nx, ny, nz, float(iso),
                      what="marching_tetrahedra")


def marching_tetrahedra_cells(cell_ids: np.ndarray, corner_vals: np.ndarray, shape, iso: float):
    """Sparse isosurface: triangulate only the listed cells -> (verts, faces).

    ``cell_ids`` are flat indices into the (nx-1, ny-1, nz-1) cell lattice of
    a conceptual (nx, ny, nz) = ``shape`` grid; ``corner_vals`` is
    (ncells, 8) in cube-corner order (bit 0 -> +x, 1 -> +y, 2 -> +z).
    Vertices are in grid index coordinates, wound outward (toward lower
    values)."""
    cell_ids = np.ascontiguousarray(cell_ids, dtype=np.int64).reshape(-1)
    corner_vals = np.ascontiguousarray(corner_vals, dtype=np.float64).reshape(-1, 8)
    if len(cell_ids) != len(corner_vals):
        raise ValueError(f"{len(cell_ids)} cell ids for {len(corner_vals)} corner rows")
    nx, ny, nz = shape
    lib = get_lib()
    return _call_mesh(lib.marching_tetrahedra_cells, _ptr(cell_ids, _I), _ptr(corner_vals, _D),
                      len(cell_ids), nx, ny, nz, float(iso), what="marching_tetrahedra_cells")


def simplify_mesh(mesh, target_faces: int, aggressiveness: float = 7.0):
    """Quadric-error-metric decimation -> new (vertices, faces). Stops early
    if no more collapses pass the flip check."""
    verts = np.ascontiguousarray(mesh.vertices, dtype=np.float64)
    faces = np.ascontiguousarray(mesh.faces, dtype=np.int64)
    lib = get_lib()
    return _call_mesh(lib.simplify_mesh, _ptr(verts, _D), len(verts), _ptr(faces, _I),
                      len(faces), int(target_faces), float(aggressiveness),
                      what="simplify_mesh")


def raster_mesh(verts_cam: np.ndarray, faces: np.ndarray, face_colors: np.ndarray,
                fx: float, fy: float, cx: float, cy: float, width: int, height: int,
                background, ambient: float = 0.35, znear: float = 1e-4,
                light=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Z-buffered flat-shaded rasterization -> (H, W, 3) uint8 image.

    ``verts_cam`` are camera-frame positions (+z forward); ``face_colors``
    is (F, 4) RGBA (faces with alpha < 255 blend over the opaque pass)."""
    verts_cam = np.ascontiguousarray(verts_cam, dtype=np.float64).reshape(-1, 3)
    faces = np.ascontiguousarray(faces, dtype=np.int64).reshape(-1, 3)
    face_colors = np.ascontiguousarray(face_colors, dtype=np.uint8).reshape(-1, 4)
    if len(face_colors) != len(faces):
        raise ValueError(f"{len(face_colors)} face colors for {len(faces)} faces")
    img = np.empty((height, width, 3), np.uint8)
    img[:] = np.asarray(background, np.uint8)
    if len(faces) == 0:
        return img
    light = np.ascontiguousarray(light, dtype=np.float64)
    zbuf = np.empty((height, width), np.float64)
    rc = get_lib().raster_mesh(
        _ptr(verts_cam, _D), len(verts_cam), _ptr(faces, _I), len(faces),
        _ptr(face_colors, _U8), float(fx), float(fy), float(cx), float(cy), int(width),
        int(height), float(ambient), float(znear), _ptr(light, _D), _ptr(img, _U8),
        _ptr(zbuf, _D))
    if rc != 0:
        raise MemoryError("raster_mesh allocation failed")
    return img


def raster_plain(verts_cam, faces, face_colors, fx, fy, cx, cy, width, height, img,
                 ambient, znear, light):
    """Per-face numpy version of raster.cpp (slow; small meshes), drawing
    into ``img`` (H, W, 3) uint8 filled with the background."""
    L = light / max(np.linalg.norm(light), 1e-12)
    zbuf = np.full((height, width), np.inf)
    tri_all = verts_cam[faces]  # (F, 3, 3)
    order = np.concatenate([np.flatnonzero(face_colors[:, 3] == 255),
                            np.flatnonzero(face_colors[:, 3] < 255)])
    for f in order:
        tri = tri_all[f]
        if np.any(tri[:, 2] <= znear):
            continue
        su = fx * tri[:, 0] / tri[:, 2] + cx
        sv = fy * tri[:, 1] / tri[:, 2] + cy
        sz = 1.0 / tri[:, 2]
        area = (su[1] - su[0]) * (sv[2] - sv[0]) - (sv[1] - sv[0]) * (su[2] - su[0])
        if abs(area) < 1e-12:
            continue
        n = np.cross(tri[1] - tri[0], tri[2] - tri[0])
        n /= max(np.linalg.norm(n), 1e-300)
        shade = ambient + (1 - ambient) * abs(float(n @ L))
        rgb = face_colors[f, :3].astype(np.float64) * shade
        a01 = face_colors[f, 3] / 255.0
        x0 = max(int(np.floor(su.min())), 0)
        x1 = min(int(np.ceil(su.max())), width - 1)
        y0 = max(int(np.floor(sv.min())), 0)
        y1 = min(int(np.ceil(sv.max())), height - 1)
        if x1 < x0 or y1 < y0:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1 + 1) + 0.5, np.arange(y0, y1 + 1) + 0.5)
        w0 = ((su[1] - xs) * (sv[2] - ys) - (sv[1] - ys) * (su[2] - xs)) / area
        w1 = ((su[2] - xs) * (sv[0] - ys) - (sv[2] - ys) * (su[0] - xs)) / area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        z = 1.0 / (w0 * sz[0] + w1 * sz[1] + w2 * sz[2])
        sub_z = zbuf[y0:y1 + 1, x0:x1 + 1]
        sub_img = img[y0:y1 + 1, x0:x1 + 1]
        if a01 >= 1.0:
            upd = inside & (z < sub_z)
            sub_z[upd] = z[upd]
            sub_img[upd] = (rgb + 0.5).astype(np.uint8)
        else:
            upd = inside & (z <= sub_z)
            sub_img[upd] = (a01 * rgb + (1 - a01) * sub_img[upd] + 0.5).astype(np.uint8)
    return img


def contains_plain(verts, faces, points, chunk: int = 2048) -> np.ndarray:
    """Vectorized numpy version of the containment test: +z ray stabbing
    without spatial hashing."""
    tri = verts[faces]  # (F, 3, 3)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    v0 = b[:, :2] - a[:, :2]
    v1 = c[:, :2] - a[:, :2]
    det = v0[:, 0] * v1[:, 1] - v0[:, 1] * v1[:, 0]
    ok = np.abs(det) > 1e-300
    inv_det = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    out = np.zeros(len(points), dtype=bool)
    for s in range(0, len(points), chunk):
        p = points[s:s + chunk]
        q = p[:, None, :2] - a[None, :, :2]  # (P, F, 2)
        u = (q[..., 0] * v1[:, 1] - q[..., 1] * v1[:, 0]) * inv_det
        v = (v0[:, 0] * q[..., 1] - v0[:, 1] * q[..., 0]) * inv_det
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1)
        z = a[:, 2] + u * (b[:, 2] - a[:, 2]) + v * (c[:, 2] - a[:, 2])
        above = hit & (z > p[:, None, 2])
        out[s:s + chunk] = (above.sum(axis=1) % 2).astype(bool)
    return out
