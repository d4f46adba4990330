"""Occupancy voxel grids and binvox files (counterpart of
giga_tpu/geometry/voxelgrid.py; role of ConvONets/utils/voxels.py and
binvox_rw.py).

A grid covers the cube ``loc + scale * [-0.5, 0.5]^3``: voxel (i, j, k)
spans [i/R, (i+1)/R) of the unit cube before loc and scale. ``to_mesh``
emits the faces of occupied cells that border empty ones, vertices shared.
binvox stores the occupancy run-length encoded in xzy order, ``translate``
as the box's min corner and ``scale`` as its edge.
"""

from __future__ import annotations

import numpy as np

from giga_tpu_torch.geometry.mesh import TriMesh

# the 6 oriented cube faces as quads of cube-corner ids (corner c at
# ((c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1)), each wound to face outwards
_FACE_QUADS = {
    (0, -1): (0, 4, 6, 2),
    (0, +1): (1, 3, 7, 5),
    (1, -1): (0, 1, 5, 4),
    (1, +1): (2, 6, 7, 3),
    (2, -1): (0, 2, 3, 1),
    (2, +1): (4, 5, 7, 6),
}
_CORNERS = np.array([[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.float64)


class VoxelGrid:
    """Dense boolean occupancy over ``loc + scale * [-0.5, 0.5]^3``."""

    def __init__(self, data, loc=(0.0, 0.0, 0.0), scale=1.0):
        data = np.asarray(data, bool)
        assert data.ndim == 3 and len(set(data.shape)) == 1, data.shape
        self.data = data
        self.loc = np.asarray(loc, np.float64)
        self.scale = float(scale)

    @property
    def resolution(self) -> int:
        return self.data.shape[0]

    @classmethod
    def from_mesh(cls, mesh: TriMesh, resolution: int, loc=None, scale=None,
                  method: str = "solid") -> "VoxelGrid":
        """Voxelize a mesh: 'solid' (voxel centres inside) or 'surface' (the shell).
        Without loc / scale the box is the mesh's, padded as the reference
        pads it (voxels.py:31: scale / (1 - 2 / R))."""
        from giga_tpu_torch.geometry import voxelize

        if loc is None or scale is None:
            lo, hi = mesh.bounds
            loc = (lo + hi) / 2 if loc is None else np.asarray(loc, np.float64)
            scale = float((hi - lo).max() / (1 - 2.0 / resolution)) if scale is None else scale
        m = mesh.copy().apply_translation(-np.asarray(loc)).apply_scale(1.0 / scale)
        bounds = np.array([[-0.5] * 3, [0.5] * 3])
        fn = voxelize.voxelize_solid if method == "solid" else voxelize.voxelize_surface
        return cls(fn(m, resolution, bounds=bounds).astype(bool), loc, scale)

    def down_sample(self, factor: int = 2) -> "VoxelGrid":
        """A coarse cell is occupied if any of its fine cells is."""
        R = self.resolution
        assert R % factor == 0, (R, factor)
        r = R // factor
        d = self.data.reshape(r, factor, r, factor, r, factor)
        return VoxelGrid(d.any(axis=(1, 3, 5)), self.loc, self.scale)

    def contains(self, points: np.ndarray) -> np.ndarray:
        """(..., 3) world points -> bool occupancy (False outside the box)."""
        p = (np.asarray(points, np.float64) - self.loc) / self.scale + 0.5
        idx = np.floor(p * self.resolution).astype(np.int64)
        ok = np.all((idx >= 0) & (idx < self.resolution), axis=-1)
        idx = np.clip(idx, 0, self.resolution - 1)
        return ok & self.data[idx[..., 0], idx[..., 1], idx[..., 2]]

    def to_mesh(self) -> TriMesh:
        """The occupied cells' boundary faces (interior faces culled), vertices
        shared, in world coordinates."""
        R = self.resolution
        occ = np.pad(self.data, 1)
        quads = []
        grid = np.stack(np.meshgrid(*[np.arange(R)] * 3, indexing="ij"), -1)
        for (ax, sign), quad in _FACE_QUADS.items():
            sl = [slice(1, R + 1)] * 3
            sl[ax] = slice(2, R + 2) if sign > 0 else slice(0, R)
            cells = grid[self.data & ~occ[tuple(sl)]]
            if len(cells):
                quads.append(cells[:, None, :] + _CORNERS[list(quad)][None])
        if not quads:
            return TriMesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
        q = np.concatenate(quads)
        flat = (q[..., 0] * (R + 1) + q[..., 1]) * (R + 1) + q[..., 2]
        uniq, inv = np.unique(flat.astype(np.int64), return_inverse=True)
        inv = inv.reshape(-1, 4)
        verts = np.stack([uniq // ((R + 1) ** 2), (uniq // (R + 1)) % (R + 1), uniq % (R + 1)],
                         axis=-1).astype(np.float64)
        verts = (verts / R - 0.5) * self.scale + self.loc
        return TriMesh(verts, np.concatenate([inv[:, [0, 1, 2]], inv[:, [0, 2, 3]]]))


def read_binvox(fp) -> VoxelGrid:
    """A binvox file (a binary stream) -> VoxelGrid; loc is the box's centre."""
    if not fp.readline().strip().startswith(b"#binvox"):
        raise IOError("not a binvox file")
    dims = translate = scale = None
    while True:
        line = fp.readline().strip()
        if line.startswith(b"data"):
            break
        tok = line.split()
        if tok[0] == b"dim":
            dims = [int(v) for v in tok[1:]]
        elif tok[0] == b"translate":
            translate = [float(v) for v in tok[1:]]
        elif tok[0] == b"scale":
            scale = float(tok[1])
    raw = np.frombuffer(fp.read(), np.uint8)
    flat = np.repeat(raw[::2].astype(bool), raw[1::2])
    assert flat.size == int(np.prod(dims)), (flat.size, dims)
    data = flat.reshape(dims[0], dims[2], dims[1]).transpose(0, 2, 1)  # xzy -> xyz
    return VoxelGrid(data, np.asarray(translate) + scale / 2.0, scale)


def write_binvox(grid: VoxelGrid, fp) -> None:
    """A VoxelGrid as a binvox file (runs of at most 255, xzy order)."""
    R = grid.resolution
    translate = grid.loc - grid.scale / 2.0
    fp.write(b"#binvox 1\n")
    fp.write(f"dim {R} {R} {R}\n".encode())
    fp.write(("translate %.6g %.6g %.6g\n" % tuple(translate)).encode())
    fp.write(f"scale {grid.scale:.6g}\n".encode())
    fp.write(b"data\n")
    flat = grid.data.transpose(0, 2, 1).reshape(-1).astype(np.uint8)  # xyz -> xzy
    change = np.nonzero(np.diff(flat))[0] + 1
    out = []
    for s, e in zip(np.concatenate([[0], change]), np.concatenate([change, [flat.size]])):
        v, n = flat[s], e - s
        while n > 255:
            out += [v, 255]
            n -= 255
        out += [v, n]
    fp.write(np.asarray(out, np.uint8).tobytes())
