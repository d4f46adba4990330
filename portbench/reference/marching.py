"""Plain marching tetrahedra in numpy: the iso-surface of a lattice of
values, each cell split into the six tetrahedra that share its main
diagonal (corner 0 to corner 7; corner bit 0 is +x, bit 1 +y, bit 2 +z).

Every edge of that split runs from a lattice point a to a + d with d in
{0, 1}^3 (``DIRS``), and a surface vertex on it sits at a + t d, t = (iso -
f(a)) / (f(a + d) - f(a)). A tetrahedron with one or three corners above
the iso level holds one triangle, with two holds two. This is the
reference's own triangulation, for the lower-precision control and for the
judge's count of triangles a cell should hold; it imports nothing of the
program.
"""

from __future__ import annotations

import numpy as np

TETS = ((0, 5, 1, 7), (0, 1, 3, 7), (0, 3, 2, 7), (0, 2, 6, 7), (0, 6, 4, 7), (0, 4, 5, 7))
# the seven edge directions, as corner ids and offsets
DIRS = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(1, 8)])


def _tet_triangles(code: int, tet) -> list:
    """Triangles of one tetrahedron with inside-corner bits ``code`` (bit k:
    ``tet[k]`` above the level), as triples of corner pairs."""
    ins = [tet[k] for k in range(4) if code >> k & 1]
    outs = [tet[k] for k in range(4) if not code >> k & 1]
    if len(ins) == 1:
        return [tuple((ins[0], o) for o in outs)]
    if len(ins) == 3:
        return [tuple((outs[0], i) for i in ins)]
    if len(ins) == 2:
        a, b, c, d = (ins[0], outs[0]), (ins[0], outs[1]), (ins[1], outs[0]), (ins[1], outs[1])
        return [(a, b, d), (a, d, c)]
    return []


def _cube_table():
    """Per cube code (8 corner bits): its triangles as corner-pair triples."""
    table = []
    for cube in range(256):
        tris = []
        for tet in TETS:
            code = sum(1 << k for k in range(4) if cube >> tet[k] & 1)
            tris += _tet_triangles(code, tet)
        table.append(tris)
    return table


CUBE_TRIANGLES = _cube_table()
TRIANGLES_PER_CUBE = np.array([len(t) for t in CUBE_TRIANGLES])


def cube_codes(values: np.ndarray, iso: float) -> np.ndarray:
    """(m-1)^3 cube codes of an m^3 lattice: bit c set where corner c of the
    cell lies above ``iso``."""
    above = values > iso
    m = np.array(values.shape)
    code = np.zeros(tuple(m - 1), np.int64)
    for c in range(8):
        dx, dy, dz = c & 1, (c >> 1) & 1, (c >> 2) & 1
        code |= above[dx:m[0] - 1 + dx, dy:m[1] - 1 + dy, dz:m[2] - 1 + dz].astype(np.int64) << c
    return code


def march(values: np.ndarray, iso: float):
    """(vertices (V, 3) in lattice index coordinates, faces (F, 3)) of the
    iso-surface of ``values``, one vertex per crossed edge."""
    values = np.asarray(values, np.float64)
    code = cube_codes(values, iso)
    cells = np.argwhere((code > 0) & (code < 255))
    codes = code[tuple(cells.T)]
    corner = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)])
    keys, tris = {}, []
    verts = []

    def vertex(cell, i, j):
        a, b = cell + corner[min(i, j)], cell + corner[max(i, j)]
        key = (tuple(a), tuple(b))
        if key not in keys:
            fa, fb = values[tuple(a)], values[tuple(b)]
            t = min(max((iso - fa) / (fb - fa), 0.0), 1.0)
            keys[key] = len(verts)
            verts.append(a + t * (b - a))
        return keys[key]

    for cell, cube in zip(cells, codes):
        for tri in CUBE_TRIANGLES[cube]:
            tris.append([vertex(cell, *pair) for pair in tri])
    if not verts:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    return np.asarray(verts, np.float64), np.asarray(tris, np.int64)
