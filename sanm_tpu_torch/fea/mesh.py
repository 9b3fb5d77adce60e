"""Tetrahedral mesh: IO, generators, cached geometry.

Port of ``sanm_tpu/fea/mesh.py`` (reference
``fea/tetrahedral_mesh.{h,cpp}``).  Host-side NumPy (mesh topology and
geometry are setup work); geometry caches are vectorized instead of the
reference's per-tet loops.

Conventions: vertices (V, 3) float64; tets (T, 4) int32.  The shape
matrix of tet (v0, v1, v2, v3) has columns x1-x0, x2-x0, x3-x0
(reference ``tetrahedral_mesh.cpp:42-47``); per-corner "vertex normals"
are the area-weighted outward normals of the opposite faces,
``-vol * D^{-T}`` up to sign handling (``tetrahedral_mesh.cpp:52-67``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np

from ..utils import sanm_assert


class TetrahedralMesh:
    def __init__(self, vertices, tets, surface_vtx=None, surfaces=None):
        self.vertices = np.asarray(vertices, np.float64).reshape(-1, 3)
        self.tets = np.asarray(tets, np.int32).reshape(-1, 4)
        self.surface_vtx: Set[int] = set(surface_vtx or [])
        self.surfaces: List = list(surfaces or [])
        self._cache: Dict = {}

    # -- basic queries ------------------------------------------------------
    @property
    def nr_vertices(self):
        return self.vertices.shape[0]

    @property
    def nr_tet(self):
        return self.tets.shape[0]

    nr_faces = nr_tet  # the reference calls tets "faces" in dim-generic code

    def copy(self):
        return TetrahedralMesh(
            self.vertices.copy(), self.tets, self.surface_vtx, self.surfaces
        )

    # -- cached geometry ------------------------------------------------------
    def _geometry(self):
        g = self._cache.get("geom")
        if g is not None:
            return g
        x = self.vertices[self.tets]  # (T, 4, 3)
        v1 = x[:, 1] - x[:, 0]
        v2 = x[:, 2] - x[:, 0]
        v3 = x[:, 3] - x[:, 0]
        ds = np.stack([v1, v2, v3], axis=2)  # columns
        det = np.einsum("ti,ti->t", v1, np.cross(v2, v3))
        vol = np.abs(det) / 6.0
        t1 = np.cross(v2, v3)
        t2 = np.cross(v3, v1)
        t3 = np.cross(v1, v2)
        sign = np.where(det > 0, -1.0, 1.0)[:, None]
        t1, t2, t3 = t1 * sign, t2 * sign, t3 * sign
        n0 = -(t1 + t2 + t3)
        norms = np.stack([n0, t1, t2, t3], axis=1) / 6.0  # (T, 4, 3)
        g = (ds, vol, norms)
        self._cache["geom"] = g
        return g

    @property
    def shape_matrix(self):
        """(T, 3, 3) rest-shape matrices D with columns x_i - x_0."""
        return self._geometry()[0]

    @property
    def tet_volumes(self):
        return self._geometry()[1]

    face_areas = tet_volumes  # dim-generic alias, cf. tetrahedral_mesh.h:48

    @property
    def vertex_norms(self):
        """(T, 4, 3) per-corner area-weighted normals."""
        return self._geometry()[2]

    # -- mutators (invalidate caches) ----------------------------------------
    def _dirty(self):
        self._cache.clear()

    def replace_with_mask(self, fixed_mask, values):
        """Write flat ``values`` into the non-fixed (vertex, coord) slots
        (reference ``fea::replace_with_mask``, ``fea/mesh.cpp:14-24``).
        ``fixed_mask``: (V, 3) bool, True = fixed."""
        flat = self.vertices.reshape(-1)
        m = ~np.asarray(fixed_mask).reshape(-1)
        vals = np.asarray(values).reshape(-1)
        sanm_assert(m.sum() == vals.size)
        flat[m] = vals
        self._dirty()

    def replace_vtx(self, vtx):
        self.vertices = np.asarray(vtx, np.float64).reshape(-1, 3).copy()
        self._dirty()

    def resize_inplace(self, scale):
        self.vertices = self.vertices * float(scale)
        self._dirty()

    # -- constructors ----------------------------------------------------------
    @staticmethod
    def make_cuboid(nx: int, ny: int, nz: int, size: float):
        """Regular cuboid split into 5 tets per hex cell (reference
        ``TetrahedralMesh::make_cuboid``, ``tetrahedral_mesh.cpp:93-204``)."""
        sanm_assert(nx >= 2 and ny >= 2 and nz >= 2 and size > 0)
        ii, jj, kk = np.meshgrid(
            np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
        )
        verts = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3) * size

        def vid(i, j, k):
            return (i * ny + j) * nz + k

        surface_vtx = set()
        for i in range(nx):
            for j in range(ny):
                for k in range(nz):
                    if (
                        i in (0, nx - 1)
                        or j in (0, ny - 1)
                        or k in (0, nz - 1)
                    ):
                        surface_vtx.add(vid(i, j, k))

        tets = []
        surfaces = []
        for i in range(nx - 1):
            for j in range(ny - 1):
                for k in range(nz - 1):
                    h = [
                        vid(i, j, k),
                        vid(i + 1, j, k),
                        vid(i + 1, j + 1, k),
                        vid(i, j + 1, k),
                        vid(i, j, k + 1),
                        vid(i + 1, j, k + 1),
                        vid(i + 1, j + 1, k + 1),
                        vid(i, j + 1, k + 1),
                    ]
                    if i == 0:
                        surfaces += [(h[3], h[0], h[7]), (h[7], h[0], h[4])]
                    if i == nx - 2:
                        surfaces += [(h[1], h[2], h[6]), (h[6], h[5], h[1])]
                    if j == 0:
                        surfaces += [(h[0], h[1], h[5]), (h[0], h[5], h[4])]
                    if j == ny - 2:
                        surfaces += [(h[7], h[6], h[3]), (h[6], h[2], h[3])]
                    if k == 0:
                        surfaces += [(h[1], h[3], h[2]), (h[0], h[3], h[1])]
                    if k == nz - 2:
                        surfaces += [(h[4], h[5], h[7]), (h[7], h[5], h[6])]
                    # the standard 5-tet split of a hexahedron
                    tets += [
                        (h[0], h[2], h[1], h[5]),
                        (h[0], h[4], h[7], h[5]),
                        (h[0], h[2], h[5], h[7]),
                        (h[2], h[6], h[5], h[7]),
                        (h[0], h[7], h[3], h[2]),
                    ]
        return TetrahedralMesh(verts, np.array(tets), surface_vtx, surfaces)

    @staticmethod
    def from_tetgen_files(filebase: str):
        """Read tetgen ``.node`` / ``.ele`` / ``.face`` files (reference
        ``tetrahedral_mesh.cpp:206-260``; formats per
        wias-berlin.de/software/tetgen)."""

        def tokens(path):
            with open(path) as f:
                text = [line.split("#", 1)[0] for line in f]
            return iter(" ".join(text).split())

        tn = tokens(filebase + ".node")
        nv, dim, nattr, bmark = (int(next(tn)) for _ in range(4))
        sanm_assert(dim == 3 and nattr == 0 and bmark == 0)
        verts = np.empty((nv, 3))
        for i in range(nv):
            idx = int(next(tn))
            sanm_assert(idx == i, "vertex index mismatch at %d", i)
            verts[i] = [float(next(tn)) for _ in range(3)]

        te = tokens(filebase + ".ele")
        nt, npt, nattr = (int(next(te)) for _ in range(3))
        sanm_assert(npt == 4 and nattr == 0)
        tets = np.empty((nt, 4), np.int32)
        for i in range(nt):
            idx = int(next(te))
            sanm_assert(idx == i)
            tets[i] = [int(next(te)) for _ in range(4)]

        surface_vtx = set()
        tf = tokens(filebase + ".face")
        nf, bmark = int(next(tf)), int(next(tf))
        for i in range(nf):
            idx = int(next(tf))
            sanm_assert(idx == i)
            a, b, c = int(next(tf)), int(next(tf)), int(next(tf))
            surface_vtx.update((a, b, c))
            if bmark:
                next(tf)
        # tetgen may invert surface orientation; keep only the vertex set
        return TetrahedralMesh(verts, tets, surface_vtx)

    # -- writers -----------------------------------------------------------------
    def write_obj(self, path, filter_set: Optional[Set[int]] = None):
        """ASCII OBJ writer (reference ``tetrahedral_mesh.cpp:262-368``):
        prefers the explicit boundary face list, then the surface-vertex
        filter, else writes all tet faces."""
        if filter_set is None and self.surfaces:
            self._write_obj_faces(path, self.surfaces)
            return
        if filter_set is None and self.surface_vtx:
            filter_set = self.surface_vtx
        self._write_obj_tets(path, filter_set)

    def _write_obj_faces(self, path, faces):
        vid_map = {}
        order = []
        for f in faces:
            for v in f:
                if v not in vid_map:
                    vid_map[v] = len(vid_map)
                    order.append(v)
        with open(path, "w") as fo:
            for v in order:
                fo.write("v %g %g %g\n" % tuple(self.vertices[v]))
            for f in faces:
                fo.write(
                    "f %d %d %d\n"
                    % (vid_map[f[0]] + 1, vid_map[f[1]] + 1, vid_map[f[2]] + 1)
                )

    def _write_obj_tets(self, path, filter_set):
        vid_map = {}
        lines_v = []
        for i in range(self.nr_vertices):
            if filter_set is None or i in filter_set:
                vid_map[i] = len(vid_map)
                lines_v.append("v %g %g %g\n" % tuple(self.vertices[i]))
        lines_f = []

        def facet(a, b, c):
            if filter_set is not None:
                if a not in filter_set or b not in filter_set or c not in filter_set:
                    return
                a, b, c = vid_map[a], vid_map[b], vid_map[c]
            lines_f.append("f %d %d %d\n" % (a + 1, b + 1, c + 1))

        V = self.vertices
        for i0, i1, i2, i3 in self.tets:
            v0 = V[i0]
            if np.dot(V[i1] - v0, np.cross(V[i2] - v0, V[i3] - v0)) > 0:
                i1, i2 = i2, i1
            facet(i0, i1, i2)
            facet(i1, i3, i2)
            facet(i1, i0, i3)
            facet(i0, i2, i3)
        with open(path, "w") as fo:
            fo.writelines(lines_v)
            fo.writelines(lines_f)

    def write_surface_vtx(self, path):
        """Write surface vertex coordinates; the surface vertex numbers
        must be 0..len-1 (reference ``write_to_surface_vtx_file``,
        ``tetrahedral_mesh.cpp:277-293``)."""
        sanm_assert(self.surface_vtx)
        ids = sorted(self.surface_vtx)
        sanm_assert(ids[0] == 0 and ids[-1] == len(ids) - 1,
                    "surface vertices must be consecutive from 0")
        with open(path, "w") as fo:
            for i in ids:
                fo.write("%g %g %g\n" % tuple(self.vertices[i]))
