"""Mesh <-> solver-vector remaps.

Port of ``sanm_tpu/fea/remap.py`` (reference ``MeshShapeMatTrans`` /
``MeshForceOutputTrans``, ``fea/mesh_template.h:19-161``), following the
NumPy numbering of its pure-Python branch, written with array
operations instead of per-tet loops:

* :class:`ShapeMatRemap` maps the flat unknown vector (free vertex
  coordinates) to the per-tet shape matrices Ds (T, 3, 3), with fixed
  coordinates folded into a constant bias;
* :class:`ForceOutputRemap` maps per-tet stress tensors to the
  per-unknown nodal force: f[(v,c)] = sum over adjacent tets e of
  sigma_e[c, :] . n_{e, corner(v)}.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..solver.remap import LinearRemap
from ..utils import SANMError


class ShapeMatRemap:
    """``fixed_mask``: (V, 3) bool, True = coordinate is fixed (not an
    unknown).  ``init_vtx_coord``: starting coordinates (defaults to the
    mesh's).  A ``vtx_delta`` (implicit continuation) belongs to a later
    slice of the port and raises."""

    def __init__(self, mesh, fixed_mask,
                 init_vtx_coord: Optional[np.ndarray] = None,
                 vtx_delta: Optional[np.ndarray] = None):
        if vtx_delta is not None:
            raise SANMError("vtx_delta (implicit continuation) is not "
                            "ported yet")
        self.mesh = mesh
        dim = 3
        V = mesh.nr_vertices
        fixed = np.asarray(fixed_mask, bool).reshape(V, dim)
        if init_vtx_coord is None:
            init_vtx_coord = mesh.vertices
        init = np.asarray(init_vtx_coord, np.float64).reshape(V, dim)

        # unknown numbering: (vertex, coord) row-major over free coords
        vtx2uidx = -np.ones((V, dim), np.int64)
        free = ~fixed
        n_unknown = int(free.sum())
        vtx2uidx[free] = np.arange(n_unknown)
        self.vtx2uidx = vtx2uidx
        self.x0 = init[free].astype(np.float64)
        self.vertex_loc = np.argwhere(free)  # vertex_loc[u] = (vertex, coord)
        self.n_unknown_vtx = n_unknown
        self.fixed_mask = fixed

        # Ds[e, r, m-1] = x[v_m][r] - x[v_0][r]; output row e*9 + r*3 + m-1
        tets = mesh.tets.astype(np.int64)
        T = tets.shape[0]
        u0 = np.broadcast_to(vtx2uidx[tets[:, 0]][:, :, None], (T, dim, dim))
        um = np.transpose(vtx2uidx[tets[:, 1:]], (0, 2, 1))  # (T, r, m)
        x0c = np.broadcast_to(init[tets[:, 0]][:, :, None], (T, dim, dim))
        xmc = np.transpose(init[tets[:, 1:]], (0, 2, 1))
        f0, fm = u0 >= 0, um >= 0
        bias = np.zeros((T, dim, dim))
        bias = np.where(f0, bias, bias - x0c)
        bias = np.where(fm, bias, bias + xmc)
        self.bias = bias

        both = f0 & fm
        width = 2 if both.any() else 1
        idx = np.zeros((T, dim, dim, width), np.int64)
        coef = np.zeros((T, dim, dim, width))
        # first slot: the v0 entry if free, else the vm entry
        idx[..., 0] = np.where(f0, u0, np.where(fm, um, 0))
        coef[..., 0] = np.where(f0, -1.0, np.where(fm, 1.0, 0.0))
        if width == 2:
            idx[..., 1] = np.where(both, um, 0)
            coef[..., 1] = np.where(both, 1.0, 0.0)
        self.remap = LinearRemap(
            idx.reshape(T * dim * dim, width),
            coef.reshape(T * dim * dim, width),
            n_unknown, (T, dim, dim),
        )

    def copy_vtx_values(self, vtx_values):
        """Gather per-vertex values (e.g. load forces) into the unknown
        ordering (reference ``copy_vtx_values``,
        ``fea/mesh_template.h:113-127``)."""
        vals = np.asarray(vtx_values).reshape(self.vtx2uidx.shape)
        return vals[~self.fixed_mask]


class ForceOutputRemap:
    """Reference ``MeshForceOutputTrans`` (``fea/mesh_template.h:129-161``).

    Row u = (v, c) lists, for every (tet e, corner s) holding v in
    ascending (e, s) order, the entries (e*9 + c*3 + j, n[e, s, j])."""

    def __init__(self, shape_trans: ShapeMatRemap):
        mesh = shape_trans.mesh
        dim = 3
        norms = mesh.vertex_norms  # (T, 4, 3)
        T = mesh.nr_tet
        V = mesh.nr_vertices

        # vertex -> (tet, corner) adjacency, ascending flat tet*4+corner
        flat_v = mesh.tets.reshape(-1).astype(np.int64)
        order = np.argsort(flat_v, kind="stable")
        deg = np.bincount(flat_v, minlength=V)
        start = np.zeros(V + 1, np.int64)
        np.cumsum(deg, out=start[1:])

        vloc = shape_trans.vertex_loc
        n = vloc.shape[0]
        uv, uc = vloc[:, 0], vloc[:, 1]
        udeg = deg[uv]
        maxdeg = int(udeg.max(initial=1))
        k = np.arange(maxdeg)
        live = k[None, :] < udeg[:, None]  # (n, maxdeg)
        pos = np.where(live, start[uv][:, None] + k[None, :], 0)
        p = order[pos]  # flat tet*4+corner
        e, s = p // 4, p % 4
        j = np.arange(dim)
        idx = e[:, :, None] * 9 + uc[:, None, None] * 3 + j[None, None, :]
        coef = norms[e, s]  # (n, maxdeg, 3)
        idx = np.where(live[:, :, None], idx, 0).reshape(n, maxdeg * dim)
        coef = np.where(live[:, :, None], coef, 0.0).reshape(n, maxdeg * dim)
        self.remap = LinearRemap(idx, coef, T * dim * dim, (n,))
