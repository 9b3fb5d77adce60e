"""State carried across from the JAX package's host arrays.

:func:`state_from_numpy` takes the host (NumPy) arrays that describe one
FEA model (forward or inverse), as the JAX package holds them, and
returns the port's tensors on a given device.  Feeding both packages
identical state this way keeps a kernel's error apart from a difference
in host plans.
This system has no model weights; this is its counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from . import resolve_device
from .ops.elements import Elements, InvElements
from .solver.assemble import DeviceAssembler
from .utils import SANMError


@dataclass
class SliceState:
    vertices: np.ndarray  # (V, 3) host
    tets: np.ndarray  # (T, 4) host
    fixed_mask: np.ndarray  # (V, 3) host bool
    x0: torch.Tensor  # (n,)
    f_load_sub: torch.Tensor  # (n,)
    elems: Elements  # or InvElements for an inverse model
    asm: DeviceAssembler


def state_from_numpy(*, vertices, tets, fixed_mask, bias, x0, f_load_sub,
                     Lin, Lout, loc_rows, loc_cols, slot_pos, csr_rowidx,
                     csr_cols, mu, lam, kappa, dm_inv=None, ds=None,
                     device=None) -> SliceState:
    """Port tensors (float64, int32 indices) from host arrays: the mesh,
    the fixed mask, the shape-matrix ``bias`` (T, 3, 3), ``x0`` and
    ``f_load_sub`` (n,), the assembler plan (``Lin``, ``Lout``,
    ``loc_rows``, ``loc_cols``, ``slot_pos``, ``csr_rowidx``,
    ``csr_cols``) with the Lame parameters and the bulk modulus (every
    material's kernels read the same per-element constants), and one of
    ``dm_inv`` (T, 3, 3), for a forward model, or ``ds`` (T, 3, 3), the
    given mesh's shape matrix of an inverse model."""
    if (dm_inv is None) == (ds is None):
        raise SANMError("give one of dm_inv (forward) and ds (inverse)")
    dev = resolve_device(device)
    T = np.asarray(tets).shape[0]
    n = np.asarray(x0).size

    def f64(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float64)).to(dev)

    cls, mat = (Elements, dm_inv) if ds is None else (InvElements, ds)
    elems = cls(f64(np.reshape(mat, (T, 9))),
                bias=f64(np.reshape(bias, (T, 9))),
                mu=float(mu), lam=float(lam), kappa=float(kappa))
    csr = SimpleNamespace(slot_pos=slot_pos, csr_rowidx=csr_rowidx,
                          csr_cols=csr_cols, t_slot_row=None, has_t=False)
    asm = DeviceAssembler(Lin, Lout, loc_rows, loc_cols, n_rows=n, n=n,
                          device=dev, csr=csr)
    return SliceState(
        vertices=np.asarray(vertices, np.float64),
        tets=np.asarray(tets, np.int32),
        fixed_mask=np.asarray(fixed_mask, bool),
        x0=f64(np.reshape(x0, -1)),
        f_load_sub=f64(np.reshape(f_load_sub, -1)),
        elems=elems,
        asm=asm,
    )
