"""K1i: the per-order Taylor step of the inverse model's Cauchy stress.

Takes the place of the JAX package's generic Taylor engine
(``sanm_tpu/taylor.py`` + ``sanm_tpu/taylor_scan.py``) for the graph of
``DeformableBody.make_inverse`` (``sanm_tpu/fea/model.py:139-158``),
whose unknowns are the rest coordinates::

    Dm = g + bias,   F = Ds Dm^-1   (Ds: the given mesh, constant),
    NHC: sigma = mu J^-1 b - (mu J^-1 + lam J^-1 log J^-1) I,
    NHI: sigma = mu A b + ((-mu/3) A Ic + kappa J - kappa) I,  A = J^(-5/3),

with ``b = F F^T``, ``Ic = tr b``, ``J = det F``
(``sanm_tpu/fea/material.py:103-125``).  The series takes its own route
(``csrc/inv_series.cu`` writes it out): Dm's cofactor C and ``d = det Dm``
by the recurrences K1 and K1n run on F
(:func:`~.nhc_series.cofactor_det`), F itself by the div rule on
``F = (Ds C^T) / d`` (:func:`~.nhc_series.quotient`), ``b`` by the
Cauchy product of F, ``J^-1 = d / det Ds``; NHC's ``L = log J^-1`` by
the log rule, NHI's J by the quotient and A by the power rule.  Forming
b from F, as the JAX graph does, keeps the rounding at about cond(Ds)
eps; forming it from Dm^-1 (b = Ds Dm^-1 Dm^-T Ds^T) cancels terms of
cond(Ds)^2 |b| and loses two more digits on armadillo-small's worst
tets (cond 452).

Per element the series state is kept in one preallocated history
``hist`` (order+1, NC, B), float64: Dm 0-8, row 0 of its cofactor 9-11,
F 12-20, d 21, b's upper triangle 22-27 (00 01 02 11 12 22), then NHC's
L 28 (NC 29) or NHI's J 28 and A 29 (NC 30).

:func:`inv_nhc_step` and :func:`inv_nhi_step` commit order k from the
graph input ``g_k`` and return the order-(k+1) bias of sigma; each
launches the CUDA kernel for card tensors and runs :func:`inv_step_plain`
(the same function in torch ops, the CPU path and the kernel's test
oracle) for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import kernels
from .elements import InvElements
from .linalg import batched_det
from .nhc_series import NHCSeries, check_step, cofactor_det, quotient

NCOMP = {"nhc": 29, "nhi": 30}
P_EXP = -5.0 / 3.0  # A = J^P_EXP (NHI)
_D, _C0, _F, _d, _b = (slice(0, 9), slice(9, 12), slice(12, 21), 21,
                       slice(22, 28))
_L = 28  # NHC
_J, _A = 28, 29  # NHI
# b's upper-triangle entries (i, j)
_SI = [0, 0, 0, 1, 1, 2]
_SJ = [0, 1, 2, 1, 2, 2]
# a history row's component groups, for comparisons
GROUPS = {
    "nhc": (_D, _C0, _F, slice(_d, _d + 1), _b, slice(_L, _L + 1)),
    "nhi": (_D, _C0, _F, slice(_d, _d + 1), _b, slice(_J, _J + 1),
            slice(_A, _A + 1)),
}


def _step(material, hist, k, gin, elems: InvElements, out):
    order, want_bias = check_step(hist, k, gin, elems, out,
                                  NCOMP[material], "ds")
    tensors = [hist, gin, elems.bias, elems.ds] + ([out] if want_bias
                                                   else [])
    if not kernels.on_card(*tensors):
        return inv_step_plain(material, hist, k, gin, elems, out)
    c2 = elems.lam if material == "nhc" else elems.kappa
    kernels.launch(
        "inv_%s_step" % material, "sanm_inv_%s_step" % material,
        hist.data_ptr(), gin.data_ptr(), elems.bias.data_ptr(),
        elems.ds.data_ptr(), out.data_ptr() if want_bias else None,
        elems.B, k, order, float(elems.mu), float(c2), int(want_bias),
    )
    return out


def inv_nhc_step(hist, k: int, gin, elems: InvElements, out=None):
    """K1i (NHC): commit order k into ``hist`` (order+1, 29, B) from
    graph input ``gin`` (B, 9); when ``out`` (B, 9) is given, write the
    order-(k+1) bias of sigma into it."""
    return _step("nhc", hist, k, gin, elems, out)


def inv_nhi_step(hist, k: int, gin, elems: InvElements, out=None):
    """K1i (NHI): :func:`inv_nhc_step` for the incompressible stress, on
    histories (order+1, 30, B)."""
    return _step("nhi", hist, k, gin, elems, out)


def _b_terms(hist, m, Fm):
    """b_m (6, B) = sum_t F_t F_{m-t}^T, upper triangle, with F_m =
    ``Fm``."""
    B = Fm.shape[1]

    def F(t):
        return (Fm if t == m else hist[t, _F]).reshape(3, 3, B)

    b = torch.zeros((6, B), dtype=Fm.dtype, device=Fm.device)
    for t in range(m + 1):
        b = b + (F(t)[_SI] * F(m - t)[_SJ]).sum(1)
    return b


def _order_values(material, hist, m, Dm_m, ds, det_ds):
    """The order-m components (by name) from histories 0..m-1 and
    Dm_m = ``Dm_m`` (9, B); see ``csrc/inv_series.cu``."""
    B = Dm_m.shape[1]
    Cm, dm = cofactor_det(hist, m, Dm_m)
    # N = Ds C^T, so that F = N / d
    Nm = torch.einsum("bil,jlb->ijb", ds.reshape(B, 3, 3),
                      Cm.reshape(3, 3, B)).reshape(9, B)
    Fm = quotient(hist, m, Nm, dm)
    v = {"C0": Cm[0:3], "F": Fm, "d": dm, "b": _b_terms(hist, m, Fm)}
    d0 = hist[0, _d] if m > 0 else dm

    def d(t):
        return dm if t == m else hist[t, _d]

    if material == "nhc":
        if m == 0:
            v["L"] = torch.log(dm / det_ds)
        else:  # the log rule on d
            conv = torch.zeros_like(dm)
            for t in range(1, m):
                conv = conv + hist[t, _L] * hist[m - t, _d] * (t / m)
            v["L"] = dm / d0 + (-conv / d0)
        return v
    if m == 0:
        v["J"] = det_ds / dm
        v["A"] = v["J"] ** P_EXP
        return v
    conv = torch.zeros_like(dm)  # J = det Ds / d: the quotient rule
    for t in range(1, m + 1):
        conv = conv + d(t) * hist[m - t, _J]
    Jm = -conv / d0
    J0, A0 = hist[0, _J], hist[0, _A]
    conv = torch.zeros_like(dm)  # A = J^p: the power rule
    for i in range(1, m):
        conv = conv + ((i / m) * (P_EXP + 1.0) - 1.0) * (
            hist[i, _J] * hist[m - i, _A])
    v["J"], v["A"] = Jm, (P_EXP * A0 / J0) * Jm + conv / J0
    return v


_SLOTS = {"C0": _C0, "F": _F, "d": _d, "b": _b, "L": _L, "J": _J, "A": _A}


def _stress(material, get, m, elems: InvElements, det_ds):
    """sigma_m (B, 9) from ``get(name, t)``, the order-t value of a
    component."""
    B = elems.B
    a = "d" if material == "nhc" else "A"
    X = torch.zeros((6, B), dtype=torch.float64, device=elems.device)
    ls = torch.zeros(B, dtype=torch.float64, device=elems.device)
    for t in range(m + 1):
        X = X + get(a, t) * get("b", m - t)
        if material == "nhc":
            ls = ls + get("d", t) * get("L", m - t)
    Xf = torch.empty((B, 3, 3), dtype=torch.float64, device=elems.device)
    Xf[:, _SI, _SJ] = X.T
    Xf[:, _SJ, _SI] = X.T
    eye = torch.eye(3, dtype=torch.float64, device=elems.device)
    if material == "nhc":
        diag = (elems.mu * get("d", m) + elems.lam * ls) / det_ds
        S = (elems.mu / det_ds)[:, None, None] * Xf \
            - diag[:, None, None] * eye
    else:
        kap = elems.kappa
        diag = ((-elems.mu / 3.0) * Xf.diagonal(dim1=1, dim2=2).sum(-1)
                + kap * get("J", m) - (kap if m == 0 else 0.0))
        S = elems.mu * Xf + diag[:, None, None] * eye
    return S.reshape(B, 9)


def inv_step_plain(material, hist, k: int, gin, elems: InvElements,
                   out=None):
    """Plain torch version of K1i (``material`` "nhc" or "nhi"; otherwise
    the arguments of :func:`inv_nhc_step`)."""
    check_step(hist, k, gin, elems, out, NCOMP[material], "ds")
    B = elems.B
    det_ds = batched_det(elems.ds.reshape(B, 3, 3))
    g = gin + elems.bias if k == 0 else gin
    Dk = g.T.contiguous()
    hist[k, _D] = Dk
    for name, v in _order_values(material, hist, k, Dk, elems.ds,
                                 det_ds).items():
        hist[k, _SLOTS[name]] = v
    if out is None:
        return None
    m = k + 1
    v = _order_values(material, hist, m, torch.zeros_like(Dk), elems.ds,
                      det_ds)

    def get(name, t):
        return v[name] if t == m else hist[t, _SLOTS[name]]

    return out.copy_(_stress(material, get, m, elems, det_ds))


def committed_output(material, hist, k: int, elems: InvElements):
    """sigma_k (B, 9) of a committed order k, from the histories (plain
    torch; used to hold the port's commits against another engine's)."""
    det_ds = batched_det(elems.ds.reshape(elems.B, 3, 3))
    return _stress(material, lambda name, t: hist[t, _SLOTS[name]], k,
                   elems, det_ds)


class InvNHCSeries(NHCSeries):
    """:class:`~.nhc_series.NHCSeries` (``start`` / ``step``) with the
    inverse model's NHC step (K1i) and its 29-component histories."""

    ncomp = NCOMP["nhc"]
    step_fn = staticmethod(inv_nhc_step)


class InvNHISeries(NHCSeries):
    """:class:`~.nhc_series.NHCSeries` with the inverse model's NHI step
    (K1i) and its 30-component histories."""

    ncomp = NCOMP["nhi"]
    step_fn = staticmethod(inv_nhi_step)
