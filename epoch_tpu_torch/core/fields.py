"""FDTD Maxwell solver: the plain PyTorch version of kernel A.

Counterpart of ``epoch_tpu/core/fields.py`` (EPOCH's ``fields.f90``):
staggered-Yee leapfrog half-updates with field_order 2/4/6 stencils and
the CPML psi recursion.  ``update_e_field``/``update_b_field`` are the plain
versions of the CUDA kernel in ``csrc/field_half.cu``
(``ops/field_kernels.field_half`` calls them for CPU tensors; the CPU
tests and ``chip_smoke.py`` hold the kernel against them).  They keep the
reference's operation order term for term, so the kernel, built without
fused multiply-adds, can reproduce them bit for bit in float32.

Update region: Fortran ``DO ix = 0, nx`` ⇒ python ``[ng-1, n+ng)`` per
axis; ghost cells outside it are refreshed by ``core/boundaries.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants as const
from .config import cpml_psi_coeffs
from .state import CPMLState, Fields

# central-difference coefficient tables (fields.f90:99-124,166-211)
ORDER_COEFFS = {
    2: (1.0,),
    4: (9.0 / 8.0, -1.0 / 24.0),
    6: (75.0 / 64.0, -25.0 / 384.0, 3.0 / 640.0),
}


def shift(f, axis: int, k: int):
    """f evaluated at index i+k along ``axis`` (periodic roll of the padded
    array; the ghost cells cover the stencil reach inside the update
    region)."""
    if k == 0:
        return f
    return torch.roll(f, -k, dims=axis)


def d_minus(f, axis: int, order: int):
    """Backward-staggered derivative Σ_k c_k (f(i+k-1) - f(i-k)) (E half)."""
    out = None
    for k, c in enumerate(ORDER_COEFFS[order], start=1):
        t = c * (shift(f, axis, k - 1) - shift(f, axis, -k))
        out = t if out is None else out + t
    return out


def d_plus(f, axis: int, order: int):
    """Forward-staggered derivative Σ_k c_k (f(i+k) - f(i-k+1)) (B half)."""
    out = None
    for k, c in enumerate(ORDER_COEFFS[order], start=1):
        t = c * (shift(f, axis, k) - shift(f, axis, -(k - 1)))
        out = t if out is None else out + t
    return out


def _axis_profile(vec, axis: int, ndims: int):
    shape = [1] * ndims
    shape[axis] = vec.shape[0]
    return vec.reshape(shape)


def update_region_mask(grid) -> np.ndarray:
    """Boolean mask of the Fortran [0, n] update region."""
    full = np.ones(grid.padded_shape(), bool)
    for d in range(grid.ndims):
        idx = np.arange(grid.padded_shape()[d])
        m = (idx >= grid.ng - 1) & (idx <= grid.n[d] + grid.ng - 1)
        full &= _axis_profile(m, d, grid.ndims)
    return full


def eps_pairs(ndims: int):
    """Levi-Civita pairs (c, d, e, s): (curl F)_c += s · dF_e/dx_d."""
    perm = {(0, 1, 2): 1, (1, 2, 0): 1, (2, 0, 1): 1,
            (0, 2, 1): -1, (2, 1, 0): -1, (1, 0, 2): -1}
    return [(c, d, 3 - c - d, perm[(c, d, 3 - c - d)])
            for d in range(ndims) for c in range(3) if c != d]


class FieldSolverPlan:
    """Scalars and per-axis profiles of the field half-updates, on the
    run's device (``fields.py:92`` in the reference).

    ``profiles[which]`` holds, per axis, the (npad_d,) vectors the kernel
    reads: 1/κ, the psi decay b and the psi gain c, for "e" or "b"."""

    def __init__(self, cfg, device):
        grid = cfg.grid
        nd = grid.ndims
        dtype = cfg.dtype
        self.order = cfg.field_order
        self.ng = grid.ng
        self.n = grid.n
        self.mask = torch.as_tensor(update_region_mask(grid), device=device)
        hdt = 0.5 * cfg.dt
        self.hdt = hdt
        self.fac = hdt / const.epsilon0                     # fields.f90:365
        self.cn = tuple(hdt / grid.delta[d] * const.c ** 2 for d in range(nd))
        self.hdtd = tuple(hdt / grid.delta[d] for d in range(nd))
        self.cpml = cfg.any_cpml
        self.profiles = None
        if self.cpml:
            self.profiles = {}
            for which, ik in (("e", cfg.aux.ikappa_e),
                              ("b", cfg.aux.ikappa_b)):
                vecs = []
                for d in range(nd):
                    b, c = cpml_psi_coeffs(cfg.aux, d, which, hdt,
                                           grid.delta[d])
                    vecs.append(tuple(
                        torch.as_tensor(v, dtype=dtype, device=device)
                        for v in (ik[d], b, c)))
                self.profiles[which] = vecs

    def prof(self, which, d, i):
        """Profile ``i`` (0 = 1/κ, 1 = psi b, 2 = psi c) of axis ``d``,
        shaped to broadcast against the padded field."""
        return _axis_profile(self.profiles[which][d][i], d, len(self.n))


def update_e_field(f: Fields, plan: FieldSolverPlan,
                   cpml: CPMLState | None):
    """E ← E + c²·dt/2·∇×B − dt/2/ε₀·J on the update region, plus the CPML
    psi-E recursion (fields.f90:76-215, boundary.F90:998-1051)."""
    nd = len(plan.n)
    e = [f.ex, f.ey, f.ez]
    b = [f.bx, f.by, f.bz]
    j = [f.jx, f.jy, f.jz]
    de = [-plan.fac * j[c] for c in range(3)]
    for (c, d, eidx, s) in eps_pairs(nd):
        term = plan.cn[d] * d_minus(b[eidx], d, plan.order)
        if plan.cpml:
            term = term * plan.prof("e", d, 0)
        de[c] = de[c] + s * term
    new_e = [torch.where(plan.mask, e[c] + de[c], e[c]) for c in range(3)]
    if plan.cpml and cpml is not None:
        facc = plan.hdt * const.c ** 2
        psi_new = []
        for k, (c, d, eidx, s) in enumerate(eps_pairs(nd)):
            dpair = b[eidx] - shift(b[eidx], d, -1)
            psi = plan.prof("e", d, 1) * cpml.psi_e[k] \
                + plan.prof("e", d, 2) * dpair
            new_e[c] = new_e[c] + s * facc * psi
            psi_new.append(psi)
        cpml = dataclasses.replace(cpml, psi_e=torch.stack(psi_new))
    return dataclasses.replace(f, ex=new_e[0], ey=new_e[1],
                               ez=new_e[2]), cpml


def update_b_field(f: Fields, plan: FieldSolverPlan,
                   cpml: CPMLState | None):
    """B ← B − dt/2·∇×E on the update region, plus the CPML psi-B
    recursion (fields.f90:219-354, boundary.F90:1055-1106)."""
    nd = len(plan.n)
    e = [f.ex, f.ey, f.ez]
    b = [f.bx, f.by, f.bz]
    db = [torch.zeros_like(b[c]) for c in range(3)]
    for (c, d, eidx, s) in eps_pairs(nd):
        term = plan.hdtd[d] * d_plus(e[eidx], d, plan.order)
        if plan.cpml:
            term = term * plan.prof("b", d, 0)
        db[c] = db[c] - s * term
    new_b = [torch.where(plan.mask, b[c] + db[c], b[c]) for c in range(3)]
    if plan.cpml and cpml is not None:
        psi_new = []
        for k, (c, d, eidx, s) in enumerate(eps_pairs(nd)):
            dpair = shift(e[eidx], d, 1) - e[eidx]
            psi = plan.prof("b", d, 1) * cpml.psi_b[k] \
                + plan.prof("b", d, 2) * dpair
            new_b[c] = new_b[c] - s * plan.hdt * psi
            psi_new.append(psi)
        cpml = dataclasses.replace(cpml, psi_b=torch.stack(psi_new))
    return dataclasses.replace(f, bx=new_b[0], by=new_b[1],
                               bz=new_b[2]), cpml
