"""Field and current boundary conditions.

Counterpart of ``epoch_tpu/core/boundaries.py`` (EPOCH's ``boundary.F90``)
for the boundary codes this slice runs: periodic axes (ghost wrap and the
additive current fold) and the zero-gradient ghosts of CPML boundaries.
Clamp, conduct and reflect boundaries come with a later slice and raise.

Each public function returns new tensors and leaves its inputs untouched.

Stagger table (setup.F90:123-132): ex staggered in x, ey in y, ez in z;
bx in y,z; by in x,z; bz in x,y.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import constants as const
from .state import Fields

# stagger[field][axis] — True when the field is staggered along that axis
STAGGER = {
    "ex": (True, False, False),
    "ey": (False, True, False),
    "ez": (False, False, True),
    "bx": (False, True, True),
    "by": (True, False, True),
    "bz": (True, True, False),
    "jx": (True, False, False),
    "jy": (False, True, False),
    "jz": (False, False, True),
}

# field BCs this slice implements (after sim._normalise_bcs)
SUPPORTED_FIELD_BCS = (const.BC.PERIODIC, const.BC.CPML_LASER,
                       const.BC.CPML_OUTFLOW)


def _sl(ndim, axis, s):
    idx = [slice(None)] * ndim
    idx[axis] = s
    return tuple(idx)


def _periodic_wrap_(field, axis: int, n: int, ng: int):
    """Ghost fill from the opposite side, in place
    (do_field_mpi_with_lengths, boundary.F90:156-192)."""
    nd = field.ndim
    field[_sl(nd, axis, slice(0, ng))] = field[_sl(nd, axis, slice(n, n + ng))]
    field[_sl(nd, axis, slice(n + ng, n + 2 * ng))] = \
        field[_sl(nd, axis, slice(ng, 2 * ng))]


def _zero_gradient_(field, axis: int, n: int, ng: int, staggered: bool,
                    hi: bool):
    """field_zero_gradient (boundary.F90:236-267): mirror ghosts, in place."""
    nd = field.ndim
    if not hi:
        if staggered:
            src = field[_sl(nd, axis, slice(ng, 2 * ng - 1))]
            field[_sl(nd, axis, slice(0, ng - 1))] = torch.flip(src, (axis,))
        else:
            src = field[_sl(nd, axis, slice(ng, 2 * ng))]
            field[_sl(nd, axis, slice(0, ng))] = torch.flip(src, (axis,))
    else:
        centre = n + ng - 1
        if staggered:
            src = field[_sl(nd, axis, slice(centre - ng + 1, centre))]
            field[_sl(nd, axis, slice(centre + 1, centre + ng))] = \
                torch.flip(src, (axis,))
        else:
            src = field[_sl(nd, axis, slice(n, n + ng))]
            field[_sl(nd, axis, slice(n + ng, n + 2 * ng))] = \
                torch.flip(src, (axis,))


def _field_bc_(field, cfg):
    grid = cfg.grid
    for d in range(grid.ndims):
        if cfg.bc_field[2 * d] == const.BC.PERIODIC:
            _periodic_wrap_(field, d, grid.n[d], grid.ng)


def _edge_bcs_(field, name: str, cfg):
    """Zero-gradient ghosts at CPML edges (efield_bcs boundary.F90:487-525,
    bfield_bcs :529-570)."""
    grid = cfg.grid
    for d in range(grid.ndims):
        for hi in (False, True):
            bc = cfg.bc_field[2 * d + (1 if hi else 0)]
            if bc in const.ZERO_GRAD_BCS:
                _zero_gradient_(field, d, grid.n[d], grid.ng,
                                STAGGER[name][d], hi)
            elif bc != const.BC.PERIODIC:
                raise NotImplementedError(
                    f"field boundary {bc.name} is not ported yet "
                    "(a later slice)")


def field_bc(field, cfg):
    """Periodic halo refresh of one field (field_bc, boundary.F90:145)."""
    field = field.clone()
    _field_bc_(field, cfg)
    return field


def _bcs(f: Fields, names, cfg, edges: bool) -> Fields:
    out = {}
    for nm in names:
        arr = getattr(f, nm).clone()
        _field_bc_(arr, cfg)
        if edges:
            _edge_bcs_(arr, nm, cfg)
        out[nm] = arr
    return dataclasses.replace(f, **out)


def efield_bcs(f: Fields, cfg) -> Fields:
    """boundary.F90:487-525."""
    return _bcs(f, ("ex", "ey", "ez"), cfg, edges=True)


def bfield_bcs(f: Fields, cfg, mpi_only: bool) -> Fields:
    """boundary.F90:529-570."""
    return _bcs(f, ("bx", "by", "bz"), cfg, edges=not mpi_only)


def current_summation_bcs(field, cfg):
    """Additive ghost reduction after deposition (processor_summation_bcs
    + particle_periodic_bcs, boundary.F90:372-483): periodic axes fold the
    ghost slabs back into the interior."""
    grid = cfg.grid
    ng = grid.ng
    field = field.clone()
    nd = field.ndim
    for d in range(grid.ndims):
        n = grid.n[d]
        for bd in (2 * d, 2 * d + 1):
            if cfg.bc_particle[bd] not in (const.BC.PERIODIC, const.BC.OPEN):
                raise NotImplementedError(
                    f"particle boundary {cfg.bc_particle[bd].name} is not "
                    "ported yet (a later slice)")
        if cfg.bc_particle[2 * d] == const.BC.PERIODIC:
            hi_ghost = field[_sl(nd, d, slice(n + ng, n + 2 * ng))].clone()
            field[_sl(nd, d, slice(ng, 2 * ng))] += hi_ghost
            lo_ghost = field[_sl(nd, d, slice(0, ng))].clone()
            field[_sl(nd, d, slice(n, n + ng))] += lo_ghost
    return field


def current_bcs(f: Fields, cfg) -> Fields:
    """current_bcs (boundary.F90:802-811)."""
    return dataclasses.replace(
        f, jx=current_summation_bcs(f.jx, cfg),
        jy=current_summation_bcs(f.jy, cfg),
        jz=current_summation_bcs(f.jz, cfg))
