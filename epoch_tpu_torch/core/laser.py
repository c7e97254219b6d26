"""Laser boundary sources and the Silver-Müller outflow solve.

Counterpart of ``epoch_tpu/core/laser.py`` (EPOCH's ``laser.f90``): a laser
attached to a boundary is injected through the outflow characteristic
solve on the tangential B rows just outside the domain.

The reference evaluates the deck expressions inside ``jit``; the port runs
eagerly, so ``LaserPlan`` evaluates them on the host with numpy: a
transverse profile that does not depend on time once, onto the device, and
the time envelope and phase per step as Python floats.  Only a profile
that varies in time is re-evaluated and copied each step.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import constants as const
from .loader import add_geom_ctx
from .state import Fields


def _transverse_coords(grid, axis):
    """Transverse cell-centre coordinates of a boundary row, padded."""
    names = ["x", "y", "z"]
    tdims = [d for d in range(grid.ndims) if d != axis]
    cs = [grid.centres(d, ghosts=True) for d in tdims]
    if len(cs) == 1:
        return {names[tdims[0]]: cs[0]}
    X, Y = np.meshgrid(cs[0], cs[1], indexing="ij")
    return {names[tdims[0]]: X, names[tdims[1]]: Y}


class LaserPlan:
    """The lasers of one boundary, with their static profiles on the
    device (laser.f90:outflow_bcs_* source loop)."""

    def __init__(self, cfg, bd, device):
        self.cfg = cfg
        self.bd = bd
        self.dtype = cfg.dtype
        self.device = device
        axis = bd // 2
        self.ctx = _transverse_coords(cfg.grid, axis)
        add_geom_ctx(self.ctx, cfg.grid)
        self.lasers = [las for las in cfg.lasers if las.boundary == bd]
        self.profiles = []
        for las in self.lasers:
            prof = None
            if las.profile is not None and not las.profile.time_varying:
                prof = self._tensor(las.profile(self.ctx))
            self.profiles.append(prof)

    def _tensor(self, val):
        shape = next(iter(self.ctx.values())).shape
        return torch.as_tensor(np.broadcast_to(np.asarray(val, float),
                                               shape).copy(),
                               dtype=self.dtype, device=self.device)

    def _value(self, expr, ctx):
        """A Python float where the expression is a scalar, else a tensor."""
        val = expr(ctx)
        if np.ndim(val) == 0:
            return float(val)
        return self._tensor(val)

    def sources(self, time: float):
        """Σ over lasers of amp·t_profile·profile·sin(ω·t + phase), split
        into the two polarisation components (the reference's
        ``laser_sources``, laser.py:35)."""
        source1 = 0.0
        source2 = 0.0
        # add_laser gating (boundary.F90:41-49): only laser-type BCs inject
        if self.cfg.bc_field[self.bd] not in (const.BC.SIMPLE_LASER,
                                              const.BC.CPML_LASER):
            return source1, source2
        ctx = dict(self.ctx)
        ctx["time"] = time
        for las, prof in zip(self.lasers, self.profiles):
            if not (las.t_start <= time <= las.t_end):
                continue
            t_env = las.amp
            if las.t_profile is not None:
                t_env = t_env * self._value(las.t_profile, ctx)
            profile = 1.0
            if prof is not None:
                profile = prof
            elif las.profile is not None:
                profile = self._value(las.profile, ctx)
            phase = 0.0
            if las.phase is not None:
                phase = self._value(las.phase, ctx)
            arg = las.omega * time + phase
            sin = math.sin(arg) if isinstance(arg, float) else torch.sin(arg)
            base = t_env * profile * sin
            source1 = source1 + base * math.cos(las.pol_angle)
            source2 = source2 + base * math.sin(las.pol_angle)
        return source1, source2


def _row(ndim, axis, idx):
    sl = [slice(None)] * ndim
    sl[axis] = idx
    return tuple(sl)


def outflow_bcs(f: Fields, cfg, bc_fields, laser_plan, dt, time, axis,
                hi: bool) -> Fields:
    """outflow_bcs_{x,y}_{min,max} (laser.f90:325-485 and the 2D
    transverse-derivative terms): solves the incoming characteristic for
    the two tangential B rows just outside the domain, with the laser
    source terms.  ``dt`` is explicit because the start-up call uses dt/2
    (epoch1d.F90:154-158).  See ``epoch_tpu/core/laser.py:89`` for the
    update written out."""
    grid = cfg.grid
    nd = grid.ndims
    ng = grid.ng
    bc = cfg.bc_field[2 * axis + (1 if hi else 0)]
    if bc == const.BC.CPML_LASER:
        # boundary.F90:896-900, 960-965 (single domain)
        lp_f = (grid.n[axis] - grid.cpml_thickness - cfg.fng + 1) if hi \
            else (grid.cpml_thickness + cfg.fng)
    else:
        lp_f = grid.n[axis] if hi else 1
    lp = lp_f + ng - 1      # python index of the boundary row
    dtc2 = dt * const.c ** 2
    l_ax = dtc2 / grid.delta[axis]
    s = 1.0 / (l_ax + const.c)
    diff = l_ax - const.c
    dt_eps = dt / const.epsilon0
    src1, src2 = laser_plan.sources(time)

    key = f"{'xyz'[axis]}_{'max' if hi else 'min'}"
    t1, t2 = (axis + 1) % 3, (axis + 2) % 3
    e = [f.ex, f.ey, f.ez]
    b = [f.bx, f.by, f.bz]
    j = [f.jx, f.jy, f.jz]
    bn = ["bx", "by", "bz"]
    en = ["ex", "ey", "ez"]
    ndim = f.ex.ndim

    def row(arr, idx):
        return arr[_row(ndim, axis, idx)]

    def dtrans(arr, t, idx):
        """Backward difference of arr's boundary row along transverse axis
        t, scaled by dt·c²/δ_t; zero when the axis does not exist."""
        if t >= nd:
            return 0.0
        r = row(arr, idx)
        tt = t if t < axis else t - 1
        return (dtc2 / grid.delta[t]) * (r - torch.roll(r, 1, dims=tt))

    sgn = -1.0 if hi else 1.0
    out = lp + 1 if hi else lp - 1          # row written outside the domain
    dref = lp - 1 if hi else lp             # row feeding the diff term
    bt2_new = s * (sgn * 4.0 * src1
                   + 2.0 * sgn * bc_fields[f"{en[t1]}_{key}"]
                   + 2.0 * const.c * bc_fields[f"{bn[t2]}_{key}"]
                   - sgn * 2.0 * row(e[t1], lp)
                   - sgn * dtrans(b[axis], t2, lp)
                   + sgn * dt_eps * row(j[t1], lp)
                   + diff * row(b[t2], dref))
    bt1_new = s * (-sgn * 4.0 * src2
                   - 2.0 * sgn * bc_fields[f"{en[t2]}_{key}"]
                   + 2.0 * const.c * bc_fields[f"{bn[t1]}_{key}"]
                   + sgn * 2.0 * row(e[t2], lp)
                   - sgn * dtrans(b[axis], t1, lp)
                   - sgn * dt_eps * row(j[t2], lp)
                   + diff * row(b[t1], dref))
    wrow = lp if hi else lp - 1             # written tangential-B row
    b_axis = b[axis].clone()
    b_axis[_row(ndim, axis, out)] = bc_fields[f"{bn[axis]}_{key}"]
    b_t2 = b[t2].clone()
    b_t2[_row(ndim, axis, wrow)] = bt2_new
    b_t1 = b[t1].clone()
    b_t1[_row(ndim, axis, wrow)] = bt1_new
    return dataclasses.replace(f, **{bn[axis]: b_axis, bn[t2]: b_t2,
                                     bn[t1]: b_t1})


def update_laser_phases(cfg, phases, time, dt):
    """update_laser_omegas (laser.f90:215-250).  Every laser of this slice
    has a constant ω, whose phase is ω·time directly; time-varying ω comes
    with a later slice, so the accumulated phases stay as they are."""
    return phases
