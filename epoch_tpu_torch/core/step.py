"""Timestep orchestration (counterpart of ``epoch_tpu/core/step.py``).

The leapfrog follows the reference main loop (``epoch1d.F90:184-249``):

    step_a: fields_half  (E+dt/2, E bcs, B+dt/2, B halo)
            push_all     (binned push + deposit per species, J bcs)
            current_finish, step += 1, time += dt/2   [mid-step output point]
    step_b: time += dt/2
            fields_final (B+dt/2, laser/outflow B bcs, E+dt/2, E bcs)

The field half-updates go through kernel A (``ops.field_kernels``), four
calls a step; the particles through kernel B (``ops.binned_kernels``), one
call per species a step.  Field and current boundary conditions and the
laser rows are plain PyTorch.  Nothing is jitted: the port runs eagerly,
and the step functions take and return ``SimState`` dataclasses.
"""
from __future__ import annotations

import dataclasses

from . import binned as binmod
from . import boundaries as bnd
from . import fields as fld
from . import laser as las
from ..ops.binned_kernels import binned_push
from ..ops.field_kernels import field_half


def make_step_functions(cfg, device):
    """Build the step halves for a config, on ``device``."""
    plan = fld.FieldSolverPlan(cfg, device)
    bplan = binmod.BinnedPlan(cfg)
    dt = cfg.dt
    grid = cfg.grid
    laser_plans = {bd: las.LaserPlan(cfg, bd, device)
                   for bd in range(2 * cfg.ndims)
                   if cfg.needs_outflow_bcs(bd)}

    def fields_half(state):
        f, cpml = field_half("e", state.fields, plan, state.cpml)
        f = bnd.efield_bcs(f, cfg)
        f, cpml = field_half("b", f, plan, cpml)
        f = bnd.bfield_bcs(f, cfg, mpi_only=True)
        return dataclasses.replace(state, fields=f, cpml=cpml)

    def bfield_final_bcs(state, dt_eff, time):
        """boundary.F90:574-595 + the laser/outflow rows."""
        phases = las.update_laser_phases(cfg, state.lasers.integral_phase,
                                         time, dt_eff)
        f = bnd.bfield_bcs(state.fields, cfg, mpi_only=False)
        for bd, lp in laser_plans.items():
            f = las.outflow_bcs(f, cfg, state.bc_fields, lp, dt_eff, time,
                                bd // 2, bd % 2 == 1)
        f = bnd.bfield_bcs(f, cfg, mpi_only=True)
        return dataclasses.replace(
            state, fields=f,
            lasers=dataclasses.replace(state.lasers, integral_phase=phases))

    def fields_final(state):
        f, cpml = field_half("b", state.fields, plan, state.cpml)
        state = dataclasses.replace(state, fields=f, cpml=cpml)
        state = bfield_final_bcs(state, dt, state.time)
        f, cpml = field_half("e", state.fields, plan, state.cpml)
        f = bnd.efield_bcs(f, cfg)
        return dataclasses.replace(state, fields=f, cpml=cpml)

    def push_all(state):
        """Every species through kernel B; their deposits summed into J,
        then the periodic current summation (step.py:270-492)."""
        fpad = binmod.make_fpad(state.fields, grid)
        jpad_sum = None
        new_species = []
        for sp, b in zip(cfg.species, state.species):
            b, jpad = binned_push(fpad, b, sp, bplan, sp.bc_particle[:4])
            jpad_sum = jpad if jpad_sum is None else jpad_sum + jpad
            new_species.append(b)
        jfull = binmod.jpad_to_padded(jpad_sum, grid)
        f = dataclasses.replace(state.fields, jx=jfull[0], jy=jfull[1],
                                jz=jfull[2])
        return dataclasses.replace(state, fields=bnd.current_bcs(f, cfg),
                                   species=tuple(new_species))

    def current_finish(state):
        """current_smooth.F90:29-45 without smoothing: the J halo refresh."""
        f = state.fields
        return dataclasses.replace(state, fields=dataclasses.replace(
            f, jx=bnd.field_bc(f.jx, cfg), jy=bnd.field_bc(f.jy, cfg),
            jz=bnd.field_bc(f.jz, cfg)))

    def step_a(state):
        state = current_finish(push_all(fields_half(state)))
        return dataclasses.replace(state, step=state.step + 1,
                                   time=state.time + 0.5 * dt)

    def step_b(state):
        state = dataclasses.replace(state, time=state.time + 0.5 * dt)
        return fields_final(state)

    def init_b_boundaries(state):
        """The dt/2 bfield_final_bcs trick at start-up (epoch1d.F90:153-159)."""
        state = dataclasses.replace(state, time=state.time + 0.5 * dt)
        return bfield_final_bcs(state, 0.5 * dt, state.time)

    return {"step_a": step_a, "step_b": step_b,
            "init_b_boundaries": init_b_boundaries,
            "fields_half": fields_half, "fields_final": fields_final,
            "push_all": push_all, "current_finish": current_finish}
