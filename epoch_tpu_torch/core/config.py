"""Static simulation configuration (counterpart of
``epoch_tpu/core/config.py``).

Everything that stays constant through a run: grid geometry, boundary codes,
species and laser descriptors, the Yee solver and the precomputed CPML
profiles (numpy, host-side; ``core/fields.FieldSolverPlan`` moves them to
the device).
"""
from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Any, Optional

import numpy as np
import torch

from .. import constants as const
from .grid import Grid


@dataclass(frozen=True)
class SpeciesConfig:
    name: str
    charge: float           # SI
    mass: float             # SI
    bc_particle: tuple = ()


@dataclass(frozen=True)
class LaserConfig:
    """Static laser descriptor; profile/phase/time functions are deck
    expressions evaluated on the host (laser.f90, deck_laser_block.f90)."""
    boundary: int
    amp: float
    omega: float
    pol_angle: float
    t_start: float
    t_end: float
    t_profile: Optional[Any] = None
    profile: Optional[Any] = None
    phase: Optional[Any] = None


@dataclass(frozen=True)
class StencilCoeffs:
    """Maxwell solver cross-term coefficients (fields.f90:50-100)."""
    alpha: tuple = (1.0, 1.0, 1.0)
    beta: tuple = ((0.0, 0.0), (0.0, 0.0), (0.0, 0.0))
    delta: tuple = (0.0, 0.0, 0.0)


class FieldAux:
    """Precomputed per-axis CPML profiles (numpy, static)."""

    def __init__(self):
        self.ikappa_e = {}    # axis -> 1/kappa at E-locations (padded,)
        self.ikappa_b = {}
        self.cpml_be = {}     # axis -> (kappa, sigma, a) at E-locations
        self.cpml_bb = {}     # axis -> (kappa, sigma, a) at B-locations


@dataclass(frozen=True)
class SimConfig:
    grid: Grid
    dt: float
    t_end: float
    nsteps: int
    bc_field: tuple
    bc_particle: tuple
    species: tuple           # tuple[SpeciesConfig, ...]
    lasers: tuple            # tuple[LaserConfig, ...]
    field_order: int = 2
    dtype: torch.dtype = torch.float64
    aux: Any = None          # FieldAux or None
    engine: str = "binned"
    bin_k: int = 0           # max slots per cell over species
    bin_k_sp: tuple = ()     # per-species slots per cell
    deck: Any = dfield(default=None, compare=False)

    @property
    def ndims(self) -> int:
        return self.grid.ndims

    @property
    def cpml_active(self):
        return self.grid.cpml_active

    @property
    def any_cpml(self) -> bool:
        return any(self.cpml_active)

    @property
    def fng(self) -> int:
        """Field ghost reach of the Yee stencil (field_order // 2)."""
        return self.field_order // 2

    def needs_outflow_bcs(self, bd: int) -> bool:
        """True when boundary bd runs the Silver-Müller outflow solve
        (bfield_final_bcs, boundary.F90:574-595; cpml_laser rows,
        boundary.F90:896-900)."""
        return self.bc_field[bd] in (const.BC.SIMPLE_LASER,
                                     const.BC.SIMPLE_OUTFLOW,
                                     const.BC.CPML_LASER)


def solver_coefficients(solver, grid: Grid, dt: float) -> StencilCoeffs:
    """Yee coefficients (fields.f90:50-88).  The dispersion-improved
    solvers (Lehe, Pukhov, Cowan, custom: ``d_plus_enhanced``) come with a
    later slice."""
    if solver != const.MaxwellSolver.YEE:
        raise NotImplementedError(
            f"maxwell_solver {solver.name} is not ported yet (a later slice; "
            "this slice runs the Yee solver)")
    return StencilCoeffs()


def cfl_limit(field_order: int) -> float:
    """fields.f90:38-45."""
    if field_order == 2:
        return 1.0
    if field_order == 4:
        return 6.0 / 7.0
    return 120.0 / 149.0


def build_cpml_profiles(grid: Grid, bc_field, kappa_max, a_max, sigma_max
                        ) -> FieldAux:
    """CPML grading profiles (boundary.F90:815-966, Roden & Gedney).

    kappa/sigma/a use m=3, ma=1 polynomial grading over the cpml_thickness
    cells adjacent to each CPML boundary; E-locations sample integer cells,
    B-locations the half-shifted ones."""
    aux = FieldAux()
    ng = grid.ng
    thick = grid.cpml_thickness
    m, ma = 3, 1
    for d in range(grid.ndims):
        n = grid.n[d]
        npad = n + 2 * ng
        dxd = grid.delta[d]
        kappa_e = np.ones(npad)
        kappa_b = np.ones(npad)
        sigma_e = np.zeros(npad)
        sigma_b = np.zeros(npad)
        a_e = np.zeros(npad)
        a_b = np.zeros(npad)
        sigma_maxval = sigma_max * const.c * 0.8 * (m + 1.0) / dxd

        def grade(pos):  # pos in [0,1]: 1 at outer edge -> 0 at inner edge
            xm = pos ** m
            return (1.0 + (kappa_max - 1.0) * xm,
                    sigma_maxval * xm,
                    a_max * (1.0 - pos) ** ma)

        if bc_field[2 * d] in const.CPML_BCS and thick > 0:
            for f in range(1, thick + 1):       # Fortran cell index 1..thick
                p = f + ng - 1
                kappa_e[p], sigma_e[p], a_e[p] = grade(1.0 - (f - 1) / thick)
                kappa_b[p], sigma_b[p], a_b[p] = grade(
                    1.0 - (f - 0.5) / thick)
        if bc_field[2 * d + 1] in const.CPML_BCS and thick > 0:
            for f in range(n - thick + 1, n + 1):   # Fortran n-thick+1..n
                p = f + ng - 1
                gi = n - f + 1                       # runs thick..1
                kappa_e[p], sigma_e[p], a_e[p] = grade(1.0 - (gi - 1) / thick)
                # B-profile stored at ix-1 (boundary.F90:949-951)
                kappa_b[p - 1], sigma_b[p - 1], a_b[p - 1] = grade(
                    1.0 - (gi - 0.5) / thick)
        aux.ikappa_e[d] = 1.0 / kappa_e
        aux.ikappa_b[d] = 1.0 / kappa_b
        aux.cpml_be[d] = (kappa_e, sigma_e, a_e)
        aux.cpml_bb[d] = (kappa_b, sigma_b, a_b)
    return aux


def cpml_psi_coeffs(aux: FieldAux, d: int, which: str, tstep: float,
                    dxd: float):
    """b/c coefficient arrays for the psi recursion at timestep ``tstep``
    (boundary.F90:998-1106)."""
    kappa, sigma, a = (aux.cpml_be if which == "e" else aux.cpml_bb)[d]
    b = np.exp(-(sigma / kappa + a) * tstep)
    denom = (sigma + kappa * a) * dxd
    cc = np.where(denom != 0.0,
                  (b - 1.0) * sigma / kappa
                  / np.where(denom == 0.0, 1.0, denom),
                  0.0)
    return b, cc
