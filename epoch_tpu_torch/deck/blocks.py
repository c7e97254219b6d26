"""Typed configuration blocks produced by the deck reader.

Counterpart of ``epoch_tpu/deck/blocks.py``, holding the blocks this slice
of the port runs: control, boundaries, laser, species and output
(``begin:constant`` entries live on the DeckConfig).  Values the reference
keeps as expression stacks are :class:`~.expr.Expression` objects,
evaluated on the host when the run is built.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Optional

from .. import constants as const
from .expr import Expression

BC_NAMES = {
    "periodic": const.BC.PERIODIC,
    "simple_laser": const.BC.SIMPLE_LASER,
    "simple_outflow": const.BC.SIMPLE_OUTFLOW,
    "open": const.BC.OPEN,
    "reflect": const.BC.REFLECT,
    "conduct": const.BC.CONDUCT,
    "thermal": const.BC.THERMAL,
    "cpml_laser": const.BC.CPML_LASER,
    "cpml_outflow": const.BC.CPML_OUTFLOW,
    "heat_bath": const.BC.HEAT_BATH,
    "clamp": const.BC.CLAMP,
    "zero_gradient": const.BC.ZERO_GRADIENT,
}


@dataclass
class ControlBlock:
    """deck_control_block.F90 keys the slice supports."""
    nx: int = 0
    ny: int = 1
    nz: int = 1
    t_end: float = float("inf")
    nsteps: int = -1
    x_min: float = 0.0
    x_max: float = 0.0
    y_min: float = 0.0
    y_max: float = 0.0
    z_min: float = 0.0
    z_max: float = 0.0
    dt_multiplier: float = 0.95          # setup.F90:76
    field_order: int = 2
    maxwell_solver: const.MaxwellSolver = const.MaxwellSolver.YEE
    particle_shape: const.Shape = const.Shape.TRIANGLE
    precision: str = "double"            # 'double' | 'single'
    pusher: str = "auto"                 # 'auto' | 'binned'
    bin_headroom: float = 2.0            # slot capacity / mean ppc
    bin_overflow: str = "drop"


@dataclass
class BoundariesBlock:
    """deck_boundaries_block.f90; defaults from setup.F90:78-81."""
    bc_field: list = dfield(default_factory=lambda: [const.BC.PERIODIC] * 6)
    bc_particle: list = dfield(default_factory=lambda: [const.BC.PERIODIC] * 6)
    cpml_thickness: int = 6
    cpml_kappa_max: float = 20.0
    cpml_a_max: float = 0.15
    cpml_sigma_max: float = 0.7


@dataclass
class SpeciesBlock:
    """deck_species_block.F90 keys the slice supports."""
    name: str = ""
    charge: float = 0.0                  # SI (deck value × q0)
    mass: float = 0.0                    # SI (deck value × m0)
    npart_per_cell: float = -1.0
    density: Optional[Expression] = None
    density_min: float = 0.0
    density_max: float = -1.0            # <0 → unlimited
    temp: list = dfield(default_factory=lambda: [None, None, None])   # K
    drift: list = dfield(default_factory=lambda: [None, None, None])  # kg m/s
    bc_particle: list = dfield(default_factory=lambda: [None] * 6)
    bin_headroom: float = 0.0            # 0 = inherit control.bin_headroom


@dataclass
class LaserBlock:
    """deck_laser_block.f90 + laser.f90:25-47 defaults."""
    boundary: int = const.BD_X_MIN
    amp: float = -1.0
    omega: float = -1.0
    pol_angle: float = 0.0
    phase: Optional[Expression] = None
    t_profile: Optional[Expression] = None
    profile: Optional[Expression] = None
    t_start: float = 0.0
    t_end: float = float("inf")


@dataclass
class OutputBlock:
    """deck_io_block.F90: parsed and kept; the SDF writer that consumes it
    comes with the next slice of the port."""
    name: str = "normal"
    dt_snapshot: float = -1.0
    nstep_snapshot: int = -1
    dump_first: bool = True
    dump_last: bool = True
    variables: dict = dfield(default_factory=dict)   # name → dumpmask bits
