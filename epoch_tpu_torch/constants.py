"""Physical constants and enumeration codes.

The port's own copy of ``epoch_tpu/constants.py`` (the constant tables of
EPOCH's ``epoch2d/src/constants.F90``).  All values are SI (CODATA 2010),
identical to the reference so that both packages agree bit-for-bit in
double precision.
"""
from __future__ import annotations

import enum

# --- physical constants (reference: epoch2d/src/constants.F90:30-54) ---
pi = 3.141592653589793238462643383279503
q0 = 1.602176565e-19          # elementary charge [C]
m0 = 9.10938291e-31           # electron mass [kg]
c = 2.99792458e8              # speed of light [m/s]
kb = 1.3806488e-23            # Boltzmann [J/K]
mu0 = 4.0e-7 * pi             # vacuum permeability
epsilon0 = 1.0 / (mu0 * c * c)   # vacuum permittivity (exact from mu0, c)
ev = q0


class BC(enum.IntEnum):
    """Boundary condition codes (constants.F90:56-71)."""
    NULL = -1
    PERIODIC = 1
    OTHER = 2
    SIMPLE_LASER = 3
    SIMPLE_OUTFLOW = 4
    OPEN = 5
    DUMP = 6
    ZERO_GRADIENT = 7
    CLAMP = 8
    REFLECT = 9
    CONDUCT = 10
    THERMAL = 11
    CPML_LASER = 12
    CPML_OUTFLOW = 13
    MIXED = 14
    HEAT_BATH = 15


# field BC codes that imply a CPML layer
CPML_BCS = (BC.CPML_LASER, BC.CPML_OUTFLOW)
# field BC codes that apply zero-gradient at the boundary
ZERO_GRAD_BCS = (BC.ZERO_GRADIENT, BC.CPML_LASER, BC.CPML_OUTFLOW)


class MaxwellSolver(enum.IntEnum):
    """Maxwell solver ids (constants.F90:125-132)."""
    YEE = 0
    LEHE = 1
    LEHE_X = 2
    LEHE_Y = 3
    LEHE_Z = 4
    COWAN = 5
    PUKHOV = 6
    CUSTOM = 7


class Shape(enum.IntEnum):
    """Particle shape functions (compile-time in EPOCH, runtime here)."""
    TOPHAT = 0
    TRIANGLE = 1   # default (TSC)
    BSPLINE3 = 2


# per-shape support [sf_min, sf_max] and particle ghost cells png
# (constants.F90:474-484)
SHAPE_SUPPORT = {
    Shape.TOPHAT: (0, 1, 2),
    Shape.TRIANGLE: (-1, 1, 3),
    Shape.BSPLINE3: (-2, 2, 4),
}


def ghost_cells(shape: Shape) -> int:
    """ng = png + 2 (constants.F90:491)."""
    return SHAPE_SUPPORT[shape][2] + 2


class IOType(enum.IntFlag):
    """dumpmask bits (subset of constants.F90 io codes)."""
    NEVER = 0
    ALWAYS = 1
    FULL = 2
    RESTART = 4
    AVERAGE = 8
    SNAPSHOT = 16
    SPECIES = 32
    NO_SUM = 64
    SINGLE = 128
    AVERAGE_SINGLE = 256


BD_X_MIN, BD_X_MAX, BD_Y_MIN, BD_Y_MAX, BD_Z_MIN, BD_Z_MAX = range(6)
