"""Grid geometry (counterpart of ``epoch_tpu/core/grid.py``).

Dimension-generic staggered Yee grid.  Conventions follow
``epoch1d/src/housekeeping/setup.F90:setup_grid``:

* the user domain is ``[x_min, x_max]`` split into ``nx_user`` cells;
* if *any* boundary is CPML, every axis is extended by ``cpml_thickness``
  cells on both ends (``mpi_routines.F90:184-192``), so
  ``nx = nx_user + 2*cpml_thickness``; absorption profiles only exist on
  sides whose field BC is CPML;
* cell centres sit at ``x(i) = x_grid_min + (i-1)*dx`` (1-based, Fortran)
  with ``x_grid_min = x_min - cpml_thickness*dx + dx/2`` (setup.F90:164-171);
* arrays carry ``ng`` ghost cells per side (``ng = png + 2``,
  constants.F90:491).

Python arrays are 0-based: Fortran index ``f`` ↔ python ``f + ng - 1``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import constants as const


@dataclass(frozen=True)
class Grid:
    ndims: int
    shape_fn: const.Shape
    # cells per axis including CPML extension cells (no ghosts)
    n: tuple
    # CPML extension cells (same on every axis end; 0 when no CPML anywhere)
    cpml_thickness: int
    # which boundaries carry CPML absorption profiles, indexed like bc_field
    cpml_active: tuple
    # user-domain edges per axis
    lo: tuple
    hi: tuple

    @property
    def ng(self) -> int:
        return const.ghost_cells(self.shape_fn)

    @property
    def delta(self) -> tuple:
        """dx per axis (set by the *user* cell count: setup.F90:164)."""
        return tuple(
            (self.hi[d] - self.lo[d]) / (self.n[d] - 2 * self.cpml_thickness)
            for d in range(self.ndims))

    @property
    def cell_volume(self) -> float:
        v = 1.0
        for d in self.delta:
            v *= d
        return v

    def grid_min(self, d: int) -> float:
        """Centre of the first (CPML-extended) cell: setup.F90:165-171."""
        dx = self.delta[d]
        return self.lo[d] - dx * self.cpml_thickness + 0.5 * dx

    def padded_shape(self) -> tuple:
        ng = self.ng
        return tuple(n + 2 * ng for n in self.n)

    def centres(self, d: int, ghosts: bool = False) -> np.ndarray:
        """Cell-centre coordinates along axis ``d``."""
        ng = self.ng if ghosts else 0
        i = np.arange(-ng, self.n[d] + ng)
        return self.grid_min(d) + i * self.delta[d]


def make_grid(control, boundaries) -> Grid:
    """Build the Grid from parsed control + boundaries blocks."""
    if control.nz > 1:
        ndims = 3
    elif control.ny > 1:
        ndims = 2
    else:
        ndims = 1
    n_user = (control.nx, control.ny, control.nz)
    lo_all = (control.x_min, control.y_min, control.z_min)
    hi_all = (control.x_max, control.y_max, control.z_max)
    cpml_active = tuple(
        bc in const.CPML_BCS for bc in boundaries.bc_field[:2 * ndims])
    thick = boundaries.cpml_thickness if any(cpml_active) else 0
    return Grid(
        ndims=ndims,
        shape_fn=control.particle_shape,
        n=tuple(n_user[d] + 2 * thick for d in range(ndims)),
        cpml_thickness=thick,
        cpml_active=cpml_active,
        lo=tuple(lo_all[:ndims]),
        hi=tuple(hi_all[:ndims]),
    )
