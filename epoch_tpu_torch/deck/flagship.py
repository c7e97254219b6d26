"""The flagship 2D LWFA deck in its static-box phase.

The port's own copy of the laser-wakefield deck that ``bench.py`` times
(``DECK_LWFA``, bench.py:33-93) without its ``begin:window`` block: the
laser-driven static box the flagship runs until its window starts.  A
``cpml_laser`` boundary at x_min injects a gaussian pulse, ``cpml_outflow``
absorbs at x_max, y is periodic; electrons and protons fill x > lx/4.
Cells are 50 nm (20 per laser wavelength); 372 user cells per axis make
384 with the 6-cell CPML on each side.
"""

CELL = 5.0e-8        # m; 20 cells per laser wavelength

_TEMPLATE = """
begin:control
  precision = {precision}
  bin_headroom = 2.0
  nx = {nx}
  ny = {ny}
  t_end = 1.0
  x_min = 0
  x_max = {lx}
  y_min = 0
  y_max = {ly}
end:control
begin:boundaries
  bc_x_min = cpml_laser
  bc_x_max = cpml_outflow
  bc_y_min = periodic
  bc_y_max = periodic
end:boundaries
begin:constant
  lambda0 = 1.0e-6
  omega0 = 2.0 * pi * c / lambda0
  w0 = {w0}
  den = 1.0e24
end:constant
begin:laser
  boundary = x_min
  amp = 3.0e12
  omega = omega0
  t_profile = gauss(time, 40e-15, 20e-15)
  profile = gauss(y, {yc}, w0)
end:laser
begin:species
  name = electron
  charge = -1
  mass = 1.0
  number_density = if(x gt {x0}, den, 0)
  nparticles_per_cell = {ppc}
  temperature_ev = 10
end:species
begin:species
  name = proton
  charge = 1
  mass = 1836.2
  number_density = if(x gt {x0}, den, 0)
  nparticles_per_cell = {ppc}
  temperature_ev = 1
end:species
begin:output
  dt_snapshot = 1
end:output
"""


def lwfa_static_deck(nx=372, ny=372, ppc=8, precision="single") -> str:
    """Deck text at the given size; the defaults are the flagship's."""
    lx, ly = nx * CELL, ny * CELL
    return _TEMPLATE.format(nx=nx, ny=ny, ppc=ppc, precision=precision,
                            lx=lx, ly=ly, yc=0.5 * ly, w0=0.25 * ly,
                            x0=0.25 * lx)
