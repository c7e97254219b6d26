"""Initial particle loading (auto_load) on the host.

Counterpart of ``epoch_tpu/core/loader.py`` (EPOCH's
``helper.F90:95-650`` and ``particle_temperature.F90``):

* per-cell placement: ``npart_per_cell`` particles uniformly in every cell
  of positive density, the fractional remainder scattered at random;
* weights from the shape-interpolated density:
  ``w = density(x_p) · cell_volume / npart_in_cell`` (helper.F90:651-760);
* momenta per axis from N(drift, √(kB·T·m)) (particle_temperature.F90:380-390).

Random numbers come from an explicit ``torch.Generator`` (the reference
draws from numpy's; the streams differ, the statistics match).  Deck
expressions are evaluated with numpy; the result is a dict of float64 CPU
tensors that ``core/binned.bin_from_arrays`` places on the slot grid.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as const

FAC_1D_TRIANGLE = 0.5      # shape-function normalisation (shapes.py:22)


def add_geom_ctx(ctx, grid, time=0.0):
    """Grid geometry variables of the deck language."""
    for d in range(grid.ndims):
        nm = "xyz"[d]
        ctx.setdefault(f"{nm}_min", grid.lo[d])
        ctx.setdefault(f"{nm}_max", grid.hi[d])
        ctx.setdefault(f"d{nm}", grid.delta[d])
        ctx.setdefault(f"length_{nm}", grid.hi[d] - grid.lo[d])
        ctx.setdefault(f"length{nm}", grid.hi[d] - grid.lo[d])
        ctx.setdefault(f"n{nm}", float(grid.n[d]))
    ctx.setdefault("time", time)


def eval_on_grid(expr, grid):
    """Evaluate a deck expression on the cell centres (no ghosts)."""
    if expr is None:
        return np.zeros(grid.n)
    ctx = {}
    mesh = np.meshgrid(*[grid.centres(d) for d in range(grid.ndims)],
                       indexing="ij")
    for d in range(grid.ndims):
        ctx["xyz"[d]] = mesh[d]
    add_geom_ctx(ctx, grid)
    return np.broadcast_to(np.asarray(expr(ctx), float), grid.n).copy()


def eval_at_points(expr, pts, grid, default=0.0):
    """Evaluate a deck expression at particle positions (N, ndims)."""
    if expr is None:
        return np.full(pts.shape[0], default)
    ctx = {"xyz"[d]: pts[:, d] for d in range(grid.ndims)}
    add_geom_ctx(ctx, grid)
    return np.broadcast_to(np.asarray(expr(ctx), float),
                           (pts.shape[0],)).copy()


def species_density(sp_block, grid):
    """The species' number density on the grid (deck_species_block)."""
    return eval_on_grid(sp_block.density, grid)


def sample_maxwellian(gen, mass, temp, drift):
    """p ~ N(drift, √(kB·T·m)) per particle (particle_temperature.F90:380-390)."""
    std = np.sqrt(np.maximum(temp, 0.0) * const.kb * mass)
    z = torch.randn(np.shape(temp), generator=gen, dtype=torch.float64)
    return drift + std * z.numpy()


def _interp_density(density, pos, grid):
    """Triangle-shape interpolated density at the particle positions, with
    normalised weights (gxfac.inc) and periodic wrap of the cell index."""
    nd = grid.ndims
    out = np.zeros(pos.shape[0])
    cells, ws = [], []
    for d in range(nd):
        r = (pos[:, d] - grid.grid_min(d)) / grid.delta[d]
        c = np.floor(r + 0.5)
        cf = c - r
        cf2 = cf * cf
        w = np.stack([0.25 + cf2 + cf, 1.5 - 2.0 * cf2, 0.25 + cf2 - cf],
                     axis=1) * FAC_1D_TRIANGLE
        cells.append(c.astype(int))
        ws.append(w)
    offs = (-1, 0, 1)
    for i in range(3):
        for j in range(3):
            idx = (np.mod(cells[0] + offs[i], grid.n[0]),
                   np.mod(cells[1] + offs[j], grid.n[1]))
            out += ws[0][:, i] * ws[1][:, j] * density[idx]
    return out


def load_species(sp_block, grid, gen: torch.Generator):
    """auto_load for one species → {x (N, 2), p (N, 3), weight (N,)} as
    float64 CPU tensors, or None when the species loads no particle."""
    nd = grid.ndims
    density = species_density(sp_block, grid)
    if sp_block.density_max > 0:
        density = np.minimum(density, sp_block.density_max)
    # zero-density cells are not loaded (helper.F90:497-530)
    valid = (density >= max(sp_block.density_min, 0.0)) & (density > 0.0)
    density = np.where(valid, density, 0.0)
    n_valid = int(valid.sum())
    npc = max(sp_block.npart_per_cell, 0.0)
    total = int(math.floor(npc * n_valid))
    if total == 0:
        return None

    valid_idx = np.argwhere(valid)          # (n_valid, nd)
    npc_int = int(math.floor(npc))
    cells = np.repeat(valid_idx, npc_int, axis=0)
    n_left = total - cells.shape[0]
    if n_left > 0:
        pick = torch.randint(0, n_valid, (n_left,), generator=gen).numpy()
        cells = np.concatenate([cells, valid_idx[pick]], axis=0)

    # uniform position inside each cell (helper.F90:516)
    u = torch.rand((nd, total), generator=gen, dtype=torch.float64).numpy()
    pos = np.empty((total, nd))
    for d in range(nd):
        centres = grid.grid_min(d) + cells[:, d] * grid.delta[d]
        pos[:, d] = centres + (u[d] - 0.5) * grid.delta[d]

    dens_at = _interp_density(density, pos, grid)
    counts = np.zeros(grid.n, dtype=np.int64)
    np.add.at(counts, tuple(cells[:, d] for d in range(nd)), 1)
    cnt_at = counts[tuple(cells[:, d] for d in range(nd))]
    weight = dens_at * grid.cell_volume / np.maximum(cnt_at, 1)

    p = np.zeros((total, 3))
    for i in range(3):
        temp = eval_at_points(sp_block.temp[i], pos, grid)
        drift = eval_at_points(sp_block.drift[i], pos, grid)
        p[:, i] = sample_maxwellian(gen, sp_block.mass, temp, drift)
    return {"x": torch.from_numpy(pos), "p": torch.from_numpy(p),
            "weight": torch.from_numpy(weight)}
