"""State carried between the reference and the port as numpy arrays.

The reference's random streams (``jax.random``, numpy's loader) cannot be
reproduced in PyTorch, so a parity check starts both packages from one
state: the caller extracts the reference ``SimState``'s leaves into a flat
dict of numpy arrays, and ``state_from_numpy`` turns that dict into the
port's ``SimState`` on a device.  ``state_to_numpy`` is its inverse, for
comparisons.  This module never sees the reference itself.

Keys of the dict:

    fields/<ex|ey|ez|bx|by|bz|jx|jy|jz>   padded field planes
    cpml/psi_e, cpml/psi_b                (4, *padded), absent without CPML
    lasers/integral_phase                 (n_lasers,)
    species/<i>/<w|xi|p>                  slot grids (K, nx', ny), ...
    species/<i>/n_dropped                 scalar
    bc_fields/<name>                      boundary rows of the outflow solve
    time, step                            scalars

The reference may pad the slot grid's x axis with empty columns (its
Mosaic stripes need 8-aligned extents); ``state_from_numpy`` drops them,
after checking that they hold no particle.
"""
from __future__ import annotations

import numpy as np
import torch

from .state import (FIELD_NAMES, BinnedSpecies, CPMLState, Fields,
                    LaserState, SimState)


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def state_from_numpy(arrays: dict, cfg, device) -> SimState:
    device = torch.device(device)
    dtype = cfg.dtype
    nx = cfg.grid.n[0]
    fields = Fields(*(_t(arrays[f"fields/{nm}"], dtype, device)
                      for nm in FIELD_NAMES))
    cpml = None
    if "cpml/psi_e" in arrays:
        cpml = CPMLState(psi_e=_t(arrays["cpml/psi_e"], dtype, device),
                         psi_b=_t(arrays["cpml/psi_b"], dtype, device))
    species = []
    for i in range(len(cfg.species)):
        w = np.asarray(arrays[f"species/{i}/w"])
        if np.any(w[:, nx:] != 0):
            raise ValueError(f"species {i}: particles in slot-grid pad "
                             "columns beyond the grid")
        species.append(BinnedSpecies(
            xi=_t(np.asarray(arrays[f"species/{i}/xi"])[:, :, :nx], dtype,
                  device),
            p=_t(np.asarray(arrays[f"species/{i}/p"])[:, :, :nx], dtype,
                 device),
            w=_t(w[:, :nx], dtype, device),
            n_dropped=torch.tensor(int(arrays[f"species/{i}/n_dropped"]),
                                   dtype=torch.int32, device=device)))
    bc_fields = {k.split("/", 1)[1]: _t(v, dtype, device)
                 for k, v in arrays.items() if k.startswith("bc_fields/")}
    return SimState(
        fields=fields, cpml=cpml, species=tuple(species),
        lasers=LaserState(_t(arrays["lasers/integral_phase"], dtype, device)),
        time=float(arrays["time"]), step=int(arrays["step"]),
        bc_fields=bc_fields)


def state_to_numpy(state: SimState) -> dict:
    def n(t):
        return t.detach().cpu().numpy()

    out = {f"fields/{nm}": n(getattr(state.fields, nm))
           for nm in FIELD_NAMES}
    if state.cpml is not None:
        out["cpml/psi_e"] = n(state.cpml.psi_e)
        out["cpml/psi_b"] = n(state.cpml.psi_b)
    for i, b in enumerate(state.species):
        out[f"species/{i}/w"] = n(b.w)
        out[f"species/{i}/xi"] = n(b.xi)
        out[f"species/{i}/p"] = n(b.p)
        out[f"species/{i}/n_dropped"] = int(b.n_dropped)
    for k, v in state.bc_fields.items():
        out[f"bc_fields/{k}"] = n(v)
    out["lasers/integral_phase"] = n(state.lasers.integral_phase)
    out["time"] = state.time
    out["step"] = state.step
    return out
