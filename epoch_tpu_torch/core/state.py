"""Simulation state as dataclasses of tensors.

Counterpart of ``epoch_tpu/core/state.py``: where the reference keeps one
immutable pytree of ``NamedTuple``s, the port keeps plain dataclasses of
tensors on one device.  Step functions return new dataclasses
(``dataclasses.replace``) and never write into a tensor they were given,
so a caller may hold a state across a step.  Time and step count are
Python numbers on the host: the run loop reads them every step, and
keeping them off the device saves a synchronising copy per read.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass
class Fields:
    """E, B and current J on the staggered grid (shared_data.F90:436-451),
    each of the padded shape (n + 2·ng per axis)."""
    ex: torch.Tensor
    ey: torch.Tensor
    ez: torch.Tensor
    bx: torch.Tensor
    by: torch.Tensor
    bz: torch.Tensor
    jx: torch.Tensor
    jy: torch.Tensor
    jz: torch.Tensor


FIELD_NAMES = ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz")


@dataclass
class CPMLState:
    """CPML convolution memory (shared_data.F90:419-428): one psi stack per
    half, (n_pairs, *padded) each — the reference's ``psi=(psi_e, psi_b)``."""
    psi_e: torch.Tensor
    psi_b: torch.Tensor


@dataclass
class LaserState:
    """Per-laser state (laser_block, shared_data.F90:688-707)."""
    integral_phase: torch.Tensor    # (n_lasers,) current_integral_phase


@dataclass
class BinnedSpecies:
    """One species on the slot grid (``epoch_tpu/core/binned.py:47``).

    Slot-major layout with the grid axes minor: w (K, nx, ny) — 0 marks an
    empty slot —, xi (2, K, nx, ny) the position within the own cell in
    cell units, p (3, K, nx, ny) the momentum.  ``n_dropped`` is an int32
    device scalar counting particles lost to slot overflow."""
    xi: torch.Tensor
    p: torch.Tensor
    w: torch.Tensor
    n_dropped: torch.Tensor

    @property
    def K(self) -> int:
        return self.w.shape[0]


@dataclass
class SimState:
    fields: Fields
    cpml: CPMLState | None
    species: tuple                  # tuple[BinnedSpecies, ...]
    lasers: LaserState
    time: float
    step: int
    # boundary field rows for the Silver-Müller outflow solve
    # (setup.F90:361-388), keyed like the reference ("ey_x_min", ...)
    bc_fields: dict = field(default_factory=dict)


def zero_fields(padded_shape, dtype, device) -> Fields:
    return Fields(*(torch.zeros(padded_shape, dtype=dtype, device=device)
                    for _ in FIELD_NAMES))
