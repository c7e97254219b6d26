"""Simulation assembly and run loop (counterpart of ``epoch_tpu/core/sim.py``).

The init sequence of ``epoch1d.F90:16-182``: deck → grid → particle load →
dt → boundary-field saves → E boundary conditions → the half-dt laser
start-up → main loop.  This slice runs 2D decks on the binned engine with
periodic and CPML boundaries; other options raise in the deck reader or
here.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import constants as const
from ..deck.deck import DeckConfig, load_deck
from . import boundaries as bnd
from . import loader
from . import step as step_mod
from .binned import bin_from_arrays
from .config import (LaserConfig, SimConfig, SpeciesConfig, build_cpml_profiles,
                     cfl_limit, solver_coefficients)
from .grid import Grid, make_grid
from .state import CPMLState, LaserState, SimState, zero_fields


def _normalise_bcs(deck: DeckConfig):
    """boundary.F90:30-139 BC normalisation: laser/outflow/CPML particle
    boundaries become OPEN (sim.py:29-54 in the reference)."""
    b = deck.boundaries
    for i, bc in enumerate(b.bc_field):
        if bc in (const.BC.OTHER, const.BC.REFLECT):
            b.bc_field[i] = const.BC.CLAMP
        elif bc == const.BC.OPEN:
            b.bc_field[i] = const.BC.SIMPLE_OUTFLOW
    absorbing = (const.BC.SIMPLE_LASER, const.BC.SIMPLE_OUTFLOW,
                 const.BC.CPML_LASER, const.BC.CPML_OUTFLOW)
    for bcs in [sp.bc_particle for sp in deck.species] + [b.bc_particle]:
        for i, bc in enumerate(bcs):
            if bc in (const.BC.OTHER, const.BC.CONDUCT):
                bcs[i] = const.BC.REFLECT
            elif bc in absorbing:
                bcs[i] = const.BC.OPEN


def compute_dt(deck: DeckConfig, grid: Grid) -> float:
    """set_dt (setup.F90:637-720) for the Yee solver, the laser Nyquist
    limit (laser.f90:283-310) and the plasma-frequency limit."""
    d = grid.delta
    dt_courant = 1.0 / (const.c * math.sqrt(sum(1.0 / dd ** 2 for dd in d)))
    dt = cfl_limit(deck.control.field_order) * dt_courant
    if any(bc in (const.BC.SIMPLE_LASER, const.BC.SIMPLE_OUTFLOW)
           for bc in deck.boundaries.bc_field[:2 * grid.ndims]):
        dt = min(dt, dt_courant)
    for las in deck.lasers:
        if las.omega > 0:
            dt = min(dt, 2.0 * math.pi / las.omega / 2.0)
    # plasma frequency limit (Bohm-Gross)
    dt_pf = math.inf
    k_max = 2.0 * math.pi / min(d)
    for sp in deck.species:
        if sp.mass <= 0 or sp.density is None:
            continue
        dens = loader.species_density(sp, grid)
        if sp.density_max > 0:
            dens = np.minimum(dens, sp.density_max)
        tmax = np.zeros(grid.n)
        for t in sp.temp:
            if t is not None:
                tmax = np.maximum(tmax, loader.eval_on_grid(t, grid))
        om2 = (const.q0 ** 2 / sp.mass / const.epsilon0 * dens
               + 3.0 * k_max ** 2 * const.kb / sp.mass * tmax)
        om2 = om2[om2 > 1e-300]
        if om2.size:
            dt_pf = min(dt_pf, float(2.0 * math.pi / np.sqrt(om2.max())))
    if dt_pf < math.inf:
        dt = min(dt, dt_pf / 2.0)
    return dt * deck.control.dt_multiplier


def build_config(deck: DeckConfig) -> SimConfig:
    """The static config of a parsed deck (sim.py:126)."""
    _normalise_bcs(deck)
    grid = make_grid(deck.control, deck.boundaries)
    for bc in deck.boundaries.bc_field[:2 * grid.ndims]:
        if bc not in bnd.SUPPORTED_FIELD_BCS:
            raise NotImplementedError(
                f"field boundary {bc.name} is not ported yet (a later slice)")
    dt = compute_dt(deck, grid)
    solver_coefficients(deck.control.maxwell_solver, grid, dt)
    prec = deck.control.precision
    if prec not in ("double", "single"):
        raise ValueError(f"precision must be double or single, got {prec!r}")
    species = tuple(SpeciesConfig(
        name=sp.name, charge=sp.charge, mass=sp.mass,
        bc_particle=tuple(sp.bc_particle)) for sp in deck.species)
    lasers = tuple(LaserConfig(
        boundary=lb.boundary, amp=lb.amp, omega=lb.omega,
        pol_angle=lb.pol_angle, t_start=lb.t_start, t_end=lb.t_end,
        t_profile=lb.t_profile, profile=lb.profile, phase=lb.phase)
        for lb in deck.lasers)
    aux = None
    if any(grid.cpml_active):
        b = deck.boundaries
        aux = build_cpml_profiles(grid, b.bc_field, b.cpml_kappa_max,
                                  b.cpml_a_max, b.cpml_sigma_max)
    cfg = SimConfig(
        grid=grid, dt=dt, t_end=deck.control.t_end,
        nsteps=deck.control.nsteps,
        bc_field=tuple(deck.boundaries.bc_field),
        bc_particle=tuple(deck.boundaries.bc_particle),
        species=species, lasers=lasers,
        field_order=deck.control.field_order,
        dtype=torch.float64 if prec == "double" else torch.float32,
        aux=aux, deck=deck)
    return dataclasses.replace(cfg, engine=_select_engine(deck, cfg))


def _select_engine(deck: DeckConfig, cfg: SimConfig) -> str:
    """The binned engine is this slice's only particle engine
    (sim.py:369); the scatter engine comes with a later slice."""
    why = []
    ok = (const.BC.PERIODIC, const.BC.OPEN)
    if not all(bc in ok for sp in cfg.species
               for bc in sp.bc_particle[:2 * cfg.ndims]):
        why.append("a particle boundary other than periodic or open")
    if not cfg.species:
        why.append("no species")
    if why:
        raise NotImplementedError(
            "this slice of the port runs the binned engine only, which "
            "this deck cannot use (" + "; ".join(why) + ")")
    return "binned"


def slot_counts(deck, grid, loaded):
    """Slots per cell K for each species (sim.py:500-529): the headroom
    times the mean occupancy of the loaded cells, at least the load-time
    peak, plus 2."""
    ks = []
    for sp, arrs in zip(deck.species, loaded):
        k = 4
        if arrs is not None:
            x = arrs["x"].numpy()
            cell = np.floor(np.stack(
                [(x[:, d] - grid.grid_min(d)) / grid.delta[d]
                 for d in range(grid.ndims)], axis=1) + 0.5).astype(np.int64)
            flat = np.mod(cell[:, 0], grid.n[0]) * grid.n[1] \
                + np.mod(cell[:, 1], grid.n[1])
            counts = np.bincount(flat, minlength=grid.n[0] * grid.n[1])
            occ = counts[counts > 0]
            head = sp.bin_headroom if sp.bin_headroom > 0 \
                else deck.control.bin_headroom
            k = max(k, max(int(math.ceil(float(occ.mean()) * head)),
                           int(counts.max())) + 2)
        ks.append(k)
    return ks


def field_boundary_saves(fields, cfg) -> dict:
    """ey_x_min etc. for every domain boundary (setup_field_boundaries,
    setup.F90:363-388): components staggered along the boundary axis are
    averaged over the two rows straddling the edge (sim.py:758)."""
    grid = cfg.grid
    ng = grid.ng
    out = {}
    for axis in range(grid.ndims):
        n = grid.n[axis]
        f0 = ng
        f1 = n + ng - 1
        if cfg.bc_field[2 * axis] == const.BC.CPML_LASER:
            f0 = (grid.cpml_thickness + cfg.fng - 1) + ng - 1
        if cfg.bc_field[2 * axis + 1] == const.BC.CPML_LASER:
            f1 = (n - grid.cpml_thickness - cfg.fng + 2) + ng - 1

        def row(a, i, axis=axis):
            return a.select(axis, i)

        stag = {f"e{'xyz'[axis]}"} | {f"b{'xyz'[t]}" for t in range(3)
                                      if t != axis}
        for side, i in (("min", f0), ("max", f1)):
            for nm in ("ex", "ey", "ez", "bx", "by", "bz"):
                arr = getattr(fields, nm)
                key = f"{nm}_{'xyz'[axis]}_{side}"
                if nm in stag:
                    out[key] = 0.5 * (row(arr, i) + row(arr, i - 1))
                else:
                    out[key] = row(arr, i).clone()
    return out


def build_state(cfg: SimConfig, device, seed: int = 0):
    """Load the particles and assemble the initial state (sim.py:462).
    Returns (cfg with the slot counts, state)."""
    deck = cfg.deck
    grid = cfg.grid
    gen = torch.Generator().manual_seed(seed)
    loaded = [loader.load_species(sp, grid, gen) for sp in deck.species]
    ks = slot_counts(deck, grid, loaded)
    cfg = dataclasses.replace(cfg, bin_k=max(ks), bin_k_sp=tuple(ks))
    species = []
    for arrs, K in zip(loaded, ks):
        if arrs is None:
            arrs = {"x": torch.zeros((0, 2), dtype=torch.float64),
                    "p": torch.zeros((0, 3), dtype=torch.float64),
                    "weight": torch.zeros((0,), dtype=torch.float64)}
        species.append(bin_from_arrays(arrs["x"], arrs["p"], arrs["weight"],
                                       grid, K, cfg.dtype, device))
    fields = zero_fields(grid.padded_shape(), cfg.dtype, device)
    cpml = None
    if cfg.any_cpml:
        z = torch.zeros((2 * grid.ndims,) + grid.padded_shape(),
                        dtype=cfg.dtype, device=device)
        cpml = CPMLState(psi_e=z, psi_b=z.clone())
    nl = max(len(cfg.lasers), 1)
    state = SimState(
        fields=fields, cpml=cpml, species=tuple(species),
        lasers=LaserState(torch.zeros(nl, dtype=cfg.dtype, device=device)),
        time=0.0, step=0, bc_fields=field_boundary_saves(fields, cfg))
    return cfg, state


def resolve_device(device):
    """``None`` means CUDA, which must be present; only an explicit
    ``"cpu"`` runs the plain versions on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "Simulation: CUDA is not available; pass device='cpu' to "
                "run the plain PyTorch versions on the host")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Simulation: CUDA is not available")
    return device


class Simulation:
    """Host-side driver (the PROGRAM pic analogue, sim.py:797).

    ``Simulation(deck_path, seed=0, device=None)`` parses the deck, loads
    the particles with a ``torch.Generator`` seeded by ``seed`` and runs
    the start-up sequence; ``device=None`` means CUDA and raises without
    it."""

    def __init__(self, deck_path: str, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.deck = load_deck(deck_path)
        cfg, state = build_state(build_config(self.deck), self.device,
                                 seed=seed)
        self.cfg = cfg
        self.fns = step_mod.make_step_functions(cfg, self.device)
        # init: E bcs + the half-dt laser trick (epoch1d.F90:141-159)
        state = dataclasses.replace(
            state, fields=bnd.efield_bcs(state.fields, cfg))
        self.state = self.fns["init_b_boundaries"](state)

    @property
    def dt(self):
        return self.cfg.dt

    def run(self, dump_callback=None, max_steps=None):
        """Main loop (epoch1d.F90:184-249).  ``dump_callback(sim, state)``
        is called at t = 0, at every mid-step output point and, with
        ``last=True``, at the end; this slice writes no output itself."""
        cfg = self.cfg
        st = self.state
        if dump_callback is not None:
            dump_callback(self, st)
        nsteps = cfg.nsteps if cfg.nsteps >= 0 else None
        if max_steps is not None:
            nsteps = min(nsteps, max_steps) if nsteps else max_steps
        while True:
            if (nsteps is not None and st.step >= nsteps) \
                    or st.time >= cfg.t_end:
                break
            st = self.fns["step_a"](st)
            if dump_callback is not None:
                dump_callback(self, st)
            st = self.fns["step_b"](st)
        self.state = st
        if dump_callback is not None:
            dump_callback(self, st, last=True)
        return st
