"""Input-deck reader (the slice's subset).

Counterpart of ``epoch_tpu/deck/deck.py`` (EPOCH's ``deck.F90``):
``begin:block``/``end:block`` sections of ``element = value`` lines, ``#``
comments, ``\\`` continuations and ``import:`` includes, parsed in two
passes (constants, control and boundaries first; everything else in deck
order).

This slice runs the flagship 2D LWFA deck without its moving window, so it
reads the control, boundaries, constant, laser, species and output blocks.
A block or key outside that set raises ``NotImplementedError`` naming the
later slice that ports it — nothing is silently ignored.  The output block
is parsed and kept; the SDF writer that consumes it comes with the next
slice.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field as dfield

from .. import constants as const
from . import blocks as B
from .expr import DUMPMASK_WORDS, Expression

# blocks the slice refuses, with the slice that brings them
_LATER_BLOCKS = {
    "window": "the moving window (next slice: window + runner + SDF output)",
    "fields": "initial field expressions (a later slice)",
    "dist_fn": "distribution-function output (a later slice)",
    "probe": "particle probes (a later slice)",
    "subset": "output subsets (a later slice)",
    "injector": "particle injectors (a later slice)",
    "collisions": "binary collisions (a later slice)",
    "qed": "QED physics (a later slice)",
    "bremsstrahlung": "bremsstrahlung (a later slice)",
    "particles_from_file": "particle loading from files (a later slice)",
    "stencil": "custom Maxwell stencils (a later slice)",
    "output_global": "global output settings (next slice: SDF output)",
}


@dataclass
class RawBlock:
    name: str
    elements: list      # [(element, value), ...]


def read_deck_lines(path: str) -> list[RawBlock]:
    """Tokenise a deck file into raw blocks, following ``import:``s."""
    out: list[RawBlock] = []
    stack: list[RawBlock] = []
    base = os.path.dirname(os.path.abspath(path))

    def handle_line(line):
        low = line.lower()
        if low.startswith("begin:"):
            stack.append(RawBlock(line.split(":", 1)[1].strip().lower(), []))
        elif low.startswith("end:"):
            if stack:
                out.append(stack.pop())
        elif low.startswith("import:"):
            handle_file(os.path.join(base, line.split(":", 1)[1].strip()))
        elif stack:
            if "=" in line:
                el, val = line.split("=", 1)
            elif ":" in line:
                el, val = line.split(":", 1)
            else:
                el, val = line, ""
            stack[-1].elements.append((el.strip(), val.strip()))

    def handle_file(p):
        with open(p) as f:
            buf = ""
            for raw in f:
                line = raw.split("#", 1)[0].strip()
                if not line:
                    continue
                if line.endswith("\\"):
                    buf += line[:-1] + " "
                    continue
                handle_line(buf + line)
                buf = ""

    handle_file(path)
    return out


@dataclass
class DeckConfig:
    """Parsed deck: the slice's configuration surface."""
    control: B.ControlBlock = dfield(default_factory=B.ControlBlock)
    boundaries: B.BoundariesBlock = dfield(default_factory=B.BoundariesBlock)
    species: list = dfield(default_factory=list)
    lasers: list = dfield(default_factory=list)
    outputs: list = dfield(default_factory=list)
    constants: dict = dfield(default_factory=dict)   # name → RPN (inlined)
    ndims: int = 1

    @property
    def species_names(self):
        return tuple(s.name for s in self.species)


class DeckParseError(ValueError):
    pass


_BOUNDARY_NAMES = {
    "x_min": const.BD_X_MIN, "x_max": const.BD_X_MAX,
    "y_min": const.BD_Y_MIN, "y_max": const.BD_Y_MAX,
    "z_min": const.BD_Z_MIN, "z_max": const.BD_Z_MAX,
    "left": const.BD_X_MIN, "right": const.BD_X_MAX,
    "down": const.BD_Y_MIN, "up": const.BD_Y_MAX,
    "back": const.BD_Z_MIN, "front": const.BD_Z_MAX,
}

_TRUE = {"t", "true", "y", "yes", "on", "1"}
_FALSE = {"f", "false", "n", "no", "off", "0"}


def _later(block, key):
    return NotImplementedError(
        f"deck key {key!r} in block {block!r} is not supported by this "
        "slice of the port (a later slice)")


class DeckParser:
    """Two-pass deck parser (reference: deck.F90:418 ``read_deck``)."""

    def __init__(self):
        self.cfg = DeckConfig()
        self._ctx = {}

    def expr(self, value: str) -> Expression:
        return Expression.compile(value, user_constants=self.cfg.constants)

    def num(self, value: str) -> float:
        return float(self.expr(value)(self._ctx))

    def integer(self, value: str) -> int:
        return int(round(self.num(value)))

    def logical(self, value: str) -> bool:
        v = value.strip().lower()
        if v in _TRUE:
            return True
        if v in _FALSE:
            return False
        raise DeckParseError(f"bad logical {value!r}")

    def dumpmask(self, value: str) -> int:
        v = value.strip().lower()
        if v in _TRUE:
            return int(const.IOType.ALWAYS)
        if v in _FALSE:
            return int(const.IOType.NEVER)
        ctx = {k: float(m) for k, m in DUMPMASK_WORDS.items()}
        ctx.update(self._ctx)
        return int(self.expr(value)(ctx))

    def parse_file(self, path: str) -> DeckConfig:
        raw = read_deck_lines(path)
        for blk in raw:
            if blk.name in _LATER_BLOCKS:
                raise NotImplementedError(
                    f"deck block begin:{blk.name} is not supported by this "
                    f"slice of the port: {_LATER_BLOCKS[blk.name]}")
        first = {"constant": self._handle_constant,
                 "control": self._handle_control,
                 "boundaries": self._handle_boundaries}
        for blk in raw:
            if blk.name in first:
                first[blk.name](blk)
        self._update_ctx()
        rest = {"species": self._handle_species,
                "laser": self._handle_laser,
                "output": self._handle_output}
        for blk in raw:
            if blk.name in first:
                continue
            if blk.name not in rest:
                raise NotImplementedError(
                    f"deck block begin:{blk.name} is not supported by this "
                    "slice of the port")
            rest[blk.name](blk)
        self._finalise()
        return self.cfg

    def _update_ctx(self):
        c = self.cfg.control
        self._ctx.update(
            nx=float(c.nx), ny=float(c.ny), nz=float(c.nz),
            x_min=c.x_min, x_max=c.x_max, y_min=c.y_min, y_max=c.y_max,
            z_min=c.z_min, z_max=c.z_max,
            length_x=c.x_max - c.x_min, lengthx=c.x_max - c.x_min,
            length_y=c.y_max - c.y_min, lengthy=c.y_max - c.y_min,
            length_z=c.z_max - c.z_min, lengthz=c.z_max - c.z_min,
            t_end=c.t_end, nsteps=float(c.nsteps),
        )
        if c.nx:
            self._ctx["dx"] = (c.x_max - c.x_min) / c.nx
        if c.ny > 1:
            self._ctx["dy"] = (c.y_max - c.y_min) / c.ny

    def _handle_constant(self, blk: RawBlock):
        for el, val in blk.elements:
            self.cfg.constants[el] = self.expr(val).rpn

    def _handle_control(self, blk: RawBlock):
        c = self.cfg.control
        for el, val in blk.elements:
            el = el.lower()
            if el in ("nx", "ny", "nz"):
                setattr(c, el, self.integer(val))
            elif el in ("x_min", "x_max", "y_min", "y_max", "z_min", "z_max",
                        "x_start", "x_end", "y_start", "y_end", "z_start",
                        "z_end"):
                setattr(c, el.replace("start", "min").replace("end", "max"),
                        self.num(val))
            elif el == "t_end":
                c.t_end = self.num(val)
            elif el in ("nsteps", "nstep"):
                c.nsteps = self.integer(val)
            elif el == "dt_multiplier":
                c.dt_multiplier = self.num(val)
            elif el == "field_order":
                c.field_order = self.integer(val)
            elif el == "maxwell_solver":
                if val.strip().lower() != "yee":
                    raise _later("control", f"{el} = {val}")
            elif el == "particle_shape":
                if val.strip().lower() != "triangle":
                    raise _later("control", f"{el} = {val}")
            elif el == "precision":
                c.precision = val.strip().lower()
            elif el in ("pusher", "engine"):
                c.pusher = val.strip().lower()
                if c.pusher not in ("auto", "binned"):
                    raise _later("control", f"{el} = {val}")
            elif el == "bin_headroom":
                c.bin_headroom = self.num(val)
            elif el == "bin_overflow":
                if val.strip().lower() != "drop":
                    raise _later("control", f"{el} = {val}")
            elif el in ("stdout_frequency", "print_constants"):
                pass        # console cadence: no effect on the run
            else:
                raise _later("control", el)
            self._update_ctx()

    def _handle_boundaries(self, blk: RawBlock):
        b = self.cfg.boundaries
        for el, val in blk.elements:
            el = el.lower()
            m = re.match(r"bc_(x|y|z)_(min|max)(_field|_particle)?$", el)
            if m:
                idx = _BOUNDARY_NAMES[f"{m.group(1)}_{m.group(2)}"]
                bc = B.BC_NAMES[val.strip().lower()]
                if m.group(3) != "_particle":
                    b.bc_field[idx] = bc
                if m.group(3) != "_field":
                    b.bc_particle[idx] = _particle_bc_from_field(bc) \
                        if m.group(3) is None else bc
            elif el == "cpml_thickness":
                b.cpml_thickness = self.integer(val)
            elif el == "cpml_kappa_max":
                b.cpml_kappa_max = self.num(val)
            elif el == "cpml_a_max":
                b.cpml_a_max = self.num(val)
            elif el == "cpml_sigma_max":
                b.cpml_sigma_max = self.num(val)
            else:
                raise _later("boundaries", el)

    def _handle_species(self, blk: RawBlock):
        s = B.SpeciesBlock()
        for el, val in blk.elements:
            ell = el.lower()
            if ell == "name":
                s.name = val.strip()
            elif ell == "charge":
                s.charge = self.num(val) * const.q0
            elif ell == "mass":
                s.mass = self.num(val) * const.m0
            elif ell in ("npart_per_cell", "nparticles_per_cell"):
                s.npart_per_cell = self.num(val)
            elif ell in ("density", "number_density", "rho"):
                if s.density is not None:
                    raise _later("species", f"layered {ell}")
                s.density = self.expr(val)
            elif ell in ("density_min", "number_density_min", "minrho"):
                s.density_min = self.num(val)
            elif ell in ("density_max", "number_density_max", "maxrho"):
                s.density_max = self.num(val)
            elif ell in ("temp", "temperature", "temp_k", "temperature_k"):
                e = self.expr(val)
                s.temp = [e, e, e]
            elif ell in ("temp_ev", "temperature_ev"):
                e = self.expr(f"({val}) * ev / kb")
                s.temp = [e, e, e]
            elif ell == "bin_headroom":
                s.bin_headroom = self.num(val)
            else:
                m = re.match(r"temp(?:erature)?_(x|y|z)(_ev|_k)?$", ell)
                m2 = re.match(r"drift_?p?(x|y|z)$", ell)
                m3 = re.match(r"bc_(x|y|z)_(min|max)$", ell)
                if m:
                    text = f"({val}) * ev / kb" if m.group(2) == "_ev" \
                        else val
                    s.temp["xyz".index(m.group(1))] = self.expr(text)
                elif m2:
                    s.drift["xyz".index(m2.group(1))] = self.expr(val)
                elif m3:
                    idx = _BOUNDARY_NAMES[f"{m3.group(1)}_{m3.group(2)}"]
                    s.bc_particle[idx] = B.BC_NAMES[val.strip().lower()]
                else:
                    raise _later("species", ell)
        if not s.name:
            raise DeckParseError("species block without a name")
        if s.name in self.cfg.species_names:
            raise _later("species", f"re-opened species {s.name!r}")
        self.cfg.species.append(s)

    def _handle_laser(self, blk: RawBlock):
        las = B.LaserBlock()
        for el, val in blk.elements:
            el = el.lower()
            if el in ("boundary", "direction"):
                las.boundary = _BOUNDARY_NAMES[val.strip().lower()]
            elif el == "amp":
                las.amp = self.num(val)
            elif el in ("intensity", "irradiance"):
                las.amp = (self.num(val)
                           / (const.c * const.epsilon0 / 2.0)) ** 0.5
            elif el in ("intensity_w_cm2", "irradiance_w_cm2"):
                las.amp = ((self.num(val)
                            / (const.c * const.epsilon0 / 2.0)) ** 0.5) * 100.0
            elif el in ("omega", "freq", "frequency", "lambda"):
                e = self.expr(val)
                if e.time_varying:
                    raise _later("laser", f"time-varying {el}")
                om = float(e(self._ctx))
                if el in ("freq", "frequency"):
                    om = 2.0 * const.pi * om
                elif el == "lambda":
                    om = 2.0 * const.pi * const.c / om
                las.omega = om
            elif el in ("pol_angle", "pol"):
                ang = self.num(val)
                las.pol_angle = ang * const.pi / 180.0 if el == "pol" else ang
            elif el == "phase":
                las.phase = self.expr(val)
            elif el == "t_profile":
                las.t_profile = self.expr(val)
            elif el == "profile":
                las.profile = self.expr(val)
            elif el == "t_start":
                las.t_start = self.num(val) \
                    if val.strip().lower() != "start" else 0.0
            elif el == "t_end":
                las.t_end = self.num(val) if val.strip().lower() != "end" \
                    else self.cfg.control.t_end
            else:
                raise _later("laser", el)
        self.cfg.lasers.append(las)

    def _handle_output(self, blk: RawBlock):
        o = B.OutputBlock()
        for el, val in blk.elements:
            el = el.lower()
            if el == "name":
                o.name = val.strip()
            elif el == "dt_snapshot":
                o.dt_snapshot = self.num(val)
            elif el == "nstep_snapshot":
                o.nstep_snapshot = self.integer(val)
            elif el in ("dump_first", "dump_last"):
                setattr(o, el, self.logical(val))
            else:
                o.variables[el] = self.dumpmask(val)
        self.cfg.outputs.append(o)

    def _finalise(self):
        cfg = self.cfg
        c = cfg.control
        cfg.ndims = 3 if c.nz > 1 else 2 if c.ny > 1 else 1
        if cfg.ndims != 2:
            raise NotImplementedError(
                f"{cfg.ndims}D decks are not supported by this slice of the "
                "port (2D only; 1D and 3D come with later slices)")
        for las in cfg.lasers:
            if las.t_end == float("inf"):
                las.t_end = c.t_end          # laser.f90:40
        for s in cfg.species:
            for i in range(6):
                if s.bc_particle[i] is None:
                    s.bc_particle[i] = cfg.boundaries.bc_particle[i]


def _particle_bc_from_field(bc: const.BC) -> const.BC:
    """Field BC name → implied particle BC (boundary.F90:99-139)."""
    if bc in (const.BC.SIMPLE_LASER, const.BC.SIMPLE_OUTFLOW,
              const.BC.CPML_LASER, const.BC.CPML_OUTFLOW):
        return const.BC.OPEN
    if bc == const.BC.CONDUCT:
        return const.BC.REFLECT
    return bc


def load_deck(path: str) -> DeckConfig:
    return DeckParser().parse_file(path)
