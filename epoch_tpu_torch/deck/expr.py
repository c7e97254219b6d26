"""EPOCH input-deck expression language (the slice's subset).

Counterpart of ``epoch_tpu/deck/expr.py``: tokenizer, shunting-yard
infix→RPN and an RPN evaluator over numpy arrays (the reference parser
stack, ``epoch2d/src/parser/``).  Expressions are evaluated on the host —
density and temperature grids at load time, laser profiles once, laser
time envelopes per step on a Python float — so the evaluator needs no
tensor namespace.

Operators and precedences follow the reference table
(``constants.F90:320-325``).  Functions the flagship deck and the common
math vocabulary need are implemented; the rest of the reference's
vocabulary (species-parameterised grid functions, ``interpolate``,
``semigauss``, ...) raises ``NotImplementedError`` until a later slice
ports it.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .. import constants as const

_TOKEN_RE = re.compile(
    r"""
    (?P<num>\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_\.]*)
  | (?P<op>[-+*/^(),])
    """,
    re.VERBOSE,
)

# binary word-operators (lt/gt/eq/and/or and the standalone exponent 'e')
_WORD_OPS = {"lt", "gt", "eq", "and", "or", "e"}

# operator → (precedence, right_associative)
_PREC = {
    "or": (0, False),
    "and": (0, False),
    "lt": (1, False),
    "gt": (1, False),
    "eq": (1, False),
    "+": (2, False),
    "-": (2, False),
    "*": (3, False),
    "/": (3, False),
    "^": (4, True),
    "e": (4, True),
    "neg": (4, True),
}

# implemented functions → number of arguments
FUNCTIONS = {
    "abs": 1, "floor": 1, "ceil": 1, "nint": 1, "sqrt": 1,
    "sin": 1, "cos": 1, "tan": 1, "asin": 1, "acos": 1, "atan": 1,
    "atan2": 2, "sinh": 1, "cosh": 1, "tanh": 1, "exp": 1,
    "loge": 1, "ln": 1, "log10": 1, "gauss": 3, "if": 3,
}

# reference vocabulary not ported yet: parsed as functions, refused
_LATER_FUNCTIONS = {
    "log_base", "semigauss", "supergauss", "interpolate", "critical",
    "density", "rho", "number_density",
    "temp_x", "temp_y", "temp_z", "temp_x_k", "temp_y_k", "temp_z_k",
    "temperature_x", "temperature_y", "temperature_z",
    "temp_x_ev", "temp_y_ev", "temp_z_ev",
    "ex", "ey", "ez", "bx", "by", "bz",
}

_CONSTANTS = {
    "pi": const.pi,
    "kb": const.kb,
    "me": const.m0,
    "qe": const.q0,
    "c": const.c,
    "eps0": const.epsilon0,
    "epsilon0": const.epsilon0,
    "epsilonnought": const.epsilon0,
    "mu0": const.mu0,
    "munought": const.mu0,
    "ev": const.ev,
    "kev": const.ev * 1e3,
    "mev": const.ev * 1e6,
    "milli": 1e-3,
    "micro": 1e-6,
    "micron": 1e-6,
    "cm3": 1e-6,
    "cc": 1e-6,
    "nano": 1e-9,
    "pico": 1e-12,
    "femto": 1e-15,
    "atto": 1e-18,
    "yee": float(const.MaxwellSolver.YEE),
}

# dumpmask words (tokenizer_blocks.f90:221-253)
DUMPMASK_WORDS = {
    "never": const.IOType.NEVER,
    "always": const.IOType.ALWAYS,
    "full": const.IOType.FULL,
    "restartable": const.IOType.RESTART,
    "restart": const.IOType.RESTART,
    "average": const.IOType.AVERAGE,
    "snapshot": const.IOType.SNAPSHOT,
    "species": const.IOType.SPECIES,
    "no_sum": const.IOType.NO_SUM,
    "single": const.IOType.SINGLE,
    "average_single": const.IOType.AVERAGE_SINGLE,
}

# deck variables resolved from the evaluation context at run time
CONTEXT_VARS = {
    "x", "y", "z", "time",
    "nx", "ny", "nz", "dx", "dy", "dz",
    "x_min", "x_max", "y_min", "y_max", "z_min", "z_max",
    "lengthx", "length_x", "lengthy", "length_y", "lengthz", "length_z",
    "nsteps", "t_end", "ndims",
}


class DeckExprError(ValueError):
    pass


@dataclass(frozen=True)
class Op:
    """One RPN element."""
    kind: str       # 'num' | 'var' | 'op' | 'func'
    val: Any = None
    nargs: int = 0


def tokenize(text: str) -> list[tuple]:
    toks = []
    pos = 0
    text = text.strip()
    while pos < len(text):
        if text[pos].isspace():
            pos += 1
            continue
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise DeckExprError(f"cannot tokenize {text[pos:]!r} in {text!r}")
        pos = m.end()
        if m.lastgroup == "num":
            toks.append(("num", m.group()))
        elif m.lastgroup == "name":
            name = m.group()
            if name.lower() in _WORD_OPS:
                toks.append(("op", name.lower()))
            else:
                toks.append(("name", name))
        else:
            toks.append(("op", m.group()))
    return toks


def parse(text: str, user_constants: dict | None = None) -> list[Op]:
    """Shunting-yard infix → RPN (reference: parser/shunt.F90:371-505).

    ``user_constants`` are ``begin:constant`` entries, inlined at the point
    of use."""
    user_constants = user_constants or {}
    toks = tokenize(text)
    out: list[Op] = []
    stack: list[tuple] = []     # ('op', name) | ('func', name) | ('paren',)
    prev_kind = "start"         # start | value | op | lparen | comma
    for i, (kind, tok) in enumerate(toks):
        if kind == "num":
            out.append(Op("num", float(tok)))
            prev_kind = "value"
        elif kind == "name":
            nxt = toks[i + 1] if i + 1 < len(toks) else None
            low = tok.lower()
            if (low in FUNCTIONS or low in _LATER_FUNCTIONS) \
                    and nxt == ("op", "("):
                if low in _LATER_FUNCTIONS:
                    raise NotImplementedError(
                        f"deck function {low!r} is not ported yet "
                        "(a later slice of the port)")
                stack.append(("func", low))
                prev_kind = "op"
            elif tok in user_constants:
                out.extend(user_constants[tok])
                prev_kind = "value"
            elif low in _CONSTANTS:
                out.append(Op("num", _CONSTANTS[low]))
                prev_kind = "value"
            elif low in CONTEXT_VARS:
                out.append(Op("var", low))
                prev_kind = "value"
            else:
                # late-bound names (dumpmask words) resolve from the context
                out.append(Op("var", tok))
                prev_kind = "value"
        elif kind == "op" and tok == "(":
            stack.append(("paren",))
            prev_kind = "lparen"
        elif kind == "op" and tok == ")":
            while stack and stack[-1][0] == "op":
                out.append(Op("op", stack.pop()[1]))
            if not stack:
                raise DeckExprError(f"mismatched ')' in {text!r}")
            stack.pop()
            if stack and stack[-1][0] == "func":
                fname = stack.pop()[1]
                out.append(Op("func", fname, nargs=FUNCTIONS[fname]))
            prev_kind = "value"
        elif kind == "op" and tok == ",":
            while stack and stack[-1][0] == "op":
                out.append(Op("op", stack.pop()[1]))
            prev_kind = "comma"
        else:
            name = tok
            if prev_kind in ("start", "op", "lparen", "comma"):
                if name == "+":
                    continue          # unary plus is a no-op
                if name == "-":
                    name = "neg"
            prec, right = _PREC[name]
            while stack and stack[-1][0] == "op":
                tprec, _ = _PREC[stack[-1][1]]
                if tprec > prec or (tprec == prec and not right):
                    out.append(Op("op", stack.pop()[1]))
                else:
                    break
            stack.append(("op", name))
            prev_kind = "op"
    while stack:
        top = stack.pop()
        if top[0] != "op":
            raise DeckExprError(f"mismatched '(' in {text!r}")
        out.append(Op("op", top[1]))
    return out


def _bool(v):
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    return np.where(v, 1.0, 0.0)


def _truthy(v):
    if isinstance(v, bool):
        return v
    return v != 0


def _power(a, b):
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a ** b
    return np.power(a, b)


_UNARY = {
    "abs": np.abs, "floor": np.floor, "ceil": np.ceil, "nint": np.round,
    "sqrt": np.sqrt, "sin": np.sin, "cos": np.cos, "tan": np.tan,
    "asin": np.arcsin, "acos": np.arccos, "atan": np.arctan,
    "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh, "exp": np.exp,
    "loge": np.log, "ln": np.log, "log10": np.log10,
}


def evaluate(rpn: list[Op], ctx: dict[str, Any]):
    """Evaluate an RPN program over numpy arrays or Python floats.

    Semantics follow parser/evaluator_blocks.F90 (gauss :964, if :845,
    'e' operator = a*10^b :100)."""
    st: list[Any] = []
    for op in rpn:
        if op.kind == "num":
            st.append(op.val)
        elif op.kind == "var":
            if op.val not in ctx:
                raise DeckExprError(f"unknown deck variable {op.val!r}")
            st.append(ctx[op.val])
        elif op.kind == "op":
            if op.val == "neg":
                st.append(-st.pop())
                continue
            b = st.pop()
            a = st.pop()
            if op.val == "+":
                st.append(a + b)
            elif op.val == "-":
                st.append(a - b)
            elif op.val == "*":
                st.append(a * b)
            elif op.val == "/":
                st.append(a / b)
            elif op.val == "^":
                st.append(_power(a, b))
            elif op.val == "e":
                st.append(a * 10.0 ** b)
            elif op.val == "lt":
                st.append(_bool(a < b))
            elif op.val == "gt":
                st.append(_bool(a > b))
            elif op.val == "eq":
                st.append(_bool(a == b))
            elif op.val == "and":
                st.append(_bool(_truthy(a) & _truthy(b)))
            else:   # "or"
                st.append(_bool(_truthy(a) | _truthy(b)))
        else:
            args = st[len(st) - op.nargs:]
            del st[len(st) - op.nargs:]
            f = op.val
            if f in _UNARY:
                st.append(_UNARY[f](args[0]))
            elif f == "atan2":
                st.append(np.arctan2(args[0], args[1]))
            elif f == "gauss":
                x, x0, w = args
                st.append(np.exp(-(((x - x0) / w) ** 2)))
            else:   # "if"
                cond, t, fv = args
                st.append(np.where(np.floor(cond) != 0, t, fv))
    if len(st) != 1:
        raise DeckExprError(f"expression left {len(st)} values on stack")
    return st[0]


@dataclass
class Expression:
    """A parsed deck expression: RPN plus an evaluator."""
    text: str
    rpn: list[Op] = field(default_factory=list)

    @classmethod
    def compile(cls, text, user_constants=None):
        return cls(text=text, rpn=parse(text, user_constants))

    @property
    def time_varying(self) -> bool:
        return any(op.kind == "var" and op.val == "time" for op in self.rpn)

    def __call__(self, ctx=None, **kw):
        c = dict(ctx or {})
        c.update(kw)
        return evaluate(self.rpn, c)
