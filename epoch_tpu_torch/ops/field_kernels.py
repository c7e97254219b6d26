"""Kernel A wrapper: one Maxwell half-update, E or B, with CPML psi.

Counterpart of ``epoch_tpu/ops/field_kernels.py::make_field_half_kernel``.
``field_half`` sends CUDA tensors to the kernel of ``csrc/field_half.cu``
and CPU tensors to the plain version (``core/fields.update_e_field`` /
``update_b_field``); there is no fallback from one to the other.  Unlike
the reference, which runs its Pallas kernel only when the field stack fits
its 10 MiB VMEM gate (``fused_fields_eligible``, field_kernels.py:166), the
port runs the kernel at every size.

Tolerance against the plain version on the card: 0 (both round every
operation in float32 in the same order; the kernel is built without fused
multiply-adds).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import constants as const
from ..core import fields as fld
from . import build


def _argtypes(lib):
    fn = lib.field_half_f32
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _addr_array(tensors):
    arr = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    return arr, ctypes.cast(arr, ctypes.c_void_p)


class FieldHalf:
    """Callable wrapper of kernel A with launch counters: ``launches`` in
    all, ``launches_by`` per half.

    ``field_half(which, f, plan, cpml)`` → (new Fields, new CPMLState): the
    "e" half updates ex/ey/ez and psi_e, the "b" half bx/by/bz and psi_b."""

    def __init__(self):
        self.launches = 0
        self.launches_by = {"e": 0, "b": 0}
        self._fn = None

    def __call__(self, which, f, plan, cpml):
        if which not in ("e", "b"):
            raise ValueError(f"which must be 'e' or 'b', got {which!r}")
        dev = f.ex.device
        if dev.type == "cpu":
            upd = fld.update_e_field if which == "e" else fld.update_b_field
            return upd(f, plan, cpml)
        if dev.type != "cuda":
            raise ValueError(f"field_half: unsupported device {dev}")
        return self._launch(which, f, plan, cpml)

    def _launch(self, which, f, plan, cpml):
        names = ("ex", "ey", "ez", "bx", "by", "bz") \
            + (("jx", "jy", "jz") if which == "e" else ())
        ins = [getattr(f, nm) for nm in names]
        shape = ins[0].shape
        if len(shape) != 2:
            raise ValueError("field_half: the kernel is 2D")
        for nm, t in zip(names, ins):
            _check(t, nm, shape, ins[0].device)
        psi = None
        if plan.cpml:
            if cpml is None:
                raise ValueError("field_half: CPML plan without CPML state")
            psi = cpml.psi_e if which == "e" else cpml.psi_b
            _check(psi, "psi", (4,) + tuple(shape), ins[0].device)
        outs = [torch.empty_like(ins[0]) for _ in range(3)]
        psi_o = torch.empty_like(psi) if psi is not None else None
        if which == "e":
            scal = (-plan.fac, plan.cn[0], plan.cn[1],
                    plan.hdt * const.c ** 2)
        else:
            scal = (plan.hdtd[0], plan.hdtd[1], plan.hdt)
        s_arr = (ctypes.c_float * len(scal))(*scal)
        in_arr, in_p = _addr_array(ins)
        out_arr, out_p = _addr_array(outs)
        prof_p = None
        if plan.cpml:
            vecs = [plan.profiles[which][d][i]
                    for i in range(3) for d in range(2)]
            for v, npad in zip(vecs, [shape[0], shape[1]] * 3):
                _check(v, "cpml profile", (npad,), ins[0].device)
            prof_arr, prof_p = _addr_array(vecs)
        if self._fn is None:
            self._fn = _argtypes(build.load("field_half"))
        lo = plan.ng - 1
        err = self._fn(
            1 if which == "b" else 0, plan.order, 1 if plan.cpml else 0,
            in_p, out_p,
            build.ptr(psi) if psi is not None else None,
            build.ptr(psi_o) if psi_o is not None else None,
            prof_p, ctypes.cast(s_arr, ctypes.c_void_p),
            shape[0], shape[1], lo, plan.n[0] + lo, lo, plan.n[1] + lo,
            build.stream_of(ins[0]))
        build.check(err, f"field_half({which!r})")
        self.launches += 1
        self.launches_by[which] += 1
        if which == "e":
            f = dataclasses.replace(f, ex=outs[0], ey=outs[1], ez=outs[2])
            if psi_o is not None:
                cpml = dataclasses.replace(cpml, psi_e=psi_o)
        else:
            f = dataclasses.replace(f, bx=outs[0], by=outs[1], bz=outs[2])
            if psi_o is not None:
                cpml = dataclasses.replace(cpml, psi_b=psi_o)
        return f, cpml


def _check(t, name, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


field_half = FieldHalf()
