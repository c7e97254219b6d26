"""Kernel B wrapper: the binned particle hot loop of one species.

Counterpart of ``epoch_tpu/ops/binned_kernels.py::PallasBinned`` (driver of
``make_fused_push``).  ``binned_push`` sends CUDA tensors to the kernel of
``csrc/binned_push.cu`` (three launches: drift + x rebin, y rebin + push +
deposit, current fold) and CPU tensors to the plain version
``core/binned.push_deposit_plain``; there is no fallback from one to the
other.

None of the reference's Mosaic staging is carried over: no per-stripe
field windows (``make_fwin``), no halo columns as separate inputs, no
flat/carried side arrays, no alignment padding of the slot grid.  A CUDA
thread reads its neighbour cells from global memory.

Tolerance against the plain version on the card: w, xi, p and the dropped
count exactly (both round every operation in float32 in the same order),
except where one f32 rounding of a drifted position that lies within
1e-5 cell widths of a cell edge routes a particle differently; J to
1e-5·max|J| (the kernel sums each cell's slots in slot order and the 25
window offsets of each node in a fixed order, the plain version in
PyTorch's reduction order; both orders are deterministic).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import constants as const
from ..core import binned as binmod
from . import build


def _argtypes(lib):
    fn = lib.binned_push_f32
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def kernel_scalars(sp, plan):
    """The float scalars of the kernel, in the order of its Params."""
    q = float(sp.charge)
    part_mc = float(const.c * sp.mass)
    ipart_mc = float(1.0 / part_mc)
    cm = float(q * 0.5 * plan.dt * ipart_mc)
    return (ipart_mc,
            float(const.c * plan.dt / 2.0 / plan.delta[0]),
            float(const.c * plan.dt / 2.0 / plan.delta[1]),
            cm, float(cm * const.c), part_mc, const.c,
            float(plan.dto2 / plan.delta[0]),
            float(plan.dto2 / plan.delta[1]),
            plan.fj[0], plan.fj[1], plan.fj[2], q, plan.fac, 1.0 / 3.0)


class BinnedPush:
    """Callable wrapper of kernel B with a launch counter (one count per
    call that launches the kernel, whatever its number of launches).

    ``binned_push(fpad, b, sp, plan, bc)`` → (new BinnedSpecies, jpad):
    ``fpad`` is the (6, nx+4, ny+4) field stack of make_fpad, ``bc`` the
    four particle BC codes, jpad the (3, nx+4, ny+4) margin-padded
    deposit."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def __call__(self, fpad, b, sp, plan, bc):
        dev = b.w.device
        if dev.type == "cpu":
            return binmod.push_deposit_plain(fpad, b, sp, plan, bc)
        if dev.type != "cuda":
            raise ValueError(f"binned_push: unsupported device {dev}")
        return self._launch(fpad, b, sp, plan, bc)

    def _launch(self, fpad, b, sp, plan, bc):
        PER, OPEN = const.BC.PERIODIC, const.BC.OPEN
        if bc[2] != PER or bc[3] != PER:
            raise NotImplementedError("bounded y particle boundaries are "
                                      "not ported yet (a later slice)")
        periodic_x = bc[0] == PER and bc[1] == PER
        if not periodic_x and (bc[0] not in (PER, OPEN)
                               or bc[1] not in (PER, OPEN)
                               or PER in (bc[0], bc[1])):
            raise NotImplementedError(
                f"x particle boundaries {bc[0].name}/{bc[1].name} are not "
                "ported yet (a later slice)")
        K = b.K
        nx, ny = plan.n
        dev = b.w.device
        for name, t, shape in (("w", b.w, (K, nx, ny)),
                               ("xi", b.xi, (2, K, nx, ny)),
                               ("p", b.p, (3, K, nx, ny)),
                               ("fpad", fpad, (6, nx + 4, ny + 4))):
            if t.device != dev:
                raise ValueError(f"{name}: on {t.device}, expected {dev}")
            if t.dtype != torch.float32:
                raise TypeError(f"{name}: the CUDA kernel takes float32, "
                                f"got {t.dtype}")
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                                 f"expected {shape}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: not contiguous")
        w1, xi1, p1 = (torch.empty_like(b.w), torch.empty_like(b.xi),
                       torch.empty_like(b.p))
        w_o, xi_o, p_o = (torch.empty_like(b.w), torch.empty_like(b.xi),
                          torch.empty_like(b.p))
        part = torch.empty((75, nx, ny), dtype=torch.float32, device=dev)
        jpad = torch.empty((3, nx + 4, ny + 4), dtype=torch.float32,
                           device=dev)
        ndrop = torch.zeros(1, dtype=torch.int32, device=dev)
        scal = kernel_scalars(sp, plan)
        s_arr = (ctypes.c_float * len(scal))(*scal)
        if self._fn is None:
            self._fn = _argtypes(build.load("binned_push"))
        P = build.ptr
        err = self._fn(
            P(b.w), P(b.xi), P(b.p), P(fpad), P(w1), P(xi1), P(p1),
            P(w_o), P(xi_o), P(p_o), P(part), P(jpad), P(ndrop),
            K, nx, ny, 1 if periodic_x else 0,
            1 if bc[0] == OPEN else 0, 1 if bc[1] == OPEN else 0,
            ctypes.cast(s_arr, ctypes.c_void_p), build.stream_of(b.w))
        build.check(err, "binned_push")
        self.launches += 1
        out = dataclasses.replace(b, w=w_o, xi=xi_o, p=p_o,
                                  n_dropped=b.n_dropped + ndrop[0])
        return out, jpad


binned_push = BinnedPush()
