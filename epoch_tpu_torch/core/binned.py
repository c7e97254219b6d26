"""Cell-binned slot-grid particle engine and the plain version of kernel B.

Counterpart of ``epoch_tpu/core/binned.py``.  Particles live in a dense
per-cell slot grid, slot-major with the grid axes minor:

    w  : (K, nx, ny)       weight (0 ⇒ empty slot)
    xi : (2, K, nx, ny)    position within the own cell, in cell units
    p  : (3, K, nx, ny)    momentum

``push_deposit_plain`` is the plain PyTorch version of the CUDA kernel in
``csrc/binned_push.cu``, which replaces the fused Pallas kernel
``epoch_tpu/ops/binned_kernels.py::make_fused_push``.  It computes what
that kernel computes for this slice's variant (x open or periodic, y
periodic, no window, no extra payload rows):

1. half-drift (``drift``, binned_kernels.py:533);
2. x particle boundaries, then the x rebin: each cell gathers the
   candidates routed to it from cells {c, c−1, c+1} — in the order
   **centre, left, right** — and keeps the first K live ones in that
   stable order (``_axis_rebin``/``_compact``, binned_kernels.py:205,169);
   the rest go to the dropped counter;
3. the y rebin the same way (periodic roll);
4. the triangle-shape gather of the six field components (``_gather6``),
   the Boris push and the move (binned_kernels.py:1090-1131);
5. the closed-form PSC charge-conserving deposit into a margin-padded J
   (binned_kernels.py:1202), from the pre-boundary state;
6. the end-of-push particle boundaries.

It is not the reference's XLA-path ``rebin`` (binned.py:1782), whose
unstable sort orders slots differently.  Every operation keeps the fused
kernel's order term for term, so the CUDA kernel, built without fused
multiply-adds, reproduces it in float32 up to the summation order of J.
Empty output slots hold zeros.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import constants as const
from .boundaries import STAGGER
from .state import BinnedSpecies

FIELD6 = ("ex", "ey", "ez", "bx", "by", "bz")
OFFSETS = (-2, -1, 0, 1, 2)     # deposit window (binned.py:168)
M = 2                           # deposit margin = −OFFSETS[0]


class BinnedPlan:
    """Static scalars of the slot-grid push (``binned.py:115``)."""

    def __init__(self, cfg):
        grid = cfg.grid
        if grid.ndims != 2:
            raise NotImplementedError("the binned engine of this slice is "
                                      "2D (3D comes with a later slice)")
        if grid.shape_fn != const.Shape.TRIANGLE:
            raise NotImplementedError("binned engine: triangle shape only")
        self.nd = 2
        self.n = tuple(grid.n)
        self.dt = float(cfg.dt)
        self.delta = tuple(float(d) for d in grid.delta)
        self.grid_min = tuple(float(grid.grid_min(d)) for d in range(2))
        self.fac = 0.5 ** 2                      # FAC_1D[TRIANGLE] ** nd
        self.dto2 = float(cfg.dt / 2.0)
        self.dtco2 = float(const.c * self.dto2)
        d = grid.delta
        self.fj = (self.fac / (cfg.dt * d[1]), self.fac / (cfg.dt * d[0]),
                   self.fac / (d[0] * d[1]))
        # boundary cell per axis side: particles live on the full grid
        # including the CPML layers (binned.py:168-175)
        self.kb = tuple((0, grid.n[d] - 1) for d in range(2))


def bin_from_arrays(x, p, w, grid, K, dtype, device) -> BinnedSpecies:
    """Place flat particle arrays (float64 CPU tensors) into the slot grid,
    in load order within each cell; particles beyond K are counted as
    dropped (``binned.py:200``)."""
    nd = grid.ndims
    n = grid.n
    C = n[0] * n[1]
    r = torch.stack([(x[:, d] - grid.grid_min(d)) / grid.delta[d]
                     for d in range(nd)], dim=1)
    cell = torch.floor(r + 0.5)
    xi = r - cell
    cell = cell.long()
    cell = torch.stack([torch.remainder(cell[:, d], n[d])
                        for d in range(nd)], dim=1)
    flat = cell[:, 0] * n[1] + cell[:, 1]
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=C)
    ndrop = int(torch.clamp(counts - K, min=0).sum())
    starts = torch.zeros(C + 1, dtype=torch.long)
    starts[1:] = torch.cumsum(counts, 0)
    pos_sorted = torch.arange(x.shape[0]) - starts[flat[order]]
    keep = pos_sorted < K
    idx_part = order[keep]
    idx_cell = flat[idx_part]
    idx_slot = pos_sorted[keep]
    xi_g = torch.zeros((nd, K, C), dtype=torch.float64)
    p_g = torch.zeros((3, K, C), dtype=torch.float64)
    w_g = torch.zeros((K, C), dtype=torch.float64)
    for d in range(nd):
        xi_g[d, idx_slot, idx_cell] = xi[idx_part, d]
    for i in range(3):
        p_g[i, idx_slot, idx_cell] = p[idx_part, i]
    w_g[idx_slot, idx_cell] = w[idx_part]

    def dev(a, lead):
        return a.reshape(lead + tuple(n)).to(device=device, dtype=dtype)

    return BinnedSpecies(
        xi=dev(xi_g, (nd, K)), p=dev(p_g, (3, K)), w=dev(w_g, (K,)),
        n_dropped=torch.tensor(ndrop, dtype=torch.int32, device=device))


def make_fpad(fields, grid):
    """(6, n+4 per axis) field stack with 2 ghost rows per side, sliced
    from the padded field arrays (``binned.py:386``)."""
    ng = grid.ng
    sl = tuple(slice(ng - 2, ng + n + 2) for n in grid.n)
    return torch.stack([getattr(fields, nm)[sl] for nm in FIELD6], dim=0)


def jpad_to_padded(jpad, grid):
    """Place the margin-padded deposit into full ghost-padded J arrays;
    the periodic summation then runs through boundaries.current_bcs
    (``binned.py:398``)."""
    ng = grid.ng
    out = torch.zeros((3,) + grid.padded_shape(), dtype=jpad.dtype,
                      device=jpad.device)
    region = (slice(None),) + tuple(slice(ng - M, ng + n + M)
                                    for n in grid.n)
    out[region] = jpad
    return out


def fold_margins(jpad, plan):
    """Periodic fold of the deposit margins back into the interior
    (processor_summation_bcs analogue, ``binned.py:756``)."""
    jpad = jpad.clone()
    for d in range(plan.nd):
        n = plan.n[d]

        def slc(lo, hi, d=d):
            sl = [slice(None)] * (plan.nd + 1)
            sl[1 + d] = slice(lo, hi)
            return tuple(sl)

        jpad[slc(n, n + M)] += jpad[slc(0, M)]
        jpad[slc(M, 2 * M)] += jpad[slc(n + M, n + 2 * M)]
    core = (slice(None),) + tuple(slice(M, M + n) for n in plan.n)
    jcore = jpad[core]
    return jcore[0], jcore[1], jcore[2]


def apply_axis_bcs(xi, p, w, plan, d, bc_lo, bc_hi):
    """Open particle boundaries on axis ``d`` of the slot grid
    (``binned.py:1373``, the kernel's ``_bc_axis``): a live particle in the
    edge cell whose position lies beyond the edge is removed (w = 0);
    position and momentum are left as they are.  ``xi``/``p`` are lists of
    per-component tensors.  Reflecting and thermal walls come with a later
    slice."""
    idx = torch.arange(plan.n[d], device=w.device)
    idx = idx.view((1, -1, 1) if d == 0 else (1, 1, -1))
    kb_lo, kb_hi = plan.kb[d]
    alive = w > 0
    for hi_side, bc in ((False, bc_lo), (True, bc_hi)):
        if bc == const.BC.PERIODIC:
            continue
        if bc != const.BC.OPEN:
            raise NotImplementedError(
                f"particle boundary {bc.name} is not ported yet "
                "(a later slice)")
        xa = xi[d]
        if hi_side:
            crossing = (idx == kb_hi) & (xa >= 0.5) & alive
            inside_kill = idx > kb_hi
        else:
            crossing = (idx == kb_lo) & (xa < -0.5) & alive
            inside_kill = idx < kb_lo
        w = torch.where(crossing | (inside_kill & alive), 0.0, w)
        alive = w > 0
    return xi, p, w


def _roll_in(a, off, axis, periodic):
    """Values of the neighbour cell c+off along grid ``axis`` of a
    (rows, nx, ny) tensor; with a bounded axis the cells beyond the edge
    contribute nothing."""
    dim = 1 + axis
    out = torch.roll(a, -off, dims=dim)
    if not periodic:
        edge = [slice(None)] * 3
        edge[dim] = slice(-1, None) if off > 0 else slice(0, 1)
        out[tuple(edge)] = 0
    return out


def axis_rebin(w, xi0, xi1, p, axis, periodic, ndrop):
    """One axis of the rebin (``_axis_rebin``, binned_kernels.py:205):
    shift ξ by dc = clip(⌊ξ+½⌋, −1, 1), gather the candidates routed to
    each cell — its own particles with dc = 0, then the left neighbour's
    with dc = +1, then the right neighbour's with dc = −1 — and compact
    them live-first in that stable order back into K slots."""
    K = w.shape[0]
    xa = xi0 if axis == 0 else xi1
    alive = w > 0
    dc = torch.clamp(torch.floor(xa + 0.5), -1.0, 1.0)
    dc = torch.where(alive, dc, 0.0)
    xa = xa - dc
    pos = [xa, xi1] if axis == 0 else [xi0, xa]
    pay = torch.stack(pos + list(p))                 # (5, K, nx, ny)
    w_l = _roll_in(w, -1, axis, periodic)
    w_r = _roll_in(w, 1, axis, periodic)
    dc_l = _roll_in(dc, -1, axis, periodic)
    dc_r = _roll_in(dc, 1, axis, periodic)
    pay_l = _roll_in(pay.flatten(0, 1), -1, axis, periodic).view_as(pay)
    pay_r = _roll_in(pay.flatten(0, 1), 1, axis, periodic).view_as(pay)
    live_c = (w > 0) & (dc == 0.0)
    live_l = (w_l > 0) & (dc_l == 1.0)
    live_r = (w_r > 0) & (dc_r == -1.0)
    cand_w = torch.cat([torch.where(live_c, w, 0.0),
                        torch.where(live_l, w_l, 0.0),
                        torch.where(live_r, w_r, 0.0)], dim=0)
    cand = torch.cat([pay, pay_l, pay_r], dim=1)     # (5, 3K, nx, ny)
    live = cand_w > 0
    rank = torch.cumsum(live.to(torch.int32), dim=0) - 1
    keep = live & (rank < K)
    ndrop = ndrop + (live & ~keep).sum().to(torch.int32)
    # scatter the kept candidates to their rank; everything else lands in
    # the discarded row K
    dest = torch.where(keep, rank, K).to(torch.int64)
    w_out = torch.zeros((K + 1,) + w.shape[1:], dtype=w.dtype,
                        device=w.device)
    w_out.scatter_(0, dest, torch.where(keep, cand_w, 0.0))
    pay_out = torch.zeros((5, K + 1) + w.shape[1:], dtype=w.dtype,
                          device=w.device)
    pay_out.scatter_(1, dest.expand_as(cand),
                     torch.where(keep, cand, 0.0))
    pay_out = pay_out[:, :K]
    return (w_out[:K], pay_out[0], pay_out[1],
            [pay_out[2], pay_out[3], pay_out[4]], ndrop)


def _tri(cf, r: int):
    """Triangle weight at integer offset r (gx.inc); None outside support."""
    if r == -1:
        return 0.25 + cf * cf + cf
    if r == 0:
        return 1.5 - 2.0 * cf * cf
    if r == 1:
        return 0.25 + cf * cf - cf
    return None


def _w_sel(cf, o: int, base, base_vals):
    """Weight at offset ``o`` relative to the integer-valued ``base``,
    restricted to ``base_vals`` (binned_kernels.py:53)."""
    out = None
    for bv in base_vals:
        poly = _tri(cf, o - int(bv))
        if poly is None:
            continue
        term = torch.where(base == bv, poly, 0.0)
        out = term if out is None else out + term
    return torch.zeros_like(cf) if out is None else out


def gather_fields_binned(fpad, xi, plan):
    """The six field components at the particles (``binned.py:1448``,
    ``_gather6``): staggered triangle weights at the post-rebin positions
    ξ ∈ [−½, ½), so the unstaggered window is −1..1 and the staggered one
    −2..1.  ``fpad`` is the (6, nx+4, ny+4) stack of make_fpad."""
    nx, ny = plan.n
    cf1 = [-xi[d] for d in range(2)]
    c2 = [torch.floor(xi[d]) for d in range(2)]
    cf2 = [c2[d] - xi[d] + 0.5 for d in range(2)]
    gw = [{o: _tri(cf1[d], o) for o in (-1, 0, 1)} for d in range(2)]
    hw = [{o: _w_sel(cf2[d], o, c2[d], (-1.0, 0.0))
           for o in (-2, -1, 0, 1)} for d in range(2)]
    out = []
    for k, nm in enumerate(FIELD6):
        tabs = [hw[d] if STAGGER[nm][d] else gw[d] for d in range(2)]
        acc = torch.zeros_like(xi[0])
        for ox in sorted(tabs[0]):
            for oy in sorted(tabs[1]):
                win = fpad[k, 2 + ox:2 + ox + nx, 2 + oy:2 + oy + ny]
                acc = acc + tabs[0][ox] * tabs[1][oy] * win[None]
        out.append(plan.fac * acc)
    return out


def push_deposit_plain(fpad, b: BinnedSpecies, sp, plan, bc):
    """One step of one species on the slot grid — the plain version of the
    CUDA kernel (see the module docstring).  ``bc`` holds the four particle
    BC codes (x_lo, x_hi, y_lo, y_hi).  Returns the new species and the
    margin-padded current deposit jpad (3, nx+4, ny+4)."""
    PER = const.BC.PERIODIC
    if bc[2] != PER or bc[3] != PER:
        raise NotImplementedError("bounded y particle boundaries are not "
                                  "ported yet (a later slice)")
    periodic_x = bc[0] == PER and bc[1] == PER
    if (bc[0] == PER) != (bc[1] == PER):
        raise ValueError("x particle boundaries must be both periodic or "
                         "both bounded")
    nx, ny = plan.n
    q = float(sp.charge)
    part_mc = float(const.c * sp.mass)
    ipart_mc = float(1.0 / part_mc)
    cm = float(q * 0.5 * plan.dt * ipart_mc)
    ccm = float(cm * const.c)
    fx = float(const.c * plan.dt / 2.0 / plan.delta[0])
    fy = float(const.c * plan.dt / 2.0 / plan.delta[1])

    # ---- phase 1: half-drift + per-axis rebin ----
    w = b.w
    xi0, xi1 = b.xi[0], b.xi[1]
    p = [b.p[0], b.p[1], b.p[2]]
    alive = w > 0
    u0 = p[0] * ipart_mc
    u1 = p[1] * ipart_mc
    u2 = p[2] * ipart_mc
    igam = 1.0 / torch.sqrt(u0 * u0 + u1 * u1 + u2 * u2 + 1.0)
    xi0 = torch.where(alive, xi0 + u0 * igam * fx, xi0)
    xi1 = torch.where(alive, xi1 + u1 * igam * fy, xi1)
    ndrop = torch.zeros((), dtype=torch.int32, device=w.device)
    if not periodic_x:
        (xi0, xi1), p, w = apply_axis_bcs([xi0, xi1], p, w, plan, 0,
                                          bc[0], bc[1])
    w, xi0, xi1, p, ndrop = axis_rebin(w, xi0, xi1, p, 0, periodic_x, ndrop)
    w, xi0, xi1, p, ndrop = axis_rebin(w, xi0, xi1, p, 1, True, ndrop)

    # ---- phase 2: gather, Boris, move (ξ ∈ [−½, ½): c1 ≡ 0) ----
    alive = w > 0
    xi = [xi0, xi1]
    u = [p[c] * ipart_mc for c in range(3)]
    ex_p, ey_p, ez_p, bx_p, by_p, bz_p = gather_fields_binned(fpad, xi, plan)
    uxm = u[0] + cm * ex_p
    uym = u[1] + cm * ey_p
    uzm = u[2] + cm * ez_p
    igam = 1.0 / torch.sqrt(uxm * uxm + uym * uym + uzm * uzm + 1.0)
    rootb = ccm * igam
    tx = bx_p * rootb
    ty = by_p * rootb
    tz = bz_p * rootb
    tx2, ty2, tz2 = tx * tx, ty * ty, tz * tz
    tau = 1.0 / (1.0 + tx2 + ty2 + tz2)
    uxp = ((1 + tx2 - ty2 - tz2) * uxm
           + 2.0 * ((tx * ty + tz) * uym + (tx * tz - ty) * uzm)) * tau
    uyp = ((1 - tx2 + ty2 - tz2) * uym
           + 2.0 * ((ty * tz + tx) * uzm + (ty * tx - tz) * uxm)) * tau
    uzp = ((1 - tx2 - ty2 + tz2) * uzm
           + 2.0 * ((tz * tx + ty) * uxm + (tz * ty - tx) * uym)) * tau
    ux = uxp + cm * ex_p
    uy = uyp + cm * ey_p
    uz = uzp + cm * ez_p
    igam = 1.0 / torch.sqrt(ux * ux + uy * uy + uz * uz + 1.0)
    rootc = const.c * igam
    uvec = (ux, uy, uz)
    delta = [uvec[d] * rootc * float(plan.dto2 / plan.delta[d])
             for d in range(2)]
    vz = uz * rootc
    xi_new = [xi[d] + delta[d] for d in range(2)]
    p_new = [ux * part_mc, uy * part_mc, uz * part_mc]

    # ---- phase 3: PSC charge-conserving deposit at t+1.5dt ----
    W = len(OFFSETS)
    live_w = torch.where(alive, w, 0.0)
    xi_dep = [xi_new[d] + delta[d] for d in range(2)]
    c3 = [torch.clamp(torch.floor(x + 0.5), -1.0, 1.0) for x in xi_dep]
    cf3 = [c3[d] - xi_dep[d] for d in range(2)]
    cf1 = [-xi[d] for d in range(2)]
    zero = torch.zeros_like(cf1[0])
    gx5 = [[(_tri(cf1[d], o) if abs(o) <= 1 else zero) for o in OFFSETS]
           for d in range(2)]
    hx5 = [[_w_sel(cf3[d], o, c3[d], (-1.0, 0.0, 1.0)) for o in OFFSETS]
           for d in range(2)]
    dxw = [[hx5[d][k] - gx5[d][k] for k in range(W)] for d in range(2)]
    dcum = []
    for d in range(2):
        run = [dxw[d][0]]
        for k in range(1, W):
            run.append(run[-1] + dxw[d][k])
        dcum.append(run)
    fjx = plan.fj[0] * live_w * q
    fjy = plan.fj[1] * live_w * q
    fjz = plan.fj[2] * live_w * q
    third = 1.0 / 3.0
    xfac1 = [gx5[0][k] + 0.5 * dxw[0][k] for k in range(W)]
    yfac1 = [gx5[1][k] + 0.5 * dxw[1][k] for k in range(W)]
    yfac2 = [third * dxw[1][k] + 0.5 * gx5[1][k] for k in range(W)]
    fz = fjz * vz
    xjx = [-fjx * dcum[0][k] for k in range(W - 1)]
    yjy = [-fjy * dcum[1][k] for k in range(W - 1)]
    fzg = {k: fz * gx5[0][k] for k in range(1, W - 1)}
    fzd = [fz * dxw[0][k] for k in range(W)]
    jpad = torch.zeros((3, nx + 2 * M, ny + 2 * M), dtype=w.dtype,
                       device=w.device)
    for ki in range(W):
        for kj in range(W):
            xs = slice(OFFSETS[ki] + M, OFFSETS[ki] + M + nx)
            ys = slice(OFFSETS[kj] + M, OFFSETS[kj] + M + ny)
            # the full-window running sum dcum[W-1] is identically zero:
            # the last x-offset deposits no jx, the last y-offset no jy
            if ki < W - 1:
                jpad[0, xs, ys] += torch.sum(xjx[ki] * yfac1[kj], dim=0)
            if kj < W - 1:
                jpad[1, xs, ys] += torch.sum(xfac1[ki] * yjy[kj], dim=0)
            if ki in fzg:
                jpad[2, xs, ys] += torch.sum(fzg[ki] * yfac1[kj], dim=0)
            jpad[2, xs, ys] += torch.sum(fzd[ki] * yfac2[kj], dim=0)

    # ---- end-of-push particle boundaries (after the deposit) ----
    w_out = w
    if not periodic_x:
        _, _, w_out = apply_axis_bcs(xi_new, p_new, w, plan, 0, bc[0], bc[1])
    xi_out = torch.stack([torch.where(alive, xi_new[d], xi[d])
                          for d in range(2)])
    p_out = torch.stack([torch.where(alive, p_new[c], p[c])
                         for c in range(3)])
    out = dataclasses.replace(b, xi=xi_out, p=p_out, w=w_out,
                              n_dropped=b.n_dropped + ndrop)
    return out, jpad
