"""Kernel B's plain version (epoch_tpu_torch.core.binned.push_deposit_plain,
reached through ops.binned_kernels.binned_push on CPU tensors) against the
reference's fused Pallas kernel (PallasBinned, interpret mode) on a 16×8
slot grid, from the same slots and fields, in float64.

Tolerances: w slot for slot exactly; on live slots xi to 1e-12 cell widths
and p to 1e-12·max|p|; J to 1e-12·max|J|; the dropped counter exactly.
(The reference leaves stale payloads in empty slots, the port zeros, so
xi and p are compared where w > 0.)"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import epoch_tpu.constants as rconst
from epoch_tpu.core import binned as rbin
from epoch_tpu.core.config import SimConfig as RefSimConfig
from epoch_tpu.core.config import SpeciesConfig as RefSpeciesConfig
from epoch_tpu.core.grid import Grid as RefGrid
from epoch_tpu_torch import constants as const
from epoch_tpu_torch.core import binned as binmod
from epoch_tpu_torch.core.config import SimConfig, SpeciesConfig
from epoch_tpu_torch.core.grid import Grid
from epoch_tpu_torch.core.state import BinnedSpecies
from epoch_tpu_torch.ops.binned_kernels import binned_push

N = (16, 8)
DX = 1e-6


def _configs(bc_x, K):
    nd = 2
    dt = 0.9 * DX / (const.c * np.sqrt(nd))
    hi = tuple(n * DX for n in N)
    rgrid = RefGrid(ndims=nd, shape_fn=rconst.Shape.TRIANGLE, n=N,
                    cpml_thickness=0, cpml_active=(False,) * 4,
                    lo=(0.0, 0.0), hi=hi)
    rbc = (rconst.BC(int(bc_x)),) * 2 + (rconst.BC.PERIODIC,) * 4
    rsp = RefSpeciesConfig(name="e", charge=-const.q0, mass=const.m0,
                           cap=512, bc_particle=rbc)
    rcfg = RefSimConfig(grid=rgrid, dt=dt, t_end=1.0, nsteps=-1,
                        bc_field=(rconst.BC.PERIODIC,) * 6,
                        bc_particle=(rconst.BC.PERIODIC,) * 6,
                        species=(rsp,), lasers=(), dtype=np.float64)
    rcfg = dataclasses.replace(rcfg, bin_k=K)
    grid = Grid(ndims=nd, shape_fn=const.Shape.TRIANGLE, n=N,
                cpml_thickness=0, cpml_active=(False,) * 4,
                lo=(0.0, 0.0), hi=hi)
    bc = (bc_x, bc_x, const.BC.PERIODIC, const.BC.PERIODIC)
    sp = SpeciesConfig(name="e", charge=-const.q0, mass=const.m0,
                       bc_particle=bc + (const.BC.PERIODIC,) * 2)
    cfg = SimConfig(grid=grid, dt=dt, t_end=1.0, nsteps=-1,
                    bc_field=(const.BC.PERIODIC,) * 6,
                    bc_particle=(const.BC.PERIODIC,) * 6, species=(sp,),
                    lasers=(), dtype=torch.float64, bin_k=K)
    return rcfg, rgrid, cfg, sp, bc


def _inputs(rgrid, K, ppc, seed):
    rng = np.random.default_rng(seed)
    NP = int(ppc * np.prod(N))
    x0 = np.stack([rng.uniform(0, rgrid.hi[d], NP) for d in range(2)], 1)
    p0 = rng.normal(scale=3e-22, size=(NP, 3))      # |u| ~ 1: relativistic
    w0 = rng.uniform(1, 2, NP)
    bm = rbin.bin_from_arrays(x0, p0, w0, rgrid, K=K)
    e = rng.normal(size=(3,) + N) * 1e11
    b = rng.normal(size=(3,) + N) * 3e2
    fpad = np.pad(np.concatenate([e, b]), ((0, 0), (2, 2), (2, 2)),
                  mode="wrap")
    return bm, fpad


def _compare(rb, rjpad, b, jpad, step):
    w_ref = np.asarray(rb.w)
    w = b.w.numpy()
    np.testing.assert_array_equal(w, w_ref, err_msg=f"w, step {step}")
    live = w_ref > 0
    xi_ref = np.asarray(rb.xi)
    assert np.abs(np.where(live, b.xi.numpy() - xi_ref, 0)).max() <= 1e-12
    p_ref = np.asarray(rb.p)
    pscale = np.abs(p_ref[:, live]).max()
    assert np.abs(np.where(live, b.p.numpy() - p_ref, 0)).max() \
        <= 1e-12 * pscale
    rjpad = np.asarray(rjpad)
    jscale = np.abs(rjpad).max()
    assert jscale > 0
    assert np.abs(jpad.numpy() - rjpad).max() <= 1e-12 * jscale, step
    assert int(b.n_dropped) == int(rb.n_dropped), step


@pytest.fixture(scope="module")
def ref_engines():
    """Interpret-mode Pallas engines by (x boundary, K), built once per
    module: compiling one costs ~20 s on the CPU, and the overflow case
    reuses the periodic case's kernel."""
    return {}


def _ref_engine(ref_engines, rcfg, bc_x, K, monkeypatch):
    key = (int(bc_x), K)
    if key not in ref_engines:
        # one row block per stripe: the smallest interpret-mode program
        monkeypatch.setenv("EPOCH_TPU_ROW_BLOCK", str(K))
        rplan = rbin.BinnedPlan(rcfg)
        eng = rbin.make_pallas_engines(rcfg, rplan, interpret=True)[0]
        assert eng is not None and eng.BX < N[0]
        ref_engines[key] = (eng, rplan)
    return ref_engines[key]


@pytest.mark.parametrize("bc_name,ppc", [("periodic", 1), ("open", 1),
                                         ("overflow", 8)])
def test_plain_push_matches_pallas_kernel(bc_name, ppc, ref_engines,
                                          monkeypatch):
    K = 8
    bc_x = const.BC.OPEN if bc_name == "open" else const.BC.PERIODIC
    rcfg, rgrid, cfg, sp, bc = _configs(bc_x, K)
    eng, rplan = _ref_engine(ref_engines, rcfg, bc_x, K, monkeypatch)
    plan = binmod.BinnedPlan(cfg)
    bm, fpad_np = _inputs(rgrid, K, ppc, seed=3)
    fpad_j = jnp.asarray(fpad_np)
    fwin = eng.make_fwin(fpad_j)
    fpad = torch.tensor(fpad_np)
    b = BinnedSpecies(xi=torch.tensor(np.asarray(bm.xi)),
                      p=torch.tensor(np.asarray(bm.p)),
                      w=torch.tensor(np.asarray(bm.w)),
                      n_dropped=torch.tensor(int(bm.n_dropped),
                                             dtype=torch.int32))
    rb = bm
    launches = binned_push.launches
    n_live0 = int((np.asarray(bm.w) > 0).sum())
    for step in range(2):
        rb, jpart = rbin.push_deposit_pallas(eng, fwin, rb, rplan)
        rjpad = eng.fold_jpart(jpart)
        b, jpad = binned_push(fpad, b, sp, plan, bc)
        _compare(rb, rjpad, b, jpad, step)
    assert binned_push.launches == launches      # CPU: the plain version
    n_live = int((b.w > 0).sum())
    if bc_name == "open":
        assert n_live < n_live0                   # particles left through x
    if bc_name == "overflow":
        assert int(b.n_dropped) > int(bm.n_dropped)   # the rebin dropped
    else:
        assert int(b.n_dropped) == 0


def test_fold_margins_matches_reference():
    rcfg, rgrid, cfg, sp, bc = _configs(const.BC.PERIODIC, 4)
    rng = np.random.default_rng(5)
    jpad = rng.normal(size=(3, N[0] + 4, N[1] + 4))
    ref = rbin.fold_margins(jnp.asarray(jpad), rbin.BinnedPlan(rcfg))
    got = binmod.fold_margins(torch.tensor(jpad), binmod.BinnedPlan(cfg))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-14)
