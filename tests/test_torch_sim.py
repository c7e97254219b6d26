"""The slice end to end on the CPU: the flagship static-box deck, shrunk to
40×16 user cells (52×28 with the CPML; the reference pads its slot grid to
56 columns, which the bridge drops) at 2 particles per cell in double
precision, run 10 steps by the reference (fused Pallas kernels in
interpret mode) and by the port (plain versions) from one bridged state.

Tolerances: fields, J and the CPML psi to 1e-10·max|field|; slot weights
slot for slot exactly; positions (cell units) and momenta on live slots to
1e-10 (relative to max|p| for p); dropped counters exactly.  The loader,
whose random streams differ by construction, is checked statistically."""
import numpy as np
import torch

from epoch_tpu.core import Simulation as RefSimulation
from epoch_tpu.core import loader as ref_loader
from epoch_tpu.core.sim import build_config as ref_build_config
from epoch_tpu.deck import load_deck as ref_load_deck
from epoch_tpu_torch import constants as const
from epoch_tpu_torch.core import bridge, loader
from epoch_tpu_torch.core.sim import Simulation, build_config
from epoch_tpu_torch.deck import load_deck
from epoch_tpu_torch.deck.flagship import lwfa_static_deck

FIELDS = ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz")


def reference_arrays(st):
    """The reference SimState's leaves as the bridge's numpy dict."""
    out = {f"fields/{nm}": np.asarray(getattr(st.fields, nm))
           for nm in FIELDS}
    if st.cpml is not None:
        out["cpml/psi_e"] = np.asarray(st.cpml.psi[0])
        out["cpml/psi_b"] = np.asarray(st.cpml.psi[1])
    for i, b in enumerate(st.species):
        out[f"species/{i}/w"] = np.asarray(b.w)
        out[f"species/{i}/xi"] = np.asarray(b.xi)
        out[f"species/{i}/p"] = np.asarray(b.p)
        out[f"species/{i}/n_dropped"] = int(b.n_dropped)
    for k, v in st.bc_fields.items():
        out[f"bc_fields/{k}"] = np.asarray(v)
    out["lasers/integral_phase"] = np.asarray(st.lasers.integral_phase)
    out["time"] = float(st.time)
    out["step"] = int(st.step)
    return out


def _deck(tmp_path, ppc=2):
    p = tmp_path / "input.deck"
    p.write_text(lwfa_static_deck(nx=40, ny=16, ppc=ppc,
                                  precision="double"))
    return str(p)


def test_ten_steps_match_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("EPOCH_TPU_PALLAS", "interpret")
    monkeypatch.setenv("EPOCH_TPU_FUSED_FIELDS", "interpret")
    # one row block per stripe (K = 6 here): the smallest interpret program
    monkeypatch.setenv("EPOCH_TPU_ROW_BLOCK", "6")
    path = _deck(tmp_path)
    ref = RefSimulation(path, seed=3)
    assert ref.cfg.engine == "binned"
    sim = Simulation(path, seed=3, device="cpu")
    assert sim.cfg.dt == ref.cfg.dt
    assert sim.cfg.bin_k_sp == tuple(ref.cfg.bin_k_sp)
    sim.state = bridge.state_from_numpy(reference_arrays(ref.state),
                                        sim.cfg, "cpu")
    ref_st = ref.run(max_steps=10)
    st = sim.run(max_steps=10)
    a = reference_arrays(ref_st)
    b = bridge.state_to_numpy(st)
    assert b["step"] == a["step"] == 10
    assert b["time"] == a["time"]
    assert np.abs(a["fields/ey"]).max() > 0          # the laser is in
    for k in [f"fields/{nm}" for nm in FIELDS] + ["cpml/psi_e", "cpml/psi_b"]:
        scale = np.abs(a[k]).max()
        assert np.abs(b[k] - a[k]).max() <= 1e-10 * scale, k
    nx = sim.cfg.grid.n[0]
    for i in range(2):
        w_ref = a[f"species/{i}/w"][:, :nx]
        np.testing.assert_array_equal(b[f"species/{i}/w"], w_ref)
        live = w_ref > 0
        assert live.sum() > 0
        dxi = b[f"species/{i}/xi"] - a[f"species/{i}/xi"][:, :, :nx]
        assert np.abs(np.where(live, dxi, 0)).max() <= 1e-10
        p_ref = a[f"species/{i}/p"][:, :, :nx]
        dp = np.where(live, b[f"species/{i}/p"] - p_ref, 0)
        assert np.abs(dp).max() <= 1e-10 * np.abs(p_ref[:, live]).max()
        assert b[f"species/{i}/n_dropped"] == a[f"species/{i}/n_dropped"]


def test_loader_statistics(tmp_path):
    """Per-cell counts equal the reference's; weights of cells inside the
    plasma equal density·volume/ppc; per species and axis the mean momentum
    lies within 4σ of zero and the temperature within 4σ of the deck's."""
    path = _deck(tmp_path, ppc=8)
    cfg = build_config(load_deck(path))
    rcfg = ref_build_config(ref_load_deck(path))
    grid = cfg.grid
    gen = torch.Generator().manual_seed(5)
    rng = np.random.default_rng(5)
    for sp, rsp, t_ev in zip(cfg.deck.species, rcfg.deck.species, (10, 1)):
        arrs = loader.load_species(sp, grid, gen)
        rarrs, _ = ref_loader.load_species(rsp, rcfg.grid, rng, np.float64)
        x = arrs["x"].numpy()
        cells = [np.floor((x[:, d] - grid.grid_min(d)) / grid.delta[d]
                          + 0.5).astype(int) for d in range(2)]
        rcells = [np.floor((rarrs["x"][:, d] - grid.grid_min(d))
                           / grid.delta[d] + 0.5).astype(int)
                  for d in range(2)]
        counts = np.zeros(grid.n, int)
        np.add.at(counts, tuple(cells), 1)
        rcounts = np.zeros(grid.n, int)
        np.add.at(rcounts, tuple(rcells), 1)
        np.testing.assert_array_equal(counts, rcounts)

        w = arrs["weight"].numpy()
        # cells whose whole interpolation window lies in the plasma (the
        # window wraps periodically at the x edges)
        first = int(counts.any(axis=1).argmax())
        deep = (cells[0] >= first + 2) & (cells[0] <= grid.n[0] - 3)
        np.testing.assert_allclose(w[deep], 1e24 * grid.cell_volume / 8,
                                   rtol=1e-12)

        p = arrs["p"].numpy()
        n = p.shape[0]
        sigma = np.sqrt(t_ev * const.ev / const.kb * const.kb * sp.mass)
        for i in range(3):
            assert abs(p[:, i].mean()) <= 4 * sigma / np.sqrt(n)
            var = p[:, i].var()
            assert abs(var - sigma ** 2) <= 4 * sigma ** 2 * np.sqrt(2 / n)
