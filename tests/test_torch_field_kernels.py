"""Kernel A's plain version (epoch_tpu_torch.core.fields, reached through
ops.field_kernels.field_half on CPU tensors) against the reference: the
Pallas kernel make_field_half_kernel in interpret mode and the XLA path
fields.update_e_field / update_b_field, for both halves, with and without
CPML, in float64.  Tolerance: max|Δ| ≤ 1e-12·max|field|."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from epoch_tpu.core import fields as ref_fld
from epoch_tpu.core.sim import build_config as ref_build_config
from epoch_tpu.core.state import CPMLState as RefCPML
from epoch_tpu.core.state import Fields as RefFields
from epoch_tpu.deck import load_deck as ref_load_deck
from epoch_tpu.ops.field_kernels import make_field_half_kernel
from epoch_tpu_torch.core import fields as fld
from epoch_tpu_torch.core.sim import build_config
from epoch_tpu_torch.core.state import CPMLState, Fields
from epoch_tpu_torch.deck import load_deck
from epoch_tpu_torch.deck.flagship import lwfa_static_deck
from epoch_tpu_torch.ops.field_kernels import field_half

NAMES = ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz")


def _deck(tmp_path, cpml, order):
    text = lwfa_static_deck(nx=36, ny=16, ppc=1, precision="double")
    text = text.replace("nx = 36", f"nx = 36\n  field_order = {order}")
    if not cpml:
        text = text.replace("cpml_laser", "periodic").replace(
            "cpml_outflow", "periodic")
    p = tmp_path / "input.deck"
    p.write_text(text)
    return str(p)


@pytest.mark.parametrize("cpml,order", [(True, 2), (False, 2), (False, 4),
                                        (True, 6)])
def test_field_half_matches_reference(tmp_path, cpml, order):
    path = _deck(tmp_path, cpml, order)
    rcfg = ref_build_config(ref_load_deck(path))
    cfg = build_config(load_deck(path))
    assert cfg.any_cpml == rcfg.any_cpml == cpml
    assert cfg.dt == rcfg.dt
    rplan = ref_fld.FieldSolverPlan(rcfg)
    plan = fld.FieldSolverPlan(cfg, "cpu")
    rng = np.random.default_rng(7)
    shape = cfg.grid.padded_shape()
    vals = {nm: rng.normal(size=shape) * 1e3 for nm in NAMES}
    psi = [rng.normal(size=(4,) + shape) for _ in range(2)]
    rf = RefFields(**{nm: jnp.asarray(v) for nm, v in vals.items()})
    f = Fields(**{nm: torch.tensor(v) for nm, v in vals.items()})
    rc = RefCPML(psi=tuple(jnp.asarray(p) for p in psi)) if cpml else None
    c = CPMLState(psi_e=torch.tensor(psi[0]),
                  psi_b=torch.tensor(psi[1])) if cpml else None

    for which in ("e", "b"):
        kern = make_field_half_kernel(rcfg, rplan, which, interpret=True)
        rk_f, rk_c = kern(rf, rc)
        upd = ref_fld.update_e_field if which == "e" \
            else ref_fld.update_b_field
        rx_f, rx_c = upd(rf, rcfg, rplan, rc)
        launches = field_half.launches
        got_f, got_c = field_half(which, f, plan, c)
        assert field_half.launches == launches      # CPU: plain version
        comps = ("ex", "ey", "ez") if which == "e" else ("bx", "by", "bz")
        for nm in comps:
            g = getattr(got_f, nm).numpy()
            for ref in (getattr(rk_f, nm), getattr(rx_f, nm)):
                ref = np.asarray(ref)
                scale = np.abs(ref).max()
                assert np.abs(g - ref).max() <= 1e-12 * scale, (which, nm)
        if cpml:
            k = 0 if which == "e" else 1
            g = (got_c.psi_e if which == "e" else got_c.psi_b).numpy()
            for ref in (rk_c.psi[k], rx_c.psi[k]):
                ref = np.asarray(ref)
                assert np.abs(g - ref).max() <= 1e-12 * np.abs(ref).max()
        # the input state is left untouched
        for nm in NAMES:
            np.testing.assert_array_equal(getattr(f, nm).numpy(), vals[nm])


def test_field_half_refuses_float64_on_cuda_before_launch():
    """A CUDA tensor always goes to the kernel, which takes float32 only:
    the wrapper's checks refuse float64 (shown on the check itself, which
    runs before any CUDA call)."""
    from epoch_tpu_torch.ops.field_kernels import _check
    t = torch.zeros((4, 4), dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        _check(t, "ex", (4, 4), t.device)
