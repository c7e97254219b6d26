"""The port's deck front end (epoch_tpu_torch.deck) against epoch_tpu.deck:
the flagship static-box deck and a set of expressions parse to the same
numbers, and the blocks this slice does not run are refused."""
import numpy as np
import pytest

from epoch_tpu.deck import load_deck as ref_load_deck
from epoch_tpu.deck.expr import Expression as RefExpression
from epoch_tpu_torch.deck import load_deck
from epoch_tpu_torch.deck.expr import Expression
from epoch_tpu_torch.deck.flagship import lwfa_static_deck


def _write(tmp_path, text, name="input.deck"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def test_flagship_deck_parses_like_reference(tmp_path):
    path = _write(tmp_path, lwfa_static_deck())
    ref = ref_load_deck(path)
    got = load_deck(path)
    for key in ("nx", "ny", "x_min", "x_max", "y_min", "y_max", "t_end",
                "nsteps", "dt_multiplier", "field_order", "precision",
                "bin_headroom"):
        assert getattr(got.control, key) == getattr(ref.control, key), key
    assert [int(b) for b in got.boundaries.bc_field] == \
        [int(b) for b in ref.boundaries.bc_field]
    assert [int(b) for b in got.boundaries.bc_particle] == \
        [int(b) for b in ref.boundaries.bc_particle]
    assert got.boundaries.cpml_thickness == ref.boundaries.cpml_thickness
    assert got.ndims == ref.ndims == 2

    # the species' densities and temperatures on a grid of points
    x = np.linspace(0.0, 372 * 5e-8, 97)
    X, Y = np.meshgrid(x, x, indexing="ij")
    ctx = {"x": X, "y": Y, "time": 0.0}
    assert len(got.species) == len(ref.species) == 2
    for sg, sr in zip(got.species, ref.species):
        assert sg.name == sr.name
        assert sg.charge == sr.charge and sg.mass == sr.mass
        assert sg.npart_per_cell == sr.npart_per_cell
        assert [int(b) for b in sg.bc_particle] == \
            [int(b) for b in sr.bc_particle]
        np.testing.assert_array_equal(sg.density(ctx), sr.density(ctx))
        for tg, tr in zip(sg.temp, sr.temp):
            assert float(tg(ctx)) == float(tr(ctx))

    # the laser: amplitude, frequency, envelope and transverse profile
    assert len(got.lasers) == len(ref.lasers) == 1
    lg, lr = got.lasers[0], ref.lasers[0]
    assert (lg.boundary, lg.amp, lg.omega, lg.pol_angle, lg.t_start,
            lg.t_end) == (lr.boundary, lr.amp, lr.omega, lr.pol_angle,
                          lr.t_start, lr.t_end)
    for t in (0.0, 20e-15, 40e-15, 77e-15):
        assert float(lg.t_profile({"time": t})) == \
            float(lr.t_profile({"time": t}))
    np.testing.assert_array_equal(lg.profile({"y": x}), lr.profile({"y": x}))
    assert len(got.outputs) == 1 and got.outputs[0].dt_snapshot == 1.0


@pytest.mark.parametrize("text", [
    "1 + 2 * 3 - 4 / 2",
    "-2^2",
    "2 ^ 3 ^ 2",
    "3e2 * 2",
    "1.5 e 3",
    "2.0 * pi * c / 1.0e-6",
    "if(x gt 0.3, 1.0e24, 0)",
    "gauss(time, 40e-15, 20e-15)",
    "gauss(y, 0.5, 0.25) * exp(-x)",
    "(x lt 0.5) and (time gt 1e-15) or (x eq 0)",
    "sqrt(abs(sin(x) - cos(y))) + floor(x * 7) + ln(1 + x) + log10(2)",
    "10 * ev / kb",
])
def test_expressions_match_reference(text):
    x = np.linspace(0.0, 1.0, 11)
    ctx = {"x": x, "y": x[::-1].copy(), "time": 2e-15}
    got = Expression.compile(text)(ctx)
    ref = RefExpression.compile(text)(ctx)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_window_block_is_refused(tmp_path):
    text = lwfa_static_deck().replace("begin:constant", """begin:window
  move_window = T
  window_start_time = 50e-15
  window_v_x = 2.9979e8
end:window
begin:constant""", 1)
    with pytest.raises(NotImplementedError, match="window"):
        load_deck(_write(tmp_path, text))


@pytest.mark.parametrize("extra", [
    "begin:collisions\n  use_collisions = T\nend:collisions\n",
    "begin:fields\n  ex = 1\nend:fields\n",
])
def test_later_blocks_are_refused(tmp_path, extra):
    with pytest.raises(NotImplementedError):
        load_deck(_write(tmp_path, lwfa_static_deck() + extra))


def test_unsupported_key_is_refused(tmp_path):
    text = lwfa_static_deck().replace("bin_headroom = 2.0",
                                      "smooth_currents = T", 1)
    with pytest.raises(NotImplementedError, match="smooth_currents"):
        load_deck(_write(tmp_path, text))
