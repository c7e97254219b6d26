"""Rules of the port's package: it imports neither jax nor epoch_tpu, and its
entry point runs on the card unless the caller asks for the CPU."""
import re
from pathlib import Path

import pytest
import torch

from epoch_tpu_torch.core.sim import Simulation
from epoch_tpu_torch.deck.flagship import lwfa_static_deck

ROOT = Path(__file__).resolve().parent.parent
IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|epoch_tpu)(?:\.|\s|,|$)",
                    re.MULTILINE)


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "epoch_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        hits = IMPORT.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


def test_simulation_without_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "input.deck"
    path.write_text(lwfa_static_deck(nx=36, ny=16, ppc=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(str(path))
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(str(path), device="cuda")
    sim = Simulation(str(path), device="cpu")
    assert sim.state.fields.ex.device.type == "cpu"
