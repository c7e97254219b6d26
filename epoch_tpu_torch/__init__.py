"""epoch_tpu_torch — the PyTorch/CUDA port of the epoch_tpu PIC engine.

The package mirrors ``epoch_tpu``'s layout (``core/``, ``deck/``, ``ops/``)
so each module has a named counterpart, and runs on an NVIDIA H100: plain
tensor code is PyTorch, and every Pallas kernel of the reference on the
ported path is a hand-written CUDA kernel under ``csrc/`` (built with
``nvcc`` at first use, bound with ``ctypes``).  It imports ``torch`` and
numpy, never ``jax`` and nothing of ``epoch_tpu``.

Entry point: ``epoch_tpu_torch.core.sim.Simulation(deck_path, seed=0,
device=None)`` — ``device=None`` means CUDA; only an explicit
``device="cpu"`` runs the plain PyTorch versions on the host.
"""

__version__ = "0.1.0"
