"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface; it is compiled with
``nvcc`` into ``build/kernels/lib<name>-<hash>.so`` beside the package and
loaded with ``ctypes``.  The hash covers the source and the flags, so an
edited source rebuilds and an unchanged one is reused.  Nothing is built
when a module is imported: the first wrapper call on a CUDA tensor (or
``build_all``) builds, all missing libraries at once, one ``nvcc`` process
per source started together.

The sources are compiled with ``-fmad=false``: every product and sum then
rounds as PyTorch's elementwise operations do, which lets the kernels
reproduce their plain versions (see each source's note).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG.parent / "build" / "kernels"
SOURCES = ("field_half", "binned_push")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{h}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, in parallel.  Returns
    {name: (seconds, compiler log)} for the sources it built; raises with
    the compiler's output when one fails."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    report = {}
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        report[n] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build_all((name,))
    return ctypes.CDLL(str(_lib_path(name)))


def check(err: int, what: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
