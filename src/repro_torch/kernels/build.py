"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/<name>-<hash>.so`` at the root of the
checkout (``.gitignore`` lists ``build/``) and loaded with ``ctypes``: a
few seconds per source, against minutes for an extension that includes
PyTorch's headers. The file name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library is never loaded.
A failed build raises; nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float          # nvcc wall time; 0.0 when the library existed
    log: str                # nvcc's output (ptxas registers / spills)


_built: Dict[str, Built] = {}
_lock = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built from source at first use")


def sources() -> list:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (target, process or None, start time)."""
    out = _target(name)
    if out.exists():
        return out, None, time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc, time.perf_counter()


def _finish(name: str, out: Path, proc, t0: float) -> Built:
    log, seconds = "", 0.0
    if proc is not None:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)          # atomic: a racing build loads whole
    return Built(ctypes.CDLL(str(out)), out, seconds, log)


def build_all(names: Iterable[str] = None) -> Dict[str, Built]:
    """Build (in parallel, one nvcc per source, all started together) and
    load every kernel not yet loaded in this process."""
    names = list(names or sources())
    with _lock:
        todo = [n for n in names if n not in _built]
        started = [(n, *_start(n)) for n in todo]
        for n, out, proc, t0 in started:
            _built[n] = _finish(n, out, proc, t0)
        return {n: _built[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    with _lock:
        hit = _built.get(name)
    if hit is not None:
        return hit.lib
    return build_all([name])[name].lib
