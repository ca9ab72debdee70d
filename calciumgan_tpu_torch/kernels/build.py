"""Build the port's native code at first use and load it with ``ctypes``.

- :func:`load` compiles ``csrc/<name>.cu`` with ``nvcc`` for Hopper only
  (``sm_90a``);
- :func:`load_host` compiles a host C++ source with ``g++`` (the float64
  OASIS redo, ``csrc/oasis_host.cc``).

Each source compiles on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). Libraries go to
``build/kernels/`` at the root of the checkout, named by a hash of the
sources and the flags, so a changed source rebuilds and a fresh checkout
builds from its own sources. Nothing here runs at import: this module
imports on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no contracted multiply-adds: products and sums round as the plain
    # PyTorch twins' do
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into the log
)
# no -fopenmp: a toolchain without libgomp must build it too (callers
# spread rows over threads instead); no contracted multiply-adds, so the
# float64 arithmetic rounds as numpy's does
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-ffp-contract=off",
             "-shared", "-fPIC")


@dataclasses.dataclass
class Built:
    lib: ctypes.CDLL
    path: str
    seconds: float  # compiler wall time in this process; 0.0 if built earlier
    log: str        # compiler output of the build


_loaded: Dict[str, Built] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of calciumgan_tpu_torch are built "
            "from source at first use")
    return found


def gxx() -> str:
    found = shutil.which(os.environ.get("CXX") or "g++")
    if found is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH")
    return found


def _digest(flags: Sequence[str], sources: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(sources):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _compile(name: str, command: Sequence[str], flags: Sequence[str],
             src: Path, deps: Sequence[Path]) -> Built:
    """The library ``lib<name>-<hash>.so``, compiling ``src`` with
    ``command + flags`` unless this checkout already has it."""
    if name in _loaded:
        return _loaded[name]
    so = BUILD_DIR / f"lib{name}-{_digest(flags, deps)}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        start = time.perf_counter()
        proc = subprocess.run([*command, *flags, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - start
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{command[0]} failed to build {src}:\n{log}")
        log_path.write_text(log)
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half
    log = log_path.read_text() if log_path.exists() else ""
    built = Built(ctypes.CDLL(str(so)), str(so), seconds, log)
    _loaded[name] = built
    return built


def load(name: str) -> Built:
    """The library built from ``csrc/<name>.cu`` by ``nvcc`` (keyed on every
    file in ``csrc/``)."""
    return _compile(name, [nvcc()], NVCC_FLAGS, CSRC / f"{name}.cu",
                    list(CSRC.iterdir()))


def load_host(name: str, src: Path) -> Built:
    """The library built from the host C++ file ``src`` by ``g++``."""
    return _compile(name, [gxx()], GXX_FLAGS, src, [src])
