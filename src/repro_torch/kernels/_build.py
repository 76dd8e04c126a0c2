"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface, compiled
for ``sm_90a`` into a shared library under ``_build/`` (listed in
``.gitignore``) at first use. The library name carries a hash of the
sources and flags, so an edited source is rebuilt, never loaded stale.
:func:`build` starts one ``nvcc`` per missing library, all at once, and
waits for them together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# -fmad=false: no multiply-add contraction, so a kernel's float32 math
# rounds exactly where its eager PyTorch version rounds.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register / shared-memory report) per kernel
BUILD_LOG: dict[str, str] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, else /usr/local/cuda/bin, else PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _library(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile every named kernel whose library is missing, in parallel.

    Returns {name: library path}. Raises with nvcc's output on failure.
    """
    libs = {n: _library(n) for n in names}
    todo = {n: p for n, p in libs.items() if not p.exists()}
    if not todo:
        return libs
    BUILD_DIR.mkdir(exist_ok=True)
    # nvcc's intermediates stay inside the build directory
    env = dict(os.environ, TMPDIR=str(BUILD_DIR))
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True,
                                     env=env), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[n] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu:\n{log}")
        else:
            os.replace(tmp, libs[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build(name)[name]))
    return lib
