"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface, compiled
for ``sm_90a`` into a shared library under ``_build/`` (listed in
``.gitignore``) at first use. A program of the fused stencil kernel with
an expression stage gets a library of its own: ``csrc/stencil_pipeline.cu``
with the program's generated fragment (``kernels/expr_codegen.py``) at its
``STENCIL_EXPR`` hook and only the one instantiation the program
launches (:func:`expr_library`). A library's name carries a hash of the
sources, the flags and, for a program's own, the fragment and the
instantiation, so an edited source is rebuilt, never loaded stale, and
an equal program loads the library already on disk. :func:`build_all`
runs one ``nvcc`` per missing library, at most one per CPU at once, and
waits for them together; a lock per library keeps two threads from
building the same one. A library that failed to build is not built
again in the same process: its load raises nvcc's output at once.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# -fmad=false: no multiply-add contraction, so a kernel's float32 math
# rounds exactly where its eager PyTorch version rounds.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# loaded libraries, by Library.name
_LIBS: dict[str, ctypes.CDLL] = {}
# per library built in this process: nvcc's output (ptxas register /
# shared-memory report)
BUILD_LOG: dict[str, str] = {}
# per library whose build failed in this process: the error it raises
_FAILED: dict[str, str] = {}

_LOCKS: dict[str, threading.RLock] = {}
_LOCKS_GUARD = threading.Lock()


@dataclasses.dataclass(frozen=True)
class Library:
    """One shared library: ``name`` keys :data:`BUILD_LOG`, ``path`` is
    the library, ``source`` the file nvcc compiles, ``files`` generated
    (path, text) pairs written first."""
    name: str
    path: Path
    source: Path
    files: tuple[tuple[Path, str], ...] = ()


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


def _digest(*extra: bytes) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    for e in extra:
        h.update(len(e).to_bytes(8, "little"))
        h.update(e)
    return h.hexdigest()[:16]


def kernel_library(name: str) -> Library:
    """The library of kernel ``csrc/<name>.cu``."""
    return Library(name, BUILD_DIR / f"lib{name}-{_digest()}.so",
                   CSRC / f"{name}.cu")


def expr_library(fragment: str, temporal: bool, prefetch: bool) -> Library:
    """The library of a stencil program with expression stages:
    ``csrc/stencil_pipeline.cu`` with ``fragment`` at its STENCIL_EXPR
    hook, holding the one instantiation <temporal, prefetch>."""
    inst = f"{int(temporal)}{int(prefetch)}"
    name = f"stencil_expr-{_digest(fragment.encode(), inst.encode())}"
    frag = BUILD_DIR / f"{name}.cuh"
    unit = BUILD_DIR / f"{name}.cu"
    text = (f"// {name}: csrc/stencil_pipeline.cu with a generated fragment\n"
            f"#define STENCIL_EXPR_TEMPORAL {int(temporal)}\n"
            f"#define STENCIL_EXPR_PREFETCH {int(prefetch)}\n"
            f"#define STENCIL_EXPR \"{frag}\"\n"
            f"#include \"{CSRC / 'stencil_pipeline.cu'}\"\n")
    return Library(name, BUILD_DIR / f"lib{name}.so", unit,
                   ((frag, fragment), (unit, text)))


def _lock(name: str) -> threading.RLock:
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(name, threading.RLock())


def _write(path: Path, text: str) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}."
                         f"{threading.get_ident()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def _compile(lib: Library) -> tuple[float, str | None]:
    """Run nvcc for ``lib``: (its wall seconds, nvcc's output if it
    failed, else None)."""
    for path, text in lib.files:
        _write(path, text)
    tmp = lib.path.with_name(f"{lib.path.name}.{os.getpid()}."
                             f"{threading.get_ident()}.tmp")
    # nvcc's intermediates stay inside the build directory
    env = dict(os.environ, TMPDIR=str(BUILD_DIR))
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(lib.source)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, env=env)
    seconds = time.perf_counter() - t0
    BUILD_LOG[lib.name] = proc.stdout
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return seconds, (f"nvcc failed for {lib.name} ({lib.source}):\n"
                         f"{proc.stdout}")
    os.replace(tmp, lib.path)
    return seconds, None


def build_all(libs: Iterable[Library], check: bool = True
              ) -> dict[str, float]:
    """Compile every library of ``libs`` that is missing, at most one
    nvcc per CPU at once. Returns {name: seconds} of those built here.
    Raises with nvcc's output for every one that failed, in this call or
    an earlier one, unless ``check`` is false: then the failures are
    only kept, for the library's load to raise."""
    libs = sorted({lib.name: lib for lib in libs}.values(),
                  key=lambda lib: lib.name)
    locks = [_lock(lib.name) for lib in libs]
    for lk in locks:                   # in name order: no deadlock
        lk.acquire()
    try:
        todo = [lib for lib in libs
                if lib.name not in _FAILED and not lib.path.exists()]
        seconds = {}
        if todo:
            BUILD_DIR.mkdir(exist_ok=True)
            workers = min(len(todo), os.cpu_count() or 1)
            with concurrent.futures.ThreadPoolExecutor(workers) as pool:
                done = list(pool.map(_compile, todo))
            for lib, (t, err) in zip(todo, done):
                seconds[lib.name] = t
                if err:
                    _FAILED[lib.name] = err
        failed = [_FAILED[lib.name] for lib in libs if lib.name in _FAILED]
        if failed and check:
            raise RuntimeError("\n".join(failed))
        return seconds
    finally:
        for lk in reversed(locks):
            lk.release()


def build(*names: str) -> dict[str, Path]:
    """Compile every named kernel whose library is missing, in parallel.

    Returns {name: library path}. Raises with nvcc's output on failure.
    """
    libs = {n: kernel_library(n) for n in names}
    build_all(libs.values())
    return {n: lib.path for n, lib in libs.items()}


def load_library(spec: Library) -> ctypes.CDLL:
    """The loaded library ``spec``, built first if it is missing (or
    loaded from disk when an earlier run built it)."""
    lib = _LIBS.get(spec.name)
    if lib is None:
        with _lock(spec.name):
            lib = _LIBS.get(spec.name)
            if lib is None:
                build_all([spec])
                lib = _LIBS[spec.name] = ctypes.CDLL(str(spec.path))
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    return lib if lib is not None else load_library(kernel_library(name))


def ptxas(name: str) -> dict[str, dict[str, int]]:
    """{entry function (mangled): {"registers": n, "spill_bytes": n}} from
    ptxas's report on the build of library ``name`` (a kernel's name or
    a :class:`Library`'s) in this process (empty when the library was
    loaded, not built)."""
    out: dict[str, dict[str, int]] = {}
    entry = None
    for ln in BUILD_LOG.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and entry is not None:
            entry["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry is not None:
            entry["registers"] = int(m.group(1))
    return out
