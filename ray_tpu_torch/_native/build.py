"""Compile-on-demand for the port's CUDA kernels.

Each ``csrc/<name>.cu`` builds into its own shared library with a plain C
interface, ``_build/lib<name>-<hash>.so``, where the hash covers the source,
the shared headers (``csrc/*.cuh``), the compiler and the flags. Libraries
are loaded with ``ctypes`` at first use; a missing or stale one is
rebuilt then, so a fresh checkout needs no separate build step.
``build_all`` starts one ``nvcc`` per source, all at once, and waits for
them (the build counts against a caller's time limit); the seconds a
build took land in the calling train rank's goodput ledger as its
``compile`` phase. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# name -> the compiler's output of the build this process ran (ptxas
# register / shared-memory report included); empty when the .so was cached.
BUILD_LOGS: dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default location. Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from "
                       f"{SRC_DIR} at first use")


def kernel_sources() -> list[str]:
    """Names of every kernel source under csrc/ (``<name>.cu``)."""
    return sorted(f[:-3] for f in os.listdir(SRC_DIR) if f.endswith(".cu"))


def _so_path(name: str, nvcc: str) -> str:
    h = hashlib.sha1()
    # The source and every shared header beside it (csrc/*.cuh).
    headers = sorted(f for f in os.listdir(SRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(SRC_DIR, fname), "rb") as f:
            h.update(f.read())
    h.update(nvcc.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, nvcc: str, so_path: str):
    tmp = f"{so_path}.tmp{os.getpid()}"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc, tmp: str, so_path: str) -> None:
    out, _ = proc.communicate()
    BUILD_LOGS[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc build of {name}.cu failed "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, so_path)  # atomic against a concurrent build


def build_all(names: list[str] | None = None) -> list[str]:
    """Build every stale kernel library in parallel (one nvcc each) and
    return the .so paths. Raises if any build fails."""
    names = kernel_sources() if names is None else names
    with _LOCK:
        nvcc = nvcc_path()
        os.makedirs(BUILD_DIR, exist_ok=True)
        paths = {n: _so_path(n, nvcc) for n in names}
        t0 = time.perf_counter()
        running = [(n, *_start(n, nvcc, p)) for n, p in paths.items()
                   if not os.path.exists(p)]
        errors = []
        for n, proc, tmp in running:
            try:
                _finish(n, proc, tmp, paths[n])
            except RuntimeError as e:
                errors.append(str(e))
        if running:
            # The port's compile phase: a build a train step waited for
            # lands in the calling rank's goodput ledger as "compile".
            from ray_tpu_torch.observability import goodput

            goodput.add_active_pending("compile", time.perf_counter() - t0)
        if errors:
            raise RuntimeError("\n".join(errors))
        return [paths[n] for n in names]


def load_library(name: str) -> ctypes.CDLL:
    """dlopen lib<name> for csrc/<name>.cu, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    (path,) = build_all([name])
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(path)
        return _LIBS[name]
