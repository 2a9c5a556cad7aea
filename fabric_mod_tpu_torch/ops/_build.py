"""Build and load the port's CUDA sources (nvcc -> shared library -> ctypes).

Each source under fabric_mod_tpu_torch/csrc/ is compiled on first CUDA
use into `<repo>/build/kernels/<name>-<source hash>.so` (a directory
.gitignore lists; the hash covers the headers under csrc/ too, and the
whole nvcc command line), with a plain C interface loaded through
ctypes — no PyTorch headers, so a build takes seconds, not minutes.
The hash key means an edited source or flag rebuilds and a stale
library is never loaded.  A failed build raises with nvcc's output.
Nothing here runs at import.

`build_count()` counts the nvcc builds and library loads of this
process, also exported as the ``fabric_gpu_kernel_builds_total``
counter (the port's counterpart of the reference's XLA compile count,
observability/tracing.compile_count).  `nvcc_count()` counts the nvcc
builds alone (``fabric_gpu_kernel_nvcc_builds_total``): a process that
finds every library built, as a node started after a build does, keeps
it at 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Sequence

from fabric_mod_tpu_torch.observability.metrics import (MetricOpts,
                                                        default_provider)

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
SOURCES = ("p256_ladder", "p256_core", "sha256", "fp256bn_pairing")

# C signatures: every pointer and the stream are c_void_p (without
# argtypes ctypes would pass them as 32-bit ints and cut them)
_P = ctypes.c_void_p
SIGNATURES = {
    "p256_ladder": {
        "p256_ladder_launch": (ctypes.c_int,
                               [ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P,
                                ctypes.c_int, _P]),
        "p256_ladder_geometry": (ctypes.c_int,
                                 [ctypes.POINTER(ctypes.c_int)] * 2),
    },
    "p256_core": {
        "p256_core_prologue_launch": (ctypes.c_int,
                                      [_P, _P, _P, _P, _P, ctypes.c_int, _P]),
        "p256_core_epilogue_launch": (ctypes.c_int,
                                      [_P, _P, _P, _P, _P, ctypes.c_int, _P]),
    },
    "fp256bn_pairing": {
        "fp256bn_miller_launch": (ctypes.c_int,
                                  [_P, _P, _P, ctypes.c_int, _P, ctypes.c_int,
                                   ctypes.c_int, _P]),
        "fp256bn_final_exp_launch": (ctypes.c_int,
                                     [_P, ctypes.c_int, _P, _P, ctypes.c_int,
                                      _P]),
        "fp256bn_pairing_geometry": (ctypes.c_int,
                                     [ctypes.c_int]
                                     + [ctypes.POINTER(ctypes.c_int)] * 6),
    },
    "sha256": {
        "sha256_e_launch": (ctypes.c_int,
                            [_P, _P, ctypes.c_int, _P, ctypes.c_int, _P]),
        "sha256_e_geometry": (ctypes.c_int,
                              [ctypes.POINTER(ctypes.c_int)] * 4),
    },
}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def source_path(name: str) -> Path:
    return CSRC / f"{name}.cu"


def _flags() -> list:
    """nvcc's arguments, between the compiler and the output path."""
    return [*ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def library_path(name: str) -> Path:
    """The library's path, keyed by the source, every header under
    csrc/ (the sources include them) and every flag of the build
    command."""
    h = hashlib.sha256(source_path(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update("\0".join(_flags()).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _command(name: str, out: Path) -> list:
    return [nvcc(), *_flags(), "-o", str(out), str(source_path(name))]


_BUILDS_OPTS = MetricOpts(
    "fabric", "gpu", "kernel_builds_total",
    help="nvcc builds and library loads of the port's CUDA sources in "
         "this process (a value climbing in a steady state means "
         "libraries are being rebuilt or reloaded).")
_builds = 0
_builds_lock = threading.Lock()


def _count_build() -> None:
    global _builds
    with _builds_lock:
        _builds += 1
    default_provider().counter(_BUILDS_OPTS).add(1)


_NVCC_OPTS = MetricOpts(
    "fabric", "gpu", "kernel_nvcc_builds_total",
    help="nvcc builds of the port's CUDA sources in this process (0 when "
         "every library was already built).")
_nvcc_builds = 0


def _count_nvcc() -> None:
    global _nvcc_builds
    with _builds_lock:
        _nvcc_builds += 1
    default_provider().counter(_NVCC_OPTS).add(1)


def nvcc_count() -> int:
    """nvcc builds made by this process so far."""
    return _nvcc_builds


def export_counts() -> None:
    """Register both counters on the default metrics provider, so a
    process that builds nothing still shows them (at 0) on /metrics."""
    default_provider().counter(_BUILDS_OPTS).add(0)
    default_provider().counter(_NVCC_OPTS).add(0)


def build_count() -> int:
    """nvcc builds plus library loads made by this process so far."""
    return _builds


def build_many(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Build every named source not yet built, all nvcc processes
    started together; returns {name: nvcc's output (ptxas register and
    spill report)} for the ones built.  Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        running[name] = (subprocess.Popen(
            _command(name, Path(tmp)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), Path(tmp), target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in running.items():
        out, _ = proc.communicate()
        logs[name] = out
        _count_build()
        _count_nvcc()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
        else:
            os.replace(tmp, target)          # atomic: no half-written .so
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return logs


class _Libraries:
    """Loaded libraries, one per source, with their signatures set."""

    def __init__(self):
        self._lock = threading.Lock()
        self._libs: dict = {}

    def get(self, name: str) -> ctypes.CDLL:
        with self._lock:
            lib = self._libs.get(name)
            if lib is None:
                build_many([name])
                lib = ctypes.CDLL(str(library_path(name)))
                _count_build()
                for fn, (res, args) in SIGNATURES[name].items():
                    f = getattr(lib, fn)
                    f.restype = res
                    f.argtypes = args
                self._libs[name] = lib
            return lib


_LIBS = _Libraries()


def load(name: str) -> ctypes.CDLL:
    """The built library for `name` (building it first if needed)."""
    return _LIBS.get(name)
