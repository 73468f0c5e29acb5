"""Build the port's CUDA kernels at first use.

Compiles every ``csrc/*.cu`` of this package with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, which the
kernel wrappers load with ``ctypes``.  The library lands in ``_build/``
beside this file, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once.  ``nvcc`` is the only
tool used; nothing here runs unless a kernel is launched on a CUDA tensor.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_info = {}  # "seconds", "log", "path" of the build this process did or found


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "renormalizer_tpu_torch need the CUDA toolkit")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libreno_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        build_info.update(seconds=0.0, log="(cached)", path=str(out))
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_info.update(seconds=seconds, log=proc.stdout + proc.stderr,
                      path=str(out))
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call, with its C signatures."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for name in ("reno_jacobi_eigh_f32", "reno_jacobi_eigh_f64"):
            fn = getattr(lib, name)
            # a, v, w, resid, nsweeps, work; batch, n, sweeps, max_sweeps;
            # stream
            fn.argtypes = [vp] * 6 + [ci] * 4 + [vp]
            fn.restype = ci
        _lib = lib
    return _lib
