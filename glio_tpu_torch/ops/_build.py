"""Builds the port's CUDA kernels from the sources in ``glio_tpu_torch/csrc``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, which the wrappers load with ``ctypes``; a source
may instead be built with preprocessor definitions into libraries of its own
(``band_chol.cu``, one per block size and half-width). The library goes to
``build/glio_tpu_torch/`` at the root of the checkout under a name that
carries a hash of the source, the flags and the definitions, so an edited
source is rebuilt and an unchanged one is loaded as it is. A failed build
raises with nvcc's own error output.
"""

import ctypes
import concurrent.futures
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "glio_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("knn.cu", "copy.cu", "imu_preint.cu")
# Builds with definitions that ``build_all`` makes beside SOURCES: the band
# Cholesky kernels at the (D, hw) of the batch paths that use them
# (search_range + 1 = 7): the pose blocks (D = 6), the zenith-bias chain
# (D = 7) and level 1's IMU chains (D = 15). Others are built at their first
# use.
VARIANTS = tuple(("band_chol.cu", (f"BAND_CHOL_D={D}", "BAND_CHOL_HW=7")) for D in (6, 7, 15))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # reads CUDA_HOME/PATH
    if CUDA_HOME:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(candidate):
            return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(source: str, defines=()) -> Path:
    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    text = (CSRC / source).read_bytes() + " ".join(flags).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    tag = "".join(f"_{d.split('=')[-1]}" for d in defines)
    return BUILD_DIR / f"lib{Path(source).stem}{tag}_{digest}.so"


def build(source: str, defines=()) -> Path:
    """Compile one source (with the definitions ``defines``, "NAME=VALUE")
    unless a library of the same hash exists."""
    out = library_path(source, defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
           str(CSRC / source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (exit {res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stderr}{res.stdout}")
    os.replace(tmp, out)
    return out


def build_all() -> float:
    """Build every kernel of the package, one nvcc per source and variant,
    all started together; returns the seconds it took."""
    t0 = time.perf_counter()
    jobs = [(s, ()) for s in SOURCES] + list(VARIANTS)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        for fut in [pool.submit(build, s, d) for s, d in jobs]:
            fut.result()
    return time.perf_counter() - t0


def load(source: str, defines=()) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source, defines)))
