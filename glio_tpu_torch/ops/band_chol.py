"""The f32 block-banded Cholesky factor of ``chol_pcg``'s preconditioner: the
CUDA kernel ``csrc/band_chol.cu`` and its plain version.

``band_cholesky`` computes ``solver/banded.block_cholesky`` of an f32 band.
On a CUDA tensor it launches the kernel, which walks the T block rows in one
thread block in the plain version's order of operations, or raises; on a
CPU tensor it runs ``block_cholesky``. Nothing falls back from one to the
other.
"""

import ctypes
import functools

import torch

from ..solver.banded import block_cholesky
from . import _build, _launch

MAX_D = 8           # csrc/band_chol.cu: kMaxD
MAX_HW = 15         # kMaxRow − 1


def _check(band):
    if not isinstance(band, torch.Tensor):
        raise TypeError("band_cholesky: band must be a tensor")
    if band.dtype != torch.float32:
        raise TypeError(f"band_cholesky: band must be float32, got {band.dtype}")
    if band.dim() != 4 or band.shape[1] % 2 != 1 or band.shape[2] != band.shape[3]:
        raise ValueError(f"band_cholesky: band must be (T, 2hw+1, D, D), got {tuple(band.shape)}")
    if not band.is_contiguous():
        raise ValueError("band_cholesky: band must be contiguous")


@functools.cache
def _library():
    fn = _build.load("band_chol.cu").glio_band_chol_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def band_cholesky(band, jitter: float = 0.0):
    """Lb (T, hw + 1, D, D) f32 with Lb[t, m] = L[t][t − m], L Lᵀ = the band
    + jitter·I, as ``block_cholesky`` returns it (a broken block row NaN,
    zeroed below). band: (T, 2hw + 1, D, D) f32, contiguous; on the card
    D ≤ 8 and hw ≤ 15."""
    _check(band)
    if not band.is_cuda:
        if band.device.type == "cpu":
            return block_cholesky(band, jitter=jitter)
        raise ValueError(f"band_cholesky: no kernel for device {band.device}")
    T, Bw, D, _ = band.shape
    hw = (Bw - 1) // 2
    if D > MAX_D or hw > MAX_HW:
        raise ValueError(f"band_cholesky: the kernel takes D <= {MAX_D} and hw <= {MAX_HW}, "
                         f"got D={D}, hw={hw}")
    out = torch.empty((T, hw + 1, D, D), dtype=torch.float32, device=band.device)
    _launch.launch("band_cholesky", _library(), band.get_device(), band.data_ptr(), T, hw, D,
                   float(jitter), out.data_ptr())
    band_cholesky.launches += 1
    return out


band_cholesky.launches = 0
