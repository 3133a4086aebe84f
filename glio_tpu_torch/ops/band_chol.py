"""The f32 block-banded Cholesky factor and solve of ``chol_pcg``'s
preconditioner: the CUDA kernels of ``csrc/band_chol.cu`` and their plain
versions.

``band_cholesky`` computes ``solver/banded.block_cholesky`` of an f32 band,
``band_cholesky_solve`` ``solver/banded.block_cholesky_solve`` with its
factor. On a CUDA tensor each launches its kernel, which walks the T block
rows in one thread block (the factor in the plain version's order of
operations, the solve in its order of block rows), or raises; on a CPU
tensor each runs its plain version. Nothing falls back from one to the
other. The kernels are built one library per (D, hw) (``ops/_build.VARIANTS``
builds those of the batch paths with the other kernels; another is built at
its first use).
"""

import ctypes
import functools

import torch

from ..solver.banded import block_cholesky, block_cholesky_solve
from . import _build, _launch

MAX_HW = 15                     # csrc/band_chol.cu: kMaxHw
SMEM_MAX = 227 * 1024           # kSmemMax: the shared memory a block may opt into
_WARPS, _STAGES, _AHEAD = 4, 3, 16   # kWarps, kStages, kAhead


def _smem(D: int, hw: int) -> tuple:
    """The bytes of shared memory of the factor and the solve kernel at (D,
    hw): band_chol.cu's factor_smem and solve_smem."""
    def round4(n):
        return (n + 3) // 4 * 4
    dd, rdd, ring = D * D, (hw + 1) * D * D, hw + 2 * _WARPS
    factor = ((_WARPS * round4(dd) + ring * round4(D) + _WARPS * _STAGES * round4(rdd + 3)
               + ring * rdd) * 4 + (ring + 2) * 4)
    solve = ((_AHEAD + hw + 1) * (round4(rdd + (3 if rdd % 4 else 0)) + round4(D))
             + (hw + 4) * round4(D)) * 4
    return factor, solve


def _max_hw(D: int) -> int:
    return max(hw for hw in range(MAX_HW + 1) if max(_smem(D, hw)) <= SMEM_MAX)


# The block sizes the kernels are built for, each with the largest hw whose
# shared memory fits: the batch's pose blocks (6), pose and zenith bias (7,
# ``optimize_batch_atm``) and level 1's IMU-chain states (15).
KERNEL_D = {D: _max_hw(D) for D in (6, 7, 15)}


def _check_tensor(name, what, x, dim):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: {what} must be a tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: {what} must be float32, got {x.dtype}")
    if x.dim() != dim:
        raise ValueError(f"{name}: {what} must have {dim} dimensions, got {tuple(x.shape)}")


def _check_contiguous(name, *xs):
    if not all(x.is_contiguous() for x in xs):
        raise ValueError(f"{name}: the tensors must be contiguous")


def _check_kernel_shape(name, D, hw):
    """Refuse a block size the kernels are not built for, or an hw past the
    shared memory of that size."""
    if D not in KERNEL_D:
        raise ValueError(f"{name}: the kernels are built for D in {sorted(KERNEL_D)}, got D={D}")
    if hw > KERNEL_D[D]:
        raise ValueError(f"{name}: at D={D} the kernels take hw <= {KERNEL_D[D]} (their shared "
                         f"memory past that exceeds {SMEM_MAX // 1024} KB), got hw={hw}")


def _check_aligned(name, x):
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel streams rows in 16-byte copies; the tensor must "
                         f"start on a 16-byte boundary (a view into a larger tensor may not)")


@functools.cache
def _library(D: int, hw: int):
    """The kernels' library at block size D and half-width hw, built if need
    be."""
    lib = _build.load("band_chol.cu", (f"BAND_CHOL_D={D}", f"BAND_CHOL_HW={hw}"))
    size, ptr = ctypes.c_size_t, ctypes.c_void_p
    lib.glio_band_chol_f32.argtypes = [ptr, size, size, size, ctypes.c_float, ptr, ptr]
    lib.glio_band_chol_solve_f32.argtypes = [ptr, ptr, size, size, size, ptr, ptr]
    for fn in (lib.glio_band_chol_f32, lib.glio_band_chol_solve_f32):
        fn.restype = ctypes.c_int
    return lib


def band_cholesky(band, jitter: float = 0.0):
    """Lb (T, hw + 1, D, D) f32 with Lb[t, m] = L[t][t − m], L Lᵀ = the band
    + jitter·I, as ``block_cholesky`` returns it (a broken block row NaN,
    zeroed below). band: (T, 2hw + 1, D, D) f32, contiguous; on the card
    D and hw as ``KERNEL_D`` allows and band 16-byte aligned."""
    _check_tensor("band_cholesky", "band", band, 4)
    if band.shape[1] % 2 != 1 or band.shape[2] != band.shape[3]:
        raise ValueError(f"band_cholesky: band must be (T, 2hw+1, D, D), got {tuple(band.shape)}")
    _check_contiguous("band_cholesky", band)
    if not _launch.use_kernel("band_cholesky", band):
        return block_cholesky(band, jitter=jitter)
    T, Bw, D, _ = band.shape
    hw = (Bw - 1) // 2
    _check_kernel_shape("band_cholesky", D, hw)
    _check_aligned("band_cholesky", band)
    out = torch.empty((T, hw + 1, D, D), dtype=torch.float32, device=band.device)
    _launch.launch("band_cholesky", _library(D, hw).glio_band_chol_f32,
                   band.get_device(),
                   band.data_ptr(), T, hw, D, float(jitter), out.data_ptr())
    return out


def band_cholesky_solve(Lb, b):
    """x (T, D) f32 with L Lᵀ x = b, L the factor ``band_cholesky`` returns
    (Lb: (T, hw + 1, D, D) f32), as ``block_cholesky_solve`` computes it:
    the forward sweep, then the backward. Lb and b contiguous, on one
    device; on the card D and hw as ``KERNEL_D`` allows and Lb 16-byte
    aligned."""
    _check_tensor("band_cholesky_solve", "Lb", Lb, 4)
    _check_tensor("band_cholesky_solve", "b", b, 2)
    T, HW1, D, D2 = Lb.shape
    if D != D2 or tuple(b.shape) != (T, D):
        raise ValueError(f"band_cholesky_solve: Lb must be (T, hw+1, D, D) and b (T, D), got "
                         f"{tuple(Lb.shape)} and {tuple(b.shape)}")
    _check_contiguous("band_cholesky_solve", Lb, b)
    if b.device != Lb.device:
        raise ValueError(f"band_cholesky_solve: Lb on {Lb.device}, b on {b.device}")
    if not _launch.use_kernel("band_cholesky_solve", Lb):
        return block_cholesky_solve(Lb, b)
    _check_kernel_shape("band_cholesky_solve", D, HW1 - 1)
    _check_aligned("band_cholesky_solve", Lb)
    x = torch.empty((T, D), dtype=torch.float32, device=Lb.device)
    _launch.launch("band_cholesky_solve",
                   _library(D, HW1 - 1).glio_band_chol_solve_f32,
                   Lb.get_device(),
                   Lb.data_ptr(), b.data_ptr(), T, HW1 - 1, D, x.data_ptr())
    return x
