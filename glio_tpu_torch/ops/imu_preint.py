"""IMU preintegration in one launch: the CUDA kernel ``csrc/imu_preint.cu``.

``factors.imu.preintegrate`` calls ``preintegrate`` here for CUDA tensors;
its plain version is the Python loop ``factors.imu.preintegrate_reference``,
which every CPU caller runs and which the card tests hold the kernel to.
The kernel takes every edge of a call in one launch, one block an edge:
the leading axes of the inputs, broadcast together, are flattened into the
grid (4 blocks for the window's edges, T - 1 for the batch's IMU chain,
1 for a single run with no leading axis).
"""

import ctypes
import functools

import torch

from . import _build, _launch

F64 = torch.float64
STATE_DIM, NOISE_DIM = 15, 18


@functools.cache
def _library():
    fn = _build.load("imu_preint.cu").glio_imu_preint_f64
    # Every argument is a pointer or a size_t, 64 bits on the card's hosts.
    fn.argtypes = [ctypes.c_void_p] * 18
    fn.restype = ctypes.c_int
    return fn


def _check(acc, gyr, dt, valid, ba, bg, acc0, gyr0, noise_cov):
    tensors = dict(acc=acc, gyr=gyr, dt=dt, valid=valid, ba=ba, bg=bg, acc0=acc0,
                   gyr0=gyr0, noise_cov=noise_cov)
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"preintegrate: {name} must be a tensor")
        if t.device != acc.device:
            raise ValueError(f"preintegrate: {name} is on {t.device}, acc on {acc.device}")
    if valid.dtype != torch.bool:
        raise TypeError(f"preintegrate: valid must be torch.bool, got {valid.dtype}")
    n = acc.shape[-2] if acc.dim() >= 2 else -1
    if (acc.dim() < 2 or gyr.dim() < 2 or acc.shape[-1] != 3 or gyr.shape[-2:] != (n, 3)
            or dt.dim() < 1 or dt.shape[-1] != n or valid.dim() < 1 or valid.shape[-1] != n):
        raise ValueError("preintegrate: acc and gyr must be (..., N, 3), dt and valid (..., N)")
    if any(t.dim() < 1 or t.shape[-1] != 3 for t in (ba, bg, acc0, gyr0)):
        raise ValueError("preintegrate: ba, bg, acc0 and gyr0 must be (..., 3)")
    if noise_cov.shape != (NOISE_DIM, NOISE_DIM):
        raise ValueError(f"preintegrate: noise_cov must be ({NOISE_DIM}, {NOISE_DIM}), "
                         f"got {tuple(noise_cov.shape)}")


def preintegrate(acc, gyr, dt, valid, ba, bg, acc0, gyr0, noise_cov):
    """``factors.imu.preintegrate_reference`` in one kernel launch.

    Args are that function's, on one CUDA device; the floats are taken as
    f64 and the leading axes broadcast together. Returns (delta_p, delta_q,
    delta_v, jacobian, covariance, sum_dt), shaped (..., 3), (..., 4),
    (..., 3), (..., 15, 15), (..., 15, 15), (...,).
    """
    _check(acc, gyr, dt, valid, ba, bg, acc0, gyr0, noise_cov)
    if not acc.is_cuda:
        raise ValueError(f"preintegrate: no kernel for device {acc.device}")
    n = acc.shape[-2]
    batch = torch.broadcast_shapes(acc.shape[:-2], gyr.shape[:-2], dt.shape[:-1],
                                   valid.shape[:-1], ba.shape[:-1], bg.shape[:-1],
                                   acc0.shape[:-1], gyr0.shape[:-1])

    def dense(t, tail, dtype=F64):
        if t.shape != batch + tail:
            t = torch.broadcast_to(t, batch + tail)
        return t.to(dtype).contiguous()

    args = (dense(acc, (n, 3)), dense(gyr, (n, 3)), dense(dt, (n,)),
            dense(valid, (n,), torch.bool), dense(ba, (3,)), dense(bg, (3,)),
            dense(acc0, (3,)), dense(gyr0, (3,)), noise_cov.to(F64).contiguous())
    dev = acc.device
    outs = tuple(torch.empty(batch + tail, dtype=F64, device=dev)
                 for tail in ((3,), (4,), (3,), (STATE_DIM, STATE_DIM),
                              (STATE_DIM, STATE_DIM), ()))
    n_edges = outs[-1].numel()
    if n_edges:
        _launch.launch("imu_preint", _library(), acc.get_device(),
                       *(t.data_ptr() for t in args), n_edges, n,
                       *(t.data_ptr() for t in outs))
    return outs
