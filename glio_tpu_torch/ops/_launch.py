"""The host side of a kernel launch, shared by the port's kernel wrappers.

A wrapper checks its tensors, asks ``use_kernel`` whether their device
runs the kernel (a CUDA device) or the wrapper's plain torch version (the
CPU), allocates its outputs and then calls ``launch`` with the C launcher
bound by ``_build.load``. ``launch`` hands the launcher the raw pointer of
PyTorch's current stream on the tensors' device, read with the call that
Triton's own launcher uses, and makes that device current only when it is
not so already: the common case pays one device query and one stream
query, and no context manager. The launcher returns the ``cudaError_t`` of
its launch, and a nonzero one raises here.

Every launch that succeeds adds one to the process-wide tally
``"<name>.launches"`` (``utils.profiling.tally``; ``knn``, ``knn_pairs``,
``band_cholesky``, ``band_cholesky_solve``, ``imu_preint``, ``copy``): a
reader takes the difference of two ``profiling.tallies()`` readings. A
launch inside a CUDA-graph capture counts once, at capture; the graph's
replays do not call ``launch``.

The CUDA entry points of ``torch._C`` exist only in a CUDA build of torch,
so they are looked up at the first launch, never when this module is
imported.
"""

import functools

import torch

from ..utils import profiling


@functools.cache
def _cuda_calls():
    return torch._C._cuda_getCurrentRawStream, torch._C._cuda_getDevice


@functools.cache
def sm_count(index: int) -> int:
    """Number of streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(name: str, fn, index: int, *args) -> None:
    """Call ``fn(*args, stream)`` on PyTorch's current stream of CUDA device
    ``index``; raise if it returns a nonzero ``cudaError_t``."""
    raw_stream, current_device = _cuda_calls()
    if index == current_device():
        err = fn(*args, raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, raw_stream(index))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")
    profiling.tally(name + ".launches")


def use_kernel(name: str, t: torch.Tensor) -> bool:
    """True where ``t`` is on a CUDA device (the wrapper ``name`` launches
    its kernel), False on the CPU (it runs its plain version); any other
    device raises ``ValueError``."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")
