"""The host side of a kernel launch, shared by the port's kernel wrappers.

A wrapper checks its tensors, allocates its outputs and then calls
``launch`` with the C launcher bound by ``_build.load``. ``launch`` hands
the launcher the raw pointer of PyTorch's current stream on the tensors'
device, read with the call that Triton's own launcher uses, and makes that
device current only when it is not so already: the common case pays one
device query and one stream query, and no context manager. The launcher
returns the ``cudaError_t`` of its launch, and a nonzero one raises here.

The CUDA entry points of ``torch._C`` exist only in a CUDA build of torch,
so they are looked up at the first launch, never when this module is
imported.
"""

import functools

import torch


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
