"""Toolchain probe: the copy kernel ``csrc/copy.cu`` and the probe entry point.

Counterpart of ``scripts/probe_pallas.py``. There the question was whether
the TPU compiler produced a working kernel at all; here it is whether the
port's CUDA path works on this machine: ``nvcc`` builds a source into a
library with a plain C interface, ``ctypes`` binds it, and the kernel runs
on PyTorch's stream. Each stage runs in a spawned child with a timeout, so a
hang or a crash in the driver is reported and does not take the probe down:

    python -m glio_tpu_torch.ops.probe

1. the copy kernel on the probe's 8 x 128 f32 ``arange`` block, which must
   come back bit for bit;
2. the 5-NN kernel (``ops.knn``) on the probe's 8 queries x 128 map points,
   which must equal its plain torch version.

Prints ``CUDA-OK`` and exits 0 when both pass, ``CUDA-DEAD`` and exits 1
when the copy fails (the toolchain itself is broken), ``CUDA-PARTIAL`` and
exits 2 when only the kNN fails. There is no CPU mode: without a CUDA
device it prints ``CUDA-DEAD`` and exits 1. A last line ``launches:
copy_f32=N knn5_f32=N`` reports the kernel launches each child counted, the
difference of its tallies ``copy.launches`` / ``knn.launches``
(``profiling.tallies()``) across its call.

``copy`` is the kernel's wrapper; on a CPU tensor it runs ``copy_reference``
(``x.clone()``), on a CUDA tensor it launches the kernel or raises.
``copy_plan`` splits the bytes between the kernel's bulk-copy ring and its
threads. The probe's 4 KB block goes to the threads alone, so a failure on
it blames the toolchain and not the bulk-copy machinery.
"""

import ctypes
import functools
import multiprocessing as mp
import queue
import sys

import torch

from ..utils import profiling
from . import _build, _launch

PROBE_SHAPE = (8, 128)


def copy_reference(x):
    """Plain torch version of the copy kernel."""
    return x.clone()


STAGE_BYTES = 32 * 1024     # one stage of the kernel's bulk-copy ring


def copy_plan(x_ptr: int, y_ptr: int, nbytes: int, sm_count: int) -> tuple[int, int, int, int]:
    """Split of an ``nbytes`` copy from address ``x_ptr`` to ``y_ptr``
    between the kernel's two paths: ``(head, body, tail, blocks)``.

    Bytes ``[0, head)`` and ``[head + body, nbytes)`` go to the threads,
    ``[head, head + body)`` to the bulk-copy ring. The body is 16-byte
    aligned on both sides and a multiple of 16 bytes; it is empty, and the
    threads copy everything, when the array is smaller than one stage or
    when the two addresses differ in their alignment modulo 16. ``blocks``
    is the grid: one block per stage-sized chunk of the work, at least one
    and at most ``sm_count``. A plain tuple, as this runs on every launch.
    """
    if nbytes < STAGE_BYTES:
        return nbytes, 0, 0, 1
    if (x_ptr - y_ptr) % 16:
        return nbytes, 0, 0, min(sm_count, -(-nbytes // STAGE_BYTES))
    head = -y_ptr % 16
    body = (nbytes - head) // 16 * 16
    return head, body, nbytes - head - body, min(sm_count, -(-body // STAGE_BYTES))


@functools.cache
def _library():
    fn = _build.load("copy.cu").glio_copy_f32
    # Every argument is a pointer or a size_t, 64 bits on the card's hosts;
    # ctypes converts a Python int fastest as c_void_p.
    fn.argtypes = [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int
    return fn


def copy(x):
    """A copy of ``x`` (f32, contiguous, any shape)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError("copy: x must be a tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"copy: x must be torch.float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("copy: x must be contiguous")
    if not _launch.use_kernel("copy", x):
        return copy_reference(x)
    y = torch.empty_like(x)
    index = x.get_device()
    x_ptr, y_ptr = x.data_ptr(), y.data_ptr()
    head, body, tail, blocks = copy_plan(x_ptr, y_ptr, 4 * x.numel(), _launch.sm_count(index))
    _launch.launch("copy", _library(), index, x_ptr, y_ptr, head, body, tail, blocks,
                   STAGE_BYTES)
    return y


def _launches(name: str) -> int:
    return profiling.tallies().get(name + ".launches", 0)


def _try_copy(q):
    """Child: build the copy kernel, copy the probe's block, check it."""
    x = torch.arange(PROBE_SHAPE[0] * PROBE_SHAPE[1], dtype=torch.float32,
                     device="cuda").reshape(PROBE_SHAPE)
    before = _launches("copy")
    y = copy(x)
    torch.cuda.synchronize()
    ok = torch.equal(y, x) and float(y[3, 17]) == float(x[3, 17])
    q.put(("copy-ok" if ok else "copy-bad", _launches("copy") - before))


def _try_knn(q):
    """Child: build the 5-NN kernel and run the probe's 8 x 128 case."""
    from . import knn as knn_mod
    dev = torch.device("cuda")
    query = torch.zeros((8, 3), dtype=torch.float32, device=dev)
    query_valid = torch.ones(8, dtype=torch.bool, device=dev)
    points = torch.zeros((128, 3), dtype=torch.float32, device=dev)
    points[:, 0] = torch.arange(128, dtype=torch.float32, device=dev)
    points_valid = torch.ones(128, dtype=torch.bool, device=dev)
    args = (query, query_valid, points, points_valid)
    before = _launches("knn")
    d, i = knn_mod.knn(*args)
    d_r, i_r = knn_mod.knn_reference(*args)
    torch.cuda.synchronize()
    ok = torch.equal(d, d_r) and torch.equal(i, i_r)
    q.put(("ok" if ok else "knn-bad", _launches("knn") - before))


def _bounded(target, timeout_s: float):
    """Run ``target(queue)`` in a spawned child. Returns (status, launches):
    the child's status and kernel launch count, or ("hang", 0) /
    ("exit-N", 0) when it did not report."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(target=target, args=(q,))
    proc.start()
    try:
        msg = q.get(timeout=timeout_s)     # drain before join
    except queue.Empty:
        msg = None
    proc.join(5.0 if msg is not None else 0.1)
    if proc.is_alive():
        proc.terminate()
        proc.join(5.0)
        if proc.is_alive():
            proc.kill()
            proc.join()
        return msg if msg is not None else ("hang", 0)
    if proc.exitcode == 0 and msg is not None:
        return msg
    return f"exit-{proc.exitcode}", 0


def main(timeout_s: float = 120.0) -> int:
    if not torch.cuda.is_available():
        print("CUDA-DEAD: no CUDA device is available; the probe has no CPU mode")
        return 1
    knn_n = 0
    copy_res, copy_n = _bounded(_try_copy, timeout_s)
    if copy_res != "copy-ok":
        print(f"CUDA-DEAD: even the 8x128 copy kernel fails ({copy_res}): the "
              "nvcc -> ctypes -> launch path itself is broken, not any "
              "specific kernel")
        rc = 1
    else:
        knn_res, knn_n = _bounded(_try_knn, timeout_s)
        if knn_res == "ok":
            print("CUDA-OK: the copy kernel and the 5-NN kernel build, launch "
                  "and agree with their plain versions")
            rc = 0
        else:
            print(f"CUDA-PARTIAL: the copy kernel works but the 5-NN kernel "
                  f"fails ({knn_res}): a kernel-specific issue")
            rc = 2
    print(f"launches: copy_f32={copy_n} knn5_f32={knn_n}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
