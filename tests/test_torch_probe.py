"""The copy kernel's host side on the CPU: ``copy_plan``, the split of a copy
between the kernel's bulk-copy ring and its threads, and the wrapper
``probe.copy``, which on a CPU tensor is ``clone`` and launches nothing.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
Here every byte of a copy is checked to be covered exactly once by the
plan, with the kernel's own assignment of body chunks to blocks.
"""

import itertools

import numpy as np
import pytest
import torch

from glio_tpu_torch.ops import knn as knn_mod
from glio_tpu_torch.ops import probe
from glio_tpu_torch.utils import profiling

S = probe.STAGE_BYTES
SIZES = [0, 4, 12, 16, 1003 * 4, S - 4, S, S + 4, 5 * S + 12, 300 * S + 12]
SM_COUNTS = [1, 3, 132]
BASE = 0x7F00_0000_0000     # a 256-byte-aligned address, as the allocator gives


def _pieces(plan, nbytes):
    """The byte ranges each part of the kernel copies, as (start, stop):
    the head and tail for the threads, and the body's chunks as the blocks
    of the grid take them (block b: chunks b, b + blocks, ...)."""
    head, body, tail, blocks = plan
    out = [(0, head), (head + body, head + body + tail)]
    n_chunks = -(-body // S)
    for b in range(blocks):
        for c in range(b, n_chunks, blocks):
            out.append((head + c * S, head + min((c + 1) * S, body)))
    return sorted(p for p in out if p[1] > p[0])


@pytest.mark.parametrize("nbytes", SIZES)
def test_copy_plan_covers_every_byte_once(nbytes):
    for dx, dy, sms in itertools.product(range(16), range(16), SM_COUNTS):
        x, y = BASE + 4096 + dx, BASE + dy
        plan = probe.copy_plan(x, y, nbytes, sms)
        head, body, tail, blocks = plan
        assert min(plan) >= 0 and head + body + tail == nbytes
        assert 1 <= blocks <= sms
        stop = 0
        for a, b in _pieces(plan, nbytes):
            assert a == stop, (plan, a, stop)       # contiguous, no overlap
            stop = b
        assert stop == nbytes
        assert body % 16 == 0
        if body:
            assert (x + head) % 16 == 0 and (y + head) % 16 == 0
            assert head < 16 and tail < 16
            assert blocks == min(sms, -(-body // S))
        if (x - y) % 16 or nbytes < S:
            assert plan == (nbytes, 0, 0, blocks)        # all to the threads
        else:
            assert body > 0
        if dx % 4 == 0 and dy % 4 == 0:                 # any f32 tensor
            assert head % 4 == 0 and tail % 4 == 0


def test_copy_plan_spreads_the_misaligned_thread_path_over_the_card():
    """A view such as buf[1:] goes to the threads, but on every SM."""
    n = 4 * ((1 << 26) + 1)
    assert probe.copy_plan(BASE + 4, BASE, n, 132) == (n, 0, 0, 132)
    assert probe.copy_plan(BASE, BASE, 4 * 8 * 128, 132) == (4096, 0, 0, 1)   # the probe's


def test_copy_plan_seeded_pointer_sweep():
    """Random f32 addresses and sizes: the body is the aligned middle."""
    rng = np.random.default_rng(0)
    for _ in range(2000):
        x, y = (int(v) * 4 for v in rng.integers(1 << 20, 1 << 40, size=2))
        nbytes = 4 * int(rng.integers(0, 40 * S // 4))
        head, body, tail, blocks = probe.copy_plan(x, y, nbytes, 132)
        assert head + body + tail == nbytes and 1 <= blocks <= 132
        if (x - y) % 16 == 0 and nbytes >= S:
            assert head == -y % 16 and tail == (nbytes - head) % 16


def test_copy_on_cpu_is_clone_and_launches_nothing():
    buf = torch.tensor(np.random.default_rng(1).normal(size=1004).astype(np.float32))
    before = profiling.tallies().get("copy.launches", 0)
    for x in (buf, buf[1:], buf[3:3], buf.reshape(4, 251)):
        y = probe.copy(x)
        assert torch.equal(y.view(torch.int32), x.view(torch.int32))
        assert y.shape == x.shape and (y.numel() == 0 or y.data_ptr() != x.data_ptr())
    assert profiling.tallies().get("copy.launches", 0) == before


def test_copy_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(8, 128)
    with pytest.raises(TypeError):
        probe.copy(x.double())
    with pytest.raises(TypeError):
        probe.copy(x.numpy())
    with pytest.raises(ValueError):
        probe.copy(x.t())
    with pytest.raises(ValueError):                      # no kernel, no fallback
        probe.copy(torch.zeros(8, 128, device="meta"))


def test_knn_has_no_fallback_for_other_devices():
    args = (torch.zeros(4, 3), torch.ones(4, dtype=torch.bool),
            torch.zeros(16, 3), torch.ones(16, dtype=torch.bool))
    with pytest.raises(ValueError):
        knn_mod.knn(*(a.to("meta") for a in args))
    before = profiling.tallies().get("knn.launches", 0)
    d, i = knn_mod.knn(*args)
    assert profiling.tallies().get("knn.launches", 0) == before
    assert d.shape == (4, 5) and i.shape == (4, 5)
