"""Timing utilities (port of ``glio_tpu/utils/profiling.py``).

``Timer`` is the reference's tic-toc helper (``GLIO/include/utils/timer.h:10-38``);
``Profiler`` sums per-section calls and milliseconds. A kernel launch returns
before the card has run it, so where a section's result holds CUDA tensors the
clock stops only after ``torch.cuda.synchronize`` (the JAX package waits with
``block_until_ready``).
"""

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

from .checkpoint import _leaves


def _block(tree):
    """Wait for the card where ``tree`` holds CUDA tensors."""
    for dev in {x.device for x in _leaves(tree) if isinstance(x, torch.Tensor) and x.is_cuda}:
        torch.cuda.synchronize(dev)


class Timer:
    """tic/toc in milliseconds, reference-compatible usage."""

    def __init__(self, name: str = ""):
        self.name = name
        self.tic()

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self, verbose: bool = True) -> float:
        dt_ms = (time.perf_counter() - self._t0) * 1e3
        if verbose:
            print(f"[{self.name}] {dt_ms:.2f} ms")
        return dt_ms


class Profiler:
    """Aggregating profiler: per-section call counts and total/mean ms."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def section(self, name: str, sync=None):
        """Time the block; ``sync``: tensors (or a tree of them) to wait for."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _block(sync)
            self.totals[name] += (time.perf_counter() - t0) * 1e3
            self.counts[name] += 1

    def time_fn(self, name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _block(out)
        self.totals[name] += (time.perf_counter() - t0) * 1e3
        self.counts[name] += 1
        return out

    def report(self) -> str:
        lines = [f"{'section':<32}{'calls':>8}{'total ms':>12}{'mean ms':>12}"]
        for k in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[k]
            lines.append(
                f"{k:<32}{n:>8}{self.totals[k]:>12.2f}"
                f"{self.totals[k] / max(n, 1):>12.3f}")
        return "\n".join(lines)
