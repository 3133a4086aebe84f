"""Timing utilities (port of ``glio_tpu/utils/profiling.py``) and the span recorder.

``Timer`` is the reference's tic-toc helper (``GLIO/include/utils/timer.h:10-38``);
``Profiler`` sums per-section calls and milliseconds. A kernel launch returns
before the card has run it, so where a section's result holds CUDA tensors the
clock stops only after ``torch.cuda.synchronize`` (the JAX package waits with
``block_until_ready``).

``span(name)`` marks a phase of the estimation paths on the host clock, for
the benchmark's traced runs. Recording is off unless ``enable`` turns it on;
off, a span tests one flag and returns a shared no-op context (no record, no
clock read). On, each span appends a ``Span`` record: its name, its start and
end in integer ns on the clock of ``torch.profiler``'s events (Unix-epoch ns,
from ``perf_counter_ns`` and one offset taken at ``enable``), its id, the id
of the span it is nested in (-1 for a root) and its unit, the ordinal of its
root. No span reads a device value, syncs or launches anything, so a span's
interval is the host's: the kernels it launched may run later, and the
profiler's correlation ids tie each one to the host call that launched it.
``counter(name)`` is a list an op appends its work to while recording is
on; ``reset`` empties the records and every counter. ``tally(name)`` adds
one to an integer that counts whether recording is on or off, for the life
of the process (``reset`` keeps it): how often a path was taken, such as the
window LM's CUDA-graph captures, replays and direct calls.
"""

import itertools
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import NamedTuple

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


# --- the span recorder ---------------------------------------------------------------

class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int       # -1 for a root span
    unit: int         # the ordinal of the root span, from 0 after ``reset``


_on = False
_offset_ns = 0        # profiler clock (Unix-epoch ns) - perf_counter_ns
_records = []         # [name, start, end, id, parent, unit], in order of start
_open = []            # the open spans' records, innermost last
_units = itertools.count()
_counters = {}
_tallies = defaultdict(int)


class _NoSpan:
    """The span while recording is off: one shared object, nothing done."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        parent = _open[-1] if _open else None
        rec = [self.name, 0, 0, len(_records),
               -1 if parent is None else parent[3],
               next(_units) if parent is None else parent[5]]
        _records.append(rec)
        _open.append(rec)
        self.rec = rec
        rec[1] = time.perf_counter_ns() + _offset_ns
        return None

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns() + _offset_ns
        if _open and _open[-1] is self.rec:
            _open.pop()
        return False


def span(name: str):
    """A context that records ``name``'s interval while recording is on."""
    if not _on:
        return _NO_SPAN
    return _Span(name)


def recording() -> bool:
    return _on


def enable():
    """Turn recording on; the clock offset is taken here."""
    global _on, _offset_ns
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    _on = True


def disable():
    global _on
    _on = False


def reset():
    """Drop every record and counter entry; ids and units start again at 0."""
    global _units
    _records.clear()
    _open.clear()
    _units = itertools.count()
    for entries in _counters.values():
        entries.clear()


def records() -> list:
    """The spans recorded since the last ``reset``, in order of start (a span
    still open has ``end_ns`` 0)."""
    return [Span(*r) for r in _records]


def self_ns(spans) -> list:
    """Each span's duration less the part its children cover (ns), in the
    order of ``spans``."""
    own = [s.end_ns - s.start_ns for s in spans]
    index = {s.id: i for i, s in enumerate(spans)}
    for s in spans:
        if s.parent in index:
            own[index[s.parent]] -= s.end_ns - s.start_ns
    return own


def counter(name: str) -> list:
    """The list that the op ``name`` appends its work to while recording is
    on (one list a name; ``reset`` empties it)."""
    return _counters.setdefault(name, [])


def tally(name: str):
    """Add one to the always-on tally ``name``."""
    _tallies[name] += 1


def tallies() -> dict:
    """Every tally of the process: name → count."""
    return dict(_tallies)
