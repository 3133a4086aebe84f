"""The device trace of a traced run, read from ``torch.profiler``.

``Trace`` keeps what the per-layer readers need from the profiler's
events: the device operations (kernels, copies, sets) with their names and
intervals, and the host's events (operators and CUDA calls). Busy time is
the union of the device intervals, so kernels that overlap count once (a
sum of kernel durations would count them twice).
"""

import collections

import numpy as np
import torch

CUDA = torch.autograd.DeviceType.CUDA


def _kind(name: str) -> str:
    """A device operation's kind from its name, as the CUDA trace names them."""
    if name.startswith("Memcpy"):
        return "memcpy"
    return "memset" if name.startswith("Memset") else "kernel"


class Trace:
    """``events``: the profiler's events (each with ``name``,
    ``device_type``, ``start_ns`` and ``duration_ns``); ``window_s``: the
    traced window's wall time."""

    def __init__(self, events, window_s: float):
        self.window_s = window_s
        dev, host = [], []
        for e in events:
            name, start = e.name(), e.start_ns()
            item = (start, start + e.duration_ns(), name)
            if e.device_type() == CUDA:
                dev.append(item + (_kind(name),))
            else:
                host.append(item)
        dev.sort()
        host.sort()
        self.dev = dev
        self.host = host

    # -- counts and times ---------------------------------------------------

    def kernels(self, name_part: str = None) -> list:
        """(start_ns, end_ns, name) of every kernel, in start order; only
        those whose name holds ``name_part`` where given."""
        return [(s, t, n) for s, t, n, k in self.dev
                if k == "kernel" and (name_part is None or name_part in n)]

    def launches(self) -> int:
        return sum(1 for *_, k in self.dev if k == "kernel")

    def _merged(self) -> np.ndarray:
        if not self.dev:
            return np.zeros((0, 2), np.int64)
        iv = np.array([(s, t) for s, t, *_ in self.dev], np.int64)
        out = [list(iv[0])]
        for s, t in iv[1:]:
            if s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return np.array(out, np.int64)

    def busy_s(self) -> float:
        m = self._merged()
        return float((m[:, 1] - m[:, 0]).sum()) * 1e-9

    def idle_pct(self):
        """100 × (1 − busy / window); None where the device ran nothing."""
        busy = self.busy_s()
        return 100.0 * (1.0 - busy / self.window_s) if busy > 0 and self.window_s > 0 else None

    # -- breakdown ------------------------------------------------------------

    def device_ops(self, top: int = 10) -> list:
        by = collections.Counter()
        for s, t, n, _ in self.dev:
            by[n] += (t - s) * 1e-9
        return [[n[:200], v] for n, v in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """Device idle time between operations, summed by the innermost host
        event (an operator, or a CUDA call such as ``cudaLaunchKernel``)
        running at each gap's midpoint ("python" where none ran)."""
        m = self._merged()
        if len(m) < 2:
            return []
        gaps = np.stack([m[:-1, 1], m[1:, 0]], 1)
        mids = (gaps[:, 0] + gaps[:, 1]) // 2
        order = np.argsort(mids)
        by = collections.Counter()
        stack, h = [], 0
        for g in order:
            mid = mids[g]
            while h < len(self.host) and self.host[h][0] <= mid:
                while stack and stack[-1][1] <= self.host[h][0]:
                    stack.pop()
                stack.append(self.host[h])
                h += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            name = stack[-1][2] if stack else "python"
            by[name] += (gaps[g, 1] - gaps[g, 0]) * 1e-9
        return [[n[:200], v] for n, v in by.most_common(top)]


def profile(cpu: bool):
    """The profiler context of a traced phase: the CUDA activity (device
    operations and the CUDA runtime's calls), with ``cpu`` also every
    operator on the host. A build of torch without CUDA (the CPU tests)
    records the host alone."""
    acts = [a for a in (torch.profiler.ProfilerActivity.CUDA,)
            if a in torch.profiler.supported_activities()]
    if cpu or not acts:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def from_profiler(prof, window_s: float) -> Trace:
    return Trace(prof.profiler.kineto_results.events(), window_s)
