"""The multi-device batch solve over ``torch.distributed`` (port of ``glio_tpu/parallel``).

``spike_cr.make_sharded_cr_solve`` is the exact sharded banded solve (SPIKE-
partitioned block cyclic reduction), ``banded_pcg.make_sharded_pcg`` the
block-Jacobi PCG over a ``dp × sp`` layout of ranks, and
``models.batch.optimize_batch_sharded`` the annealed robust LM solve whose
every step the sharded CR solve takes, each rank assembling only its own rows
from its slice of the problem (``assembly.RankShare``). ``launch.run_ranks``
starts the ranks.

Where JAX maps a function over the devices of a mesh (``shard_map``), each
rank here runs the function on its own shard and calls the collectives of
its process group. Every collective goes through ``Comm``, which counts the
calls and the bytes and times them.

One card, four ranks: NCCL refuses two ranks on one GPU ("Duplicate GPU
detected"), so the ranks use gloo on the card as on the CPU. Gloo runs
``all_gather`` and ``all_reduce`` on CUDA tensors (it stages them through
host memory), so the tensors of a solve stay on the card; its point-to-point
``send`` of a CUDA tensor aborts the rank (a host write from a device
address). Hence the halos of the PCG's matvec go by an all-gather of each
shard's edge rows and not by a send to each neighbour. On an H100 80GB HBM3
at 700 W with four ranks a collective of 8 B to 85 KB takes 1.3-6.7 ms, an
all-gather staged through host tensors by hand 3.5-23.8 ms
(``scripts/probe_torch_collectives.py``).
"""

import time

import torch
import torch.distributed as dist


class Comm:
    """The collectives of one process group, counted and timed.

    ``calls``, ``bytes`` (what this rank sends) and ``seconds`` (host clock
    around each blocking call; on the card after a synchronize, so that the
    time is the collective's and not that of the kernels queued before it)
    accumulate over the object's life.
    """

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0

    @classmethod
    def of(cls, group):
        """``group`` if it is a ``Comm`` already (its counters then take in the
        caller's collectives too), else a new ``Comm`` of the process group."""
        return group if isinstance(group, cls) else cls(group)

    def _start(self, t):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        self.calls += 1
        self.bytes += t.numel() * t.element_size()
        return time.perf_counter()

    def all_gather(self, t):
        """[t of rank 0, t of rank 1, ...] of the group; t contiguous."""
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        t0 = self._start(t)
        dist.all_gather(out, t, group=self.group)
        self.seconds += time.perf_counter() - t0
        return out

    def sum_in_rank_order(self, t):
        """The sum of t over the group, added in rank order: one all-gather,
        the same bits on every rank (``all_reduce`` adds in gloo's order)."""
        parts = self.all_gather(t)
        total = parts[0]
        for x in parts[1:]:
            total = total + x
        return total

    def all_reduce_sum(self, t):
        """The sum of t over the group (a new tensor)."""
        t = t.clone()
        t0 = self._start(t)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        self.seconds += time.perf_counter() - t0
        return t
