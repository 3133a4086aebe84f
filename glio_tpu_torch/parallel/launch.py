"""Start the ranks of a multi-device solve: one spawned process a rank.

``run_ranks(fn, world_size, device, init_file)`` starts ``world_size``
processes with ``torch.multiprocessing`` (spawn), joins them in one gloo
process group through a ``file://`` rendezvous (no TCP port, so that
concurrent runs on one host do not collide) and calls
``fn(rank, world_size, device, *args)`` in each. ``fn`` must be importable by
name from a module of this package: a spawned child imports it afresh.

Every rank runs on ``device``: on the card all ranks share it, on the CPU
each takes one thread. An exception in any rank ends the others and is
raised in the caller (``torch.multiprocessing.ProcessRaisedException``); a
collective that waits on a dead rank ends at the group's timeout.
"""

import datetime
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 600


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _rank_main(rank, fn, world_size, device, init_file, out_dir, args):
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: {device} was asked for and CUDA is not available")
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = fn(rank, world_size, dev, *args)
        torch.save(_to_cpu(out), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, device, init_file: str = None, args=()):
    """Run ``fn(rank, world_size, device, *args)`` in ``world_size`` ranks;
    returns each rank's result, its tensors moved to the CPU.

    ``init_file``: the rendezvous file, which must not exist yet (default: a
    file in a fresh temporary directory).
    """
    if init_file is not None and os.path.exists(init_file):
        raise ValueError(f"the rendezvous file {init_file} exists already")
    with tempfile.TemporaryDirectory() as out_dir:
        init = init_file or os.path.join(out_dir, "rendezvous")
        mp.start_processes(_rank_main, args=(fn, world_size, str(device), init, out_dir,
                                             tuple(args)),
                           nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
