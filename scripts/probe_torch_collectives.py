"""Which collectives run four ranks on one card, and what each costs.

    python3 scripts/probe_torch_collectives.py [--ranks 4]

Starts the ranks on ``cuda:0`` with ``glio_tpu_torch.parallel.launch.run_ranks``
(gloo, ``file://`` rendezvous) three times:

1. gloo ``all_gather`` and ``all_reduce`` of f64 CUDA tensors at the sizes of
   the sharded solves at T = 3493 (the SPIKE reduced system, the solution
   gather, a PCG halo, a CG dot), each checked against the sum it must give,
   beside the same all-gather staged through host tensors by hand; the mean
   ms a call over ``REPS`` calls (``parallel.Comm``'s clock: after a
   synchronize, around the blocking call);
2. gloo ``send`` / ``recv`` of a CUDA tensor around the ring;
3. an NCCL group over the same ranks, one ``all_reduce``.

Each experiment reports what it raised, if it did. Prints one JSON object.
Needs a card.
"""

import argparse
import datetime
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from glio_tpu_torch.parallel.launch import run_ranks  # noqa: E402

REPS = 50
S, N_LOC, HW, D = 42, 125, 7, 6
SIZES = {"spike_reduced": 2 * (3 * S * S + S), "solution": N_LOC * S,
         "pcg_halo": 2 * 2 * HW * D, "cg_dot": 1}


def collectives(rank, world, dev):
    from glio_tpu_torch.parallel import Comm
    out = {}
    for name, n in SIZES.items():
        t = torch.full((n,), float(rank + 1), dtype=torch.float64, device=dev)
        for op in ("all_gather", "all_reduce", "all_gather_host"):
            c = Comm()
            for i in range(REPS + 1):
                if i == 1:
                    c.calls, c.seconds = 0, 0.0
                if op == "all_gather":
                    got = torch.stack(c.all_gather(t)).sum(0)
                elif op == "all_reduce":
                    got = c.all_reduce_sum(t)
                else:
                    got = torch.stack(c.all_gather(t.cpu())).sum(0).to(dev)
            want = world * (world + 1) / 2
            ok = bool((got == want).all()) and got.device == t.device
            out[f"{name}/{op}"] = {"ms": 1e3 * c.seconds / c.calls, "ok": ok,
                                   "bytes": n * 8}
    return out


def send_recv(rank, world, dev):
    import torch.distributed as dist
    t = torch.full((64,), float(rank), dtype=torch.float64, device=dev)
    r = torch.empty_like(t)
    reqs = [dist.isend(t, (rank + 1) % world), dist.irecv(r, (rank - 1) % world)]
    for q in reqs:
        q.wait()
    return bool((r == (rank - 1) % world).all())


def nccl(rank, world, dev):
    import torch.distributed as dist
    g = dist.new_group(backend="nccl", timeout=datetime.timedelta(seconds=60))
    x = torch.ones(1, device=dev)
    dist.all_reduce(x, group=g)
    torch.cuda.synchronize()
    return float(x.item())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_torch_collectives: needs a card")
    report = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
              "ranks": args.ranks}
    for name, fn in (("collectives", collectives), ("send_recv", send_recv), ("nccl", nccl)):
        t0 = time.perf_counter()
        try:
            res = run_ranks(fn, args.ranks, "cuda:0")
            report[name] = res[0] if name == "collectives" else res
        except Exception as e:          # each experiment reports its own failure
            report[name] = f"raised {type(e).__name__}: {str(e)[-600:]}"
        report[f"{name}_s"] = time.perf_counter() - t0
        print(name, json.dumps(report[name])[:2000], flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
