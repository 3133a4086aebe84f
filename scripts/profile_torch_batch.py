"""Where the port's batch LM iteration spends its time, on one GPU.

    python3 scripts/profile_torch_batch.py

Builds ``chip_smoke.py``'s 3493-keyframe batch problem on ``cuda:0``, runs
one warm-up stage, then reports per LM iteration:

* the wall time of the assembly, the cyclic-reduction solve and the cost
  evaluation, each closed by ``torch.cuda.synchronize()``, mean of 5;
* from ``torch.profiler`` over one 4-iteration stage, run without those
  syncs: the wall time, the device's busy share of it, kernel launches,
  and the kernels that take the most device time.

Prints the record as one JSON object, then the top kernels one per line.
"""

import collections
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import _sync_s, batch_problem  # noqa: E402
from glio_tpu_torch.models import batch  # noqa: E402
from glio_tpu_torch.solver import banded  # noqa: E402

PROFILED_ITERS = 4


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_batch: needs a CUDA device")
    dev = torch.device("cuda:0")
    _, sc, cfg, prob, _, _, _ = batch_problem(dev)
    robust = batch.RobustOpts(dd_huber=sc["dd_huber"], epoch_gate=sc["epoch_gate"],
                              rel_huber=sc["rel_huber"])
    hw = cfg.estimator.search_range + 1
    th = sc["thresholds"][-1]
    plan = batch.assembly_plan(prob, hw)
    p, q, _ = batch.solve_batch_once(cfg, prob, prob.p_odo, prob.q_odo, 1e9,
                                     sc["lm_iters"], robust=robust, plan=plan)

    asm_s, (band, grad, *_) = _sync_s(lambda: batch._assemble_core_impl(
        p, q, prob, th, hw, robust=robust, plan=plan), reps=5)
    cr_s, _ = _sync_s(lambda: banded.cyclic_reduction_solve(band, -grad), reps=5)
    cost_s, _ = _sync_s(lambda: batch._total_cost(p, q, prob, th), reps=5)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        batch.solve_batch_once(cfg, prob, p, q, th, PROFILED_ITERS, robust=robust, plan=plan)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.device_time_total
    top = [{"kernel": n[:120], "device_ms_per_iter": us / 1e3 / PROFILED_ITERS}
           for n, us in by_name.most_common(12)]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    record = {
        "device": torch.cuda.get_device_name(dev),
        "nvidia_smi": smi.splitlines()[0],
        "keyframes": int(prob.p_odo.shape[0]),
        "epochs": int(prob.ep_left.shape[0]),
        "synced_ms": {"assembly": 1e3 * asm_s, "cr_solve": 1e3 * cr_s, "cost": 1e3 * cost_s},
        "profiled_iterations": PROFILED_ITERS,
        "profiled_wall_ms_per_iter": 1e3 * wall_s / PROFILED_ITERS,
        "device_busy_ms_per_iter": busy_us / 1e3 / PROFILED_ITERS,
        "device_busy_share": busy_us / 1e6 / wall_s,
        "kernel_launches_per_iter": len(kernels) / PROFILED_ITERS,
        "top_kernels": top,
    }
    print(json.dumps(record))
    for row in top:
        print(f"{row['device_ms_per_iter']:9.3f} ms/iter  {row['kernel']}")


if __name__ == "__main__":
    main()
