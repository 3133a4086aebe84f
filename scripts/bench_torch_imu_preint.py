"""The port's IMU preintegration kernel on one GPU at its callers' shapes,
beside its plain version, the loop.

    python3 scripts/bench_torch_imu_preint.py

SHAPES are the sliding window's edges (4 x 40 slots of 100 Hz samples,
every keyframe) and batch level 1's IMU chain (3,492 x 40, once a solve),
from ``glio_tpu_torch.testing.imu_runs``. At each shape the kernel
(``factors.imu.preintegrate`` on CUDA tensors) is checked against the loop
(``preintegrate_reference``) on the same tensors within 1e-10, then timed
with ``testing.time_device_ms``: CUDA events around one call queued behind
a device sleep, median of 20, for the kernel's launch alone (its C entry
point on prepared pointers), the whole ``preintegrate`` call (checks,
output allocations, the launch) and the loop. The loop's time is its device
time from its first launch to its last, host dispatch included, since its
~15,000 launches a call outrun the sleep. The bound is the larger of the
f64 operations over the card's f64 rate (34 TFLOP/s on the H100 SXM,
counting a multiply-add as two) and the bytes over 3.35 TB/s; the work is
40 dependent steps, so what the kernel meets is their latency. The script
first prints ``ptxas -v`` for the source (registers, shared memory, spills).

Prints one JSON record as the last line.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from glio_tpu_torch.factors import imu as timu  # noqa: E402
from glio_tpu_torch.ops import _build, _launch, imu_preint  # noqa: E402
from glio_tpu_torch.testing import imu_runs, time_device_ms  # noqa: E402

SHAPES = {"window_4x40": (4, 40), "chain_3492x40": (3492, 40)}
REPS = 20
F64_RATE = 34e12           # H100 SXM, f64 outside the tensor cores
HBM_RATE = 3.35e12
# f64 operations of one step as the loop's dense products count them:
# F jac, F cov and (F cov) F^T; V N; (V N) V^T.
STEP_OPS = 2 * (3 * 15 * 15 * 15 + 15 * 18 * 18 + 15 * 15 * 18)


def ptxas_report() -> str:
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                              os.path.join(tmp, "k.so"), str(_build.CSRC / "imu_preint.cu")],
                             capture_output=True, text=True)
    if res.returncode:
        sys.exit(f"nvcc failed: {res.stderr}{res.stdout}")
    return res.stderr.strip()


def main():
    if not torch.cuda.is_available():
        sys.exit("bench_torch_imu_preint: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(ptxas_report())
    dev = torch.device("cuda:0")
    record = {"card": smi, "reps": REPS, "shapes": {}}
    for shape, (edges, n) in SHAPES.items():
        args = [torch.tensor(a, device=dev)
                for a in imu_runs(np.random.default_rng(0), (edges,), n=n)]
        got, ref = timu.preintegrate(*args), timu.preintegrate_reference(*args)
        for name, g, r in zip(timu.Preintegrated._fields, got, ref):
            torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-10,
                                       msg=lambda m: f"{shape} {name}: {m}")
        valid = int(args[3].sum())
        ops = STEP_OPS * valid
        nbytes = sum(a.numel() * a.element_size() for a in args) + sum(
            g.numel() * g.element_size() for g in got[:6])
        ptrs = [a.data_ptr() for a in args] + [edges, n] + [g.data_ptr() for g in got[:6]]
        rec = {"edges": edges, "slots": n, "valid_samples": valid, "ops": ops, "bytes": nbytes,
               "ops_bound_ms": ops / F64_RATE * 1e3, "bytes_bound_ms": nbytes / HBM_RATE * 1e3,
               "kernel_ms": time_device_ms(lambda: _launch.launch(
                   "imu_preint", imu_preint._library(), 0, *ptrs), reps=REPS),
               "call_ms": time_device_ms(lambda: timu.preintegrate(*args), reps=REPS),
               "loop_ms": time_device_ms(lambda: timu.preintegrate_reference(*args), reps=REPS)}
        print(f"{shape}: kernel {rec['kernel_ms']:.4f} ms, call {rec['call_ms']:.4f} ms, "
              f"loop {rec['loop_ms']:.4f} ms; "
              f"bound {max(rec['ops_bound_ms'], rec['bytes_bound_ms']):.4f} ms "
              f"({ops / 1e6:.1f} MFLOP, {nbytes / 1e6:.3f} MB)")
        record["shapes"][shape] = rec
    print(json.dumps(record))


if __name__ == "__main__":
    main()
