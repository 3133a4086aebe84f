"""The port's 5-NN kernel on one GPU at its callers' shapes, under every
cluster size, and against an earlier version of the kernel.

    python3 scripts/bench_torch_knn.py [--parent PATH/knn.cu]

SHAPES are the window association (5 x 1024 scan points against the
16,384-point local map), the lidar odometry's ICP (a 1024- or 2048-point
scan against its map, which ``lidar_odometry.py`` caps at
``map_points`` = 16,384) and one keyframe pair of batch level 1 (1024 x
1024; that stage associates its pairs in batches, where the 16-query tiles
alone fill the card). Clouds ~300 m from the origin, ~10 % invalid on each
side (``glio_tpu_torch.testing.cloud``).

For each shape the kernel runs under ``knn_plan``'s plan and under every
other cluster size, each launch checked bit for bit against
``knn_reference``. With ``--parent``, the script also builds that source
with the same flags: the kernel as it was before its cluster design (one
thread per query, C entry point ``glio_knn5_f32(query, query_valid,
points, points_valid, int n_query, int n_points, out_d, out_i, stream)``),
and times it before and after the current kernel at each shape. Every time
is ``testing.time_device_ms``: CUDA events around one launch queued behind
a device sleep, median of 50. The script first prints ``ptxas -v`` for the
source (registers, shared memory, spills).

Prints one JSON record as the last line.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from glio_tpu_torch.ops import _build, _launch  # noqa: E402
from glio_tpu_torch.ops import knn as knn_mod  # noqa: E402
from glio_tpu_torch.testing import (cloud, gpu_clock_mhz, knn_bound_ms,  # noqa: E402
                                    time_device_ms)

SHAPES = {   # name: (queries, map points)
    "window_5120x16384": (5120, 16384),
    "odometry_1024x16384": (1024, 16384),
    "odometry_2048x16384": (2048, 16384),
    "sms1_pair_1024x1024": (1024, 1024),
}
REPS = 50


def nvcc(source, out, *extra):
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-o", out, str(source)],
                         capture_output=True, text=True)
    if res.returncode:
        sys.exit(f"nvcc failed on {source}: {res.stderr}{res.stdout}")
    return res.stderr.strip()


def parent_kernel(source, tmp):
    """The earlier kernel's C entry point, built from ``source``."""
    lib = os.path.join(tmp, "libknn_parent.so")
    nvcc(source, lib)
    fn = ctypes.CDLL(lib).glio_knn5_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="knn.cu of the earlier, unplanned kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_torch_knn: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda:0")
    sms = _launch.sm_count(0)
    clock = gpu_clock_mhz()
    fn = knn_mod._library()
    stream = torch.cuda.current_stream().cuda_stream
    record = {"card": smi, "sms": sms, "clock_mhz": clock, "reps": REPS, "shapes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        print(nvcc(_build.CSRC / "knn.cu", os.path.join(tmp, "k.so"), "-Xptxas", "-v"))
        parent = parent_kernel(args.parent, tmp) if args.parent else None
        for shape, (Q, N) in SHAPES.items():
            gen = np.random.default_rng(1)
            a = [torch.tensor(x, device=dev) for x in (*cloud(gen, Q), *cloud(gen, N))]
            d_r, i_r = knn_mod.knn_reference(*a)
            out_d = torch.empty((Q, 5), dtype=torch.float32, device=dev)
            out_i = torch.empty((Q, 5), dtype=torch.int64, device=dev)
            ptrs = [t.data_ptr() for t in a]

            def timed(name, launch):
                out_d.fill_(-1.0)
                err = launch()
                torch.cuda.synchronize()
                if err or not (torch.equal(out_d, d_r) and torch.equal(out_i, i_r)):
                    sys.exit(f"{shape} {name}: cudaError {err} or output differs from "
                             "the plain version")
                return time_device_ms(launch, reps=REPS)

            def run_parent():
                return parent(*ptrs, Q, N, out_d.data_ptr(), out_i.data_ptr(), stream)

            rec = {"plan": knn_mod.knn_plan(Q, N, sms),
                   "bound_ms": knn_bound_ms(a[1], a[3], sms, clock), "clusters": {}}
            if parent:
                rec["parent_ms_before"] = timed("parent", run_parent)
            for cluster in knn_mod.CLUSTER_SIZES:
                split = knn_mod.split_size(N, cluster)
                ms = timed(f"cluster {cluster}", lambda: fn(
                    *ptrs, Q, N, cluster, split, out_d.data_ptr(), out_i.data_ptr(), stream))
                rec["clusters"][cluster] = ms
                print(f"{shape} cluster {cluster}, split {split}: "
                      f"{-(-Q // knn_mod.TILE_QUERIES) * cluster} blocks, {ms:.4f} ms"
                      f"{'  <- knn_plan' if cluster == rec['plan'][1] else ''}")
            rec["ms"] = time_device_ms(lambda: knn_mod.knn(*a), reps=REPS)
            if parent:
                rec["parent_ms_after"] = timed("parent", run_parent)
            line = (f"{shape}: knn wrapper {rec['ms']:.4f} ms under plan {rec['plan']}; "
                    f"FP32 bound {rec['bound_ms']:.4f} ms ({sms} SMs at {clock:.0f} MHz)")
            if parent:
                line += (f"; earlier kernel {rec['parent_ms_before']:.4f} / "
                         f"{rec['parent_ms_after']:.4f} ms (before / after)")
            print(line)
            record["shapes"][shape] = rec
    print(json.dumps(record))


if __name__ == "__main__":
    main()
