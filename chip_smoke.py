"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``glio_tpu_torch``'s paths on ``cuda:0`` at full size and checks
them: the sliding-window replay at the ``bench.py`` shapes, the toolchain
probe, the batch stage at the UrbanNav Whampoa length, levels 0 and 1,
``run_pipeline`` (stages 1-3, at each level), stage 3 at the Whampoa
length, backend fusion, loop closure, the dense frames and map export, a
raw sensor log (a ROS1 bag) through ingest, the LiDAR front end and stage 1,
and GNSS: RINEX files through the converter, SPP on the card, the batch with
Doppler rows and ``chol_pcg``, and GNSS in the window.
Phases, each of which raises on failure:

1. device: the card's name and power limit (``nvidia-smi``); CUDA must be
   available, there is no CPU mode; TF32 off;
2. build: every CUDA kernel of the package, from the sources in the
   checkout (``nvcc``, sm_90a, one process per source, in parallel);
3. kernels against their plain torch versions on the card, on the same
   inputs, bit for bit: the 5-NN (``glio_tpu_torch.testing.KNN_CASES``)
   at the window association's shape (5120 queries, 16,384 map points,
   coordinates ~300 m from the origin, ~10 % invalid on each side), at the
   odometry's (1024 and 2048 queries, where ``knn_plan`` splits the map
   across a cluster), with exact ties across the kernel's map splits
   (lattice points, a map whose halves are copies), ragged query and map
   counts, maps smaller than one split, an empty and an all-invalid map;
   its time at the window's shape beside its FP32 bound (valid pairs x 8 operations over SMs x 128 lanes
   x the SM clock) and ``topk(cdist)`` as a yardstick; the copy kernel
   against ``clone`` over a size sweep (COPY_SWEEP: the probe's 8 x 128
   ``arange`` block, a ragged 1003 elements, 4 MiB that stay in the L2,
   256 MiB + 12 B, and a 256 MiB ``buf[1:]`` view that is not 16-byte
   aligned), with effective bandwidth (2 x bytes / time) and, for the two
   sizes beyond the L2, its share of the H100's 3.35 TB/s; kernel and
   plain times by CUDA events around one call queued behind a device sleep
   (so the host's path to the launch is not counted), median of 20; each
   wrapper's host path per call (enqueue time, no sync); then the voxel
   grid on the card against the CPU on one 51,200-point map ring; the IMU
   preintegration kernel against its loop on the same card tensors within
   1e-10 (``testing.IMU_PREINT_CASES``), both timed at the window's 4 x 40;
4. replay: the 30-keyframe ``simulate_episode(seed=0)`` through
   ``SlidingWindowEstimator.replay``, once to warm up and once timed; the
   kernel must have launched once per keyframe, every output must be
   finite, and the trajectory must match the JAX package's
   (``tests/data/sw_replay_w50_seed0.npz``, made by
   ``scripts/make_torch_port_fixture.py``): n_lidar_factors equal at every
   step, max |p - p_jax| <= 5e-3 m, about 10x the JAX replay's own
   sensitivity to a 1e-9 m nudge of its start (3.8e-4 m at keyframe 30);
5. probe: ``python -m glio_tpu_torch.ops.probe`` in a subprocess; it must
   exit 0 with ``CUDA-OK`` and report one copy-kernel launch;
6. batch: the 3493-keyframe drifted drive with simulated GNSS every third
   keyframe (``tests/data/batch_T3493_seed4.npz``, made by
   ``scripts/make_torch_batch_fixture.py``), built by the port, checked
   against the fixture's problem checksums, solved by ``optimize_batch``
   (bench robust options, 4 stages x 10 LM iterations, direct solver)
   twice: the two runs must agree bit for bit, and the trajectory must be
   within 3e-4 m of JAX's f64 solve and within 5e-3 m of JAX's
   mixed-precision main path (whose own distance to f64 is 1.2e-3 m);
   then both covariances, against the fixture. 3e-4 m is 10x JAX's own
   f64 floor: near convergence the LM accepts or rejects steps of up to
   ~3e-5 m on cost differences of ~1e-8 in 1494, the cost's own rounding,
   so a 1e-9 m nudge of the odometry moves JAX's f64 result by 3.0e-5 m;
7. pipeline: ``run_pipeline`` (stages 1-3) on the 15-keyframe
   ``simulate_episode(seed=0)`` at the bench shapes with GNSS at every
   keyframe (``tests/data/pipeline_seed0.npz``): the kNN kernel must
   launch once per keyframe, n_lidar_factors must equal JAX's at every
   step, and ``tc_sw_result.csv`` / ``tc_batch_result.csv`` must match
   JAX's rows (positions within the replay's 5e-3 m), ``lc_result.csv``
   within this run's stage-1 position and attitude differences times JAX's
   gains from each to its stage 3 (``lc_*`` keys), plus 10x JAX's own
   spread under a +-1e-9 m nudge of stage 1;
8. batch level 1: ``simulate_episode(n_keyframes=3493, scan_points=1024,
   seed=4)`` with simulated GNSS every third keyframe and a random-walk
   odometry (``tests/data/sms1_T3493_seed4.npz``, made by
   ``scripts/make_torch_sms1_fixture.py``): the batched 5-NN
   (``knn_pairs``) against its plain version on 256 of the episode's
   keyframe pairs; then the main path, ``build_sms1`` (20,937 pairs of
   1024 x 1024 in chunks of ``SMS1_CHUNK``, one kernel launch each),
   ``build_imu_chain`` and ``optimize_batch_sms1_imu`` (4 stages x 6 LM
   iterations over 15-dof states) twice: the two solves must agree bit for
   bit, the association's masks must agree with JAX's in 99.9 % of the
   slots (how many slots hold another point than JAX's is printed), p must
   be within 10x JAX's own spread of JAX's f64 solve (a +-1e-9 m nudge of
   the odometry, associated and solved again, moves JAX's result by
   ``nudge_dp``), and p, q and v within 10x that spread of each
   (``nudge_dq``, ``nudge_dv``) of JAX with its plane fits' eigensystem in
   f64, as the port has it (``*_f64eig``); RMSE against the truth of the
   odometry, level 0 and level 1; the
   association's, the IMU chain's and each LM part's times, each closed by
   a sync; the batched kernel's time over all pairs in one launch beside
   its FP32 bound, and over one chunk (kernel == plain bit for bit) beside
   its plain version and batched ``topk(cdist)``;
9. pipeline, level 1: phase 7 with ``sms_fusion_level=1``
   (``tests/data/pipeline_sms1_seed0.npz``), the batch's positions and
   yaw/pitch/roll held to JAX's f64 level-1 rows within this run's
   stage-1 difference times the gains by which JAX's level-1 batch grows a
   stage-1 difference (``gain_p_per_m``, ``gain_ypr_per_m``), plus 10x JAX's
   own spread under a +-1e-9 m nudge of stage 1 (``nudge_dp``,
   ``nudge_ypr``); against JAX's mixed rows within that plus 10x JAX's
   mixed-vs-f64 distance; ``lc_result.csv`` as in phase 7;
10. stage 3 at T = 3493 on phase 6's drive and GNSS
    (``tests/data/lc_T3493_seed4.npz``, made by
    ``scripts/make_torch_stage3_fixture.py``): 1165 DD fixes in one
    batched solve (ok masks equal, fixes within 10x JAX's spread under a
    1e-8 m pseudorange nudge), the gate and association (the gated factors
    equal), the LC solve twice (bit-identical; p, q within 10x JAX's
    spread under the larger of that nudge and a 1e-9 m odometry nudge);
    DD, gate and LC times and the RMSE to the truth;
11. backend fusion at the bench shapes on the divergence scenario of
    ``tests/test_pipeline_aux.py`` (48 keyframes,
    ``tests/data/backend_fusion_w50_seed21.npz``): the kNN once per
    keyframe, the reset decisions equal to JAX's (which are stable under
    JAX's own +-1e-9 m nudges of p0), p within 10x JAX's nudge spread; ms
    per keyframe, seconds per fusion solve;
12. loop closure on a two-lap 132-keyframe circle of 1024-point scans
    with injected drift (``tests/data/loop_closure_seed17.npz``):
    ``apply_loop_closure`` with the kNN launched 3 times per candidate,
    the candidates, accepted flags and edge count equal to JAX's, the
    corrected chain within 10x JAX's spread under a 1e-5 m nudge (the f32
    resolution of the world points); then the kernel against its plain
    version bit for bit at the ICP's 1024 x 25,600, timed beside its FP32
    bound and ``topk(cdist)``;
13. dense frames (``interpolate_segments`` on a ``dense_frames=3`` drive)
    and the map export (``assemble_map`` + ``write_pcd``) against
    ``tests/data/dense_pcd_seed19.npz``;
14. raw input at the HDL-32E width (``scripts/full_pipeline_tpu.py:101-114``:
    2048-point scans, 16,384-point map, window map width 50, 300 features
    with ``diverse_select``, the default 32-line odometry): 20 raycast
    32 x 1800 frames at 10 Hz (``glio_tpu_torch.testing.RAW_DRIVE``, made by
    host processes and timed apart) written with the IMU stream into a bz2
    ROS1 bag, then ``ingest.episode_from_rosbag`` on the card against
    ``tests/data/frontend_hdl32_seed8.npz`` (made by
    ``scripts/make_torch_frontend_fixture.py``): every frame's surf cloud
    and the keyframe flags equal to JAX's, the odometry's poses and
    relatives within 10x JAX's own spread under a +-1e-5 m nudge of p0 (the
    f32 resolution of the map its plane fits see), n_matches within that
    nudge's change, the episode's IMU bins, q0 and seeds within 1e-12; the
    kNN twice a frame; then ``run_pipeline`` (stage 1): the kNN once a
    keyframe, n_lidar_factors equal to JAX's, ``tc_sw_result.csv`` within 10x
    JAX's own spread under a +-1e-9 m nudge of p0. The 5-NN against its
    plain version bit for bit on the last frame's first ICP call (2048 x
    16,384) and on the last keyframe's association (10,240 x 16,384), each
    timed beside its FP32 bound and ``topk(cdist)``; preprocessing ms per
    scan, odometry ms per frame and replay ms per keyframe against the 10 Hz
    scan period.

15. GNSS, against ``tests/data/gnss_T3493_seed15.npz``,
    ``long_run_seed3.npz`` and ``window_doppler_seed0.npz`` (made by
    ``scripts/make_torch_gnss_fixture.py``): RINEX 3 obs and nav files of the
    batch phase's drive (``testing.write_synthetic_rinex``: 1165 epochs at
    1 Hz, 8 GPS + 6 BDS satellites with a BDS GEO) held to the fixture's
    sha256, converted by ``gnss.converter.convert`` with the native decoder
    built by g++ (decode and convert seconds), slots, masks, masters and
    sat_id equal to JAX's and the float fields' checksums within 1e-12; SPP
    of all epochs in one call (ok masks equal, fixes within 1e-6 m of JAX's,
    whose own spread under nudges is 4.2e-8 m), Doppler velocity and DOP,
    timed by CUDA events, RMSE to the truth; the level-0 batch with Doppler
    rows at T = 3493 on those epochs (4 stages x 10 LM iterations, bench
    robust options): direct twice, bit-identical and within 10x JAX's own
    spread under a +-1e-9 m nudge of the odometry, then ``chol_pcg`` (14 CG
    iterations, 1.1e-2 m short of the exact solve), within 10x JAX's own
    spread under a 1-ulp rescaling of its f32 preconditioner, its three LM
    closures captured as CUDA graphs once and replayed every LM iteration
    (the factor and solve kernels launched by the host at the capture alone),
    and in a second, replayed solve the factor kernel run once an LM
    iteration and the solve kernel 15 times by the profiler's count; each
    kernel against its plain version on the first LM iteration's band
    (``block_cholesky`` within 2e-5 of the largest entry, NaN rows equal;
    ``block_cholesky_solve`` within the larger of 2e-5 of max |x| and 10x
    its own f32 round-off against f64), timed beside its bound and a dense
    yardstick (``cholesky_ex``; two ``solve_triangular``), and ``chol_pcg``'s
    seconds split into factor, applies and the rest;
    ``scripts/long_run.py``'s configuration (window width 20, DD rows in the
    window, ``chol_pcg``) on 30 keyframes of ``simulate_episode(seed=3)``
    through ``run_pipeline(..., backend_fusion_every=10)``: the kNN once a
    keyframe, n_lidar_factors and reset decisions equal to JAX's, the two
    CSVs within 10x JAX's nudge spread, ms per keyframe; and phase 7's
    episode with DD and Doppler rows in the window and the batch: the same
    gates and the window's receiver clock drift within 10x JAX's spread.

18. the multi-device batch solve, four ranks on the one card (gloo; NCCL
    refuses two ranks on one GPU), started by ``parallel.launch.run_ranks``,
    against ``tests/data/parallel_T3493_seed4.npz`` (made by
    ``scripts/make_torch_parallel_fixture.py``): ``make_sharded_cr_solve`` on
    the batch phase's band at its solution (T = 3493, D = 6, hw 7: 499
    super-rows, 125 a rank) within 1e-8 of max |x| of the single-device
    ``cyclic_reduction_solve``; ``make_sharded_pcg`` at dp = 2, sp = 2, 60
    iterations, on two level-0 bands against ``pcg_solve`` within 10x JAX's
    own sharded-against-single distance; ``optimize_batch_sharded``, each
    rank holding only its slice of the problem and assembling only its own
    rows, on the batch drive: each rank's rows of its first assembly within
    1e-12 of the largest entry of this process's whole band, the partial
    costs summed within 1e-12 of its cost, the trajectory against this
    run's ``optimize_batch(solver="direct")`` within 10x JAX's own distance
    or its 1e-9 m nudge spread, the larger, and against JAX f64 within
    3e-4 m; the seconds of the ranks' start-up, of each solve and of its
    collectives, and each rank's rows, slice, assembly ms against the whole
    band's in the same run, and peak device memory;
19. each small public function off the pipeline's paths
    (``testing.item9_cases``) on the card against its CPU result in this
    run, at f64 round-off.

The batched 5-NN is also held to its plain version in phase 3, on
``glio_tpu_torch.testing.KNN_PAIR_CASES``, one launch each: an
all-invalid map frame, ragged and unaligned frames of 1000 and 1001
points, one and two pairs (where ``knn_plan`` splits the map), and the
65,535 pairs that fill the grid's y dimension, the most a call takes.

The line before the last is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

from glio_tpu_torch import config as config_mod
from glio_tpu_torch import pipeline
from glio_tpu_torch.config import EstimatorConfig, GlioConfig, ShapeConfig
from glio_tpu_torch.data import ingest
from glio_tpu_torch.data.simulator import (drifted_trajectory, random_walk_odometry,
                                           simulate_episode, simulate_gnss_epochs)
from glio_tpu_torch import testing
from glio_tpu_torch.eval import pointcloud
from glio_tpu_torch.factors import imu as imu_factors
from glio_tpu_torch.gnss import converter as gnss_converter
from glio_tpu_torch.gnss import native as gnss_native
from glio_tpu_torch.gnss import rtk as gnss_rtk
from glio_tpu_torch.gnss import spp as gnss_spp
from glio_tpu_torch.gnss import tools as gnss_tools
from glio_tpu_torch.lidar import neighbors
from glio_tpu_torch.models import batch as batch_mod
from glio_tpu_torch.models import lc_fusion, lidar_odometry, local_graph, loop_closure
from glio_tpu_torch.models import sliding_window as sw_mod
from glio_tpu_torch.models.sliding_window import SlidingWindowEstimator
from glio_tpu_torch.ops import _build
from glio_tpu_torch.ops import band_chol as band_chol_mod
from glio_tpu_torch.ops import knn as knn_mod
from glio_tpu_torch.ops import probe as probe_mod
from glio_tpu_torch.parallel.launch import run_ranks
from glio_tpu_torch.pipeline import run_pipeline
from glio_tpu_torch.solver import banded
from glio_tpu_torch.utils import profiling
from glio_tpu_torch.testing import (IMU_PREINT_CASES, KNN_CASES, KNN_PAIR_CASES, cloud,
                                    dense_episode, divergence_episode, frames_digest, gpu_clock_mhz,
                                    knn_bound_ms, knn_pairs_bound_ms, loop_episode, raw_config,
                                    raw_drive, reset_decisions, time_device_ms, write_raw_bag)

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "data", "sw_replay_w50_seed0.npz")
BATCH_FIXTURE = os.path.join(ROOT, "tests", "data", "batch_T3493_seed4.npz")
PIPE_FIXTURE = os.path.join(ROOT, "tests", "data", "pipeline_seed0.npz")
SMS1_FIXTURE = os.path.join(ROOT, "tests", "data", "sms1_T3493_seed4.npz")
PIPE_SMS1_FIXTURE = os.path.join(ROOT, "tests", "data", "pipeline_sms1_seed0.npz")
LC_FIXTURE = os.path.join(ROOT, "tests", "data", "lc_T3493_seed4.npz")
FUSION_FIXTURE = os.path.join(ROOT, "tests", "data", "backend_fusion_w50_seed21.npz")
LOOP_FIXTURE = os.path.join(ROOT, "tests", "data", "loop_closure_seed17.npz")
DENSE_FIXTURE = os.path.join(ROOT, "tests", "data", "dense_pcd_seed19.npz")
FRONTEND_FIXTURE = os.path.join(ROOT, "tests", "data", "frontend_hdl32_seed8.npz")
GNSS_FIXTURE = os.path.join(ROOT, "tests", "data", "gnss_T3493_seed15.npz")
LONG_RUN_FIXTURE = os.path.join(ROOT, "tests", "data", "long_run_seed3.npz")
DOPP_WINDOW_FIXTURE = os.path.join(ROOT, "tests", "data", "window_doppler_seed0.npz")
CARRIER_FIXTURE = os.path.join(ROOT, "tests", "data", "carrier_T3493_seed15.npz")
VARIANTS_FIXTURE = os.path.join(ROOT, "tests", "data", "batch_variants_T3493_seed4.npz")
CADENCE_FIXTURE = os.path.join(ROOT, "tests", "data", "batch_variants_cadence_T300_seed4.npz")
SMS1_SOLVERS_FIXTURE = os.path.join(ROOT, "tests", "data", "batch_variants_sms1_T3493_seed4.npz")
PARALLEL_FIXTURE = os.path.join(ROOT, "tests", "data", "parallel_T3493_seed4.npz")
SHARDED_RANKS = 4             # ranks of the multi-device phase, all on cuda:0
SPIKE_RTOL = 1e-8             # sharded direct solve vs single (dryrun_multichip's gate)
SHARD_ROWS_RTOL = 1e-12       # a rank's assembled rows vs the whole band's, of its largest entry
ASSEMBLY_REPS = 10            # calls a rank times of each assembly in phase 18
ITEM9_RTOL = 1e-12            # a small function on the card vs the CPU, of max(1, max |x|)
SPP_TOL_M = 1e-6              # SPP fixes, Doppler velocities (m/s) against JAX's
GNSS_SUM_RTOL = 1e-12         # checksums of converted epochs and problems (round-off)
BAND_CHOL_RTOL = 2e-5         # f32 band factor, kernel vs plain, of its largest entry
BAND_SOLVE_RTOL = 2e-5        # f32 band solve, kernel vs plain, of max |x| (or 10x the
                              # plain version's own f32 round-off, where that is larger)
CHOL_PCG_APPLIES = 15         # preconditioner applies an LM iteration: 1 + 14 CG iterations
RAYCAST_WORKERS = 8          # host processes that raycast the raw frames
SCAN_PERIOD_MS = 100.0        # a 10 Hz scan
SOLVE_CAP_MS = 15.0           # the reference odometry's solve cap (LidarOdometry.cpp:523-524)
EPISODE_TOL = 1e-12
SMS1_MASK_AGREE = 0.999       # share of association slots whose mask equals JAX's
N_KEYFRAMES = 30
P_TOL_M = 5e-3
BATCH_F64_TOL_M = 3e-4        # 10x JAX f64's own spread under a 1e-9 m nudge
BATCH_MIXED_TOL_M = 5e-3
YPR_TOL_DEG = 0.05
DENSE_TOL = 1e-8              # dense frames, m and quaternion units (CPU tests: 1e-8)
M_PER_DEG_LAT = 111_320.0
COPY_SWEEP = (   # name, elements of a buffer made on the card, first element copied
    ("probe_8x128", 8 * 128, 0),
    ("ragged_1003", 1003, 0),
    ("l2_1Mi", 1 << 20, 0),
    ("hbm_64Mi_plus_3", (1 << 26) + 3, 0),
    ("misaligned_64Mi", (1 << 26) + 2, 1),     # buf[1:]: 4 bytes off 16-byte alignment
)
L2_BYTES = 50 * 2**20
HBM_GB_S = 3350.0     # H100 SXM device memory, NVIDIA's data sheet


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def kernel_launches(name: str) -> int:
    """The launches of the kernel wrapper ``name`` so far in this process: its
    tally ``<name>.launches`` (``ops/_launch.py``). A count over a call is
    the difference of two readings."""
    return profiling.tallies().get(name + ".launches", 0)


def kernel_runs(fn, *parts):
    """([the device's runs of the kernels whose name holds each of
    ``parts``], result) of one run of ``fn`` under ``torch.profiler``: the
    kernels that a CUDA graph's replay runs are counted too, which
    ``kernel_launches`` (the host's launches) does not see."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    return [sum(part in n for n in names) for part in parts], out


def device_phase():
    check(torch.cuda.is_available(), "CUDA is not available; this script runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(f"device: {torch.cuda.get_device_name(dev)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible")
    return dev


def _host_us(fn, reps=100, rounds=5):
    """Median over ``rounds`` of the host's microseconds per call across
    ``reps`` calls that are not waited for: the enqueue path."""
    fn()
    per_call = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        per_call.append(1e6 * (time.perf_counter() - t0) / reps)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def copy_sweep(dev):
    """The copy kernel against ``clone`` at each size of COPY_SWEEP: both
    bit for bit equal to the input, both timed (CUDA events, median of 20
    after one warm-up). Returns the copy_f32 record of the kernels line."""
    gen = torch.Generator(device=dev).manual_seed(0)
    sweep, err = {}, 0.0
    for name, n, start in COPY_SWEEP:
        if name == "probe_8x128":
            x = torch.arange(n, dtype=torch.float32, device=dev).reshape(8, 128)
        else:
            x = torch.randn(n, generator=gen, device=dev)[start:]
        y_k, y_r = probe_mod.copy(x), probe_mod.copy_reference(x)
        torch.cuda.synchronize()
        bits = x.view(torch.int32)
        check(torch.equal(y_k.view(torch.int32), bits) and torch.equal(y_r.view(torch.int32), bits),
              f"copy {name}: kernel output differs from its input or the plain version")
        err = max(err, float((y_k - y_r).abs().max()) if x.numel() else 0.0)
        del y_k, y_r
        ms = time_device_ms(lambda: probe_mod.copy(x))
        plain_ms = time_device_ms(lambda: probe_mod.copy_reference(x))
        nbytes = 4 * x.numel()
        rec = {"elements": x.numel(), "ms": ms, "plain_ms": plain_ms,
               "bound_ms": 2 * nbytes / HBM_GB_S / 1e6,
               "gb_s": 2 * nbytes / ms / 1e6, "plain_gb_s": 2 * nbytes / plain_ms / 1e6}
        line = (f"copy {name} ({x.numel()} f32, {nbytes} B): kernel == input == clone bit for "
                f"bit; kernel {ms:.4f} ms {rec['gb_s']:.1f} GB/s, clone {plain_ms:.4f} ms "
                f"{rec['plain_gb_s']:.1f} GB/s")
        if nbytes > L2_BYTES:
            rec["hbm_share"] = rec["gb_s"] / HBM_GB_S
            rec["plain_hbm_share"] = rec["plain_gb_s"] / HBM_GB_S
            line += (f"; of 3.35 TB/s: kernel {100 * rec['hbm_share']:.1f} %, clone "
                     f"{100 * rec['plain_hbm_share']:.1f} %")
        print(line + " (median of 20, CUDA events)")
        sweep[name] = rec
        del x
    torch.cuda.empty_cache()
    probe_x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128)
    main = sweep["probe_8x128"]
    # The plain version is itself the one library call (clone).
    return {"max_abs_err": err, "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": "bytes",
            "library_ms": main["plain_ms"], "library_call": "clone (the plain version)",
            "host_us": _host_us(lambda: probe_mod.copy(probe_x)),
            "plain_host_us": _host_us(lambda: probe_mod.copy_reference(probe_x)),
            "sweep": sweep}


def kernel_phase(dev):
    rng = np.random.default_rng(0)
    cases = {name: make(rng) for name, make in KNN_CASES.items()}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    max_err = 0.0
    for name, arrays in cases.items():
        args = [torch.tensor(a, device=dev) for a in arrays]
        d_k, i_k = knn_mod.knn(*args)
        d_r, i_r = knn_mod.knn_reference(*args)
        torch.cuda.synchronize()
        check(torch.equal(i_k, i_r), f"knn {name}: kernel and plain indices differ")
        check(torch.equal(d_k, d_r), f"knn {name}: kernel and plain distances differ")
        fin = torch.isfinite(d_r)
        err = float((d_k[fin] - d_r[fin]).abs().max()) if fin.any() else 0.0
        max_err = max(max_err, err)
        plan = knn_mod.knn_plan(args[0].shape[0], args[2].shape[0], sms)
        print(f"knn {name}: kernel == plain (idx identical, max |d2 diff| {err}); "
              f"{int(fin.sum())} of {fin.numel()} slots filled; plan {plan}")
    main = [torch.tensor(a, device=dev) for a in cases["main_path"]]
    ms = time_device_ms(lambda: knn_mod.knn(*main))
    plain_ms = time_device_ms(lambda: knn_mod.knn_reference(*main))
    # Yardstick only, not the same function: the GEMM expansion of the
    # distances, no masks, two calls; the port never calls it.
    library_ms = time_device_ms(lambda: torch.topk(torch.cdist(main[0], main[2]), 5,
                                                   largest=False))
    clock = gpu_clock_mhz()
    bound_ms = knn_bound_ms(main[1], main[3], sms, clock)
    per_tile, cluster, split = knn_mod.knn_plan(main[0].shape[0], main[2].shape[0], sms)
    blocks = -(-main[0].shape[0] // per_tile) * cluster
    print(f"knn 5120x16384 k=5: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms, "
          f"topk(cdist) {library_ms:.4f} ms (median of 20, CUDA events); FP32 bound "
          f"{bound_ms:.4f} ms ({sms} SMs at {clock:.0f} MHz), kernel at "
          f"{bound_ms / ms:.2f} of it; plan {per_tile} queries x {cluster} blocks, "
          f"split {split}, {blocks} blocks")

    copy_kern = copy_sweep(dev)
    knn_kern = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": "operations", "library_ms": library_ms,
                "library_call": "torch.topk(torch.cdist(q, p), 5, largest=False): "
                                "yardstick only, GEMM expansion and no masks",
                "blocks": blocks, "cluster": cluster,
                "host_us": _host_us(lambda: knn_mod.knn(*main))}
    print(f"host path per call (enqueue, no sync, median of 5 x 100): knn "
          f"{knn_kern['host_us']:.2f} us, copy 8x128 {copy_kern['host_us']:.2f} us, "
          f"clone 8x128 {copy_kern['plain_host_us']:.2f} us")

    knn_kern["max_abs_err_pairs"] = knn_pair_cases(dev)
    imu_kern = imu_preint_cases(dev)

    pts, valid = cloud(rng, 51200)
    out_c, v_c = neighbors.voxel_downsample(torch.tensor(pts), torch.tensor(valid),
                                            0.4, 16384, scatter_keys=True)
    out_g, v_g = neighbors.voxel_downsample(torch.tensor(pts, device=dev),
                                            torch.tensor(valid, device=dev),
                                            0.4, 16384, scatter_keys=True)
    check(torch.equal(v_g.cpu(), v_c) and torch.equal(out_g.cpu(), out_c),
          "voxel_downsample differs between the card and the CPU")
    print(f"voxel_downsample 51200 -> 16384: card == CPU ({int(v_c.sum())} kept)")
    return knn_kern, copy_kern, imu_kern


def imu_preint_cases(dev):
    """The IMU preintegration kernel against its loop on the same card
    tensors, every field within 1e-10 (the loop's own bound against JAX),
    on ``IMU_PREINT_CASES``; both timed at the window's 4 edges x 40."""
    worst = 0.0
    for name, make in IMU_PREINT_CASES.items():
        args = [torch.tensor(a, device=dev) for a in make(np.random.default_rng(0))]
        got, ref = imu_factors.preintegrate(*args), imu_factors.preintegrate_reference(*args)
        for field, g, r in zip(imu_factors.Preintegrated._fields, got, ref):
            check(torch.allclose(g, r, rtol=1e-10, atol=1e-10),
                  f"imu_preint {name} {field}: kernel and loop differ beyond 1e-10")
            worst = max(worst, float((g - r).abs().max()) if g.numel() else 0.0)
    window = [torch.tensor(a, device=dev)
              for a in IMU_PREINT_CASES["window_4x40"](np.random.default_rng(0))]
    ms = time_device_ms(lambda: imu_factors.preintegrate(*window))
    plain_ms = time_device_ms(lambda: imu_factors.preintegrate_reference(*window))
    print(f"imu_preint: kernel == loop within 1e-10 on {len(IMU_PREINT_CASES)} cases (max "
          f"|diff| {worst:.3g}); window 4 x 40: kernel call {ms:.4f} ms, loop {plain_ms:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def knn_pair_cases(dev):
    """The batched 5-NN entry against its plain version, bit for bit, on
    ``KNN_PAIR_CASES``, one launch each; returns the largest |d2|
    difference (0)."""
    rng = np.random.default_rng(1)
    max_err = 0.0
    for name, make in KNN_PAIR_CASES.items():
        world, valid, i_idx, j_idx = make(rng)
        args = [torch.tensor(a, device=dev) for a in (world, valid, i_idx, j_idx)]
        before = kernel_launches("knn_pairs")
        d_k, i_k = knn_mod.knn_pairs(*args)
        launched = kernel_launches("knn_pairs") - before
        d_r, i_r = knn_mod.knn_pairs_reference(*args)
        torch.cuda.synchronize()
        check(launched == 1, f"knn_pairs {name}: {launched} launches, not 1")
        check(torch.equal(i_k, i_r), f"knn_pairs {name}: kernel and plain indices differ")
        check(torch.equal(d_k, d_r), f"knn_pairs {name}: kernel and plain distances differ")
        fin = torch.isfinite(d_r)
        err = float((d_k[fin] - d_r[fin]).abs().max()) if fin.any() else 0.0
        max_err = max(max_err, err)
        print(f"knn_pairs {name} ({len(i_idx)} pairs of {world.shape[1]} x {world.shape[1]}): "
              f"kernel == plain ({int(fin.sum())} of {fin.numel()} slots filled); "
              f"{launched} launches")
    return max_err


def bench_config():
    return GlioConfig().replace(
        shapes=ShapeConfig(max_imu_per_interval=40, scan_points=1024, map_points=16384),
        estimator=EstimatorConfig(local_map_width=50, sw_max_iter=15))


def replay_phase(dev):
    cfg = bench_config()
    fx = np.load(FIXTURE)
    check(json.loads(str(fx["config_json"])) == json.loads(json.dumps(dataclasses.asdict(cfg))),
          "the fixture was made with another configuration")
    ep = simulate_episode(n_keyframes=N_KEYFRAMES, scan_points=1024, seed=0)
    est = SlidingWindowEstimator(cfg, dev)
    inputs = ep.to_inputs(dev)
    args = (inputs, ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0)

    t0 = time.perf_counter()
    est.replay(*args)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    before = kernel_launches("knn")
    t0 = time.perf_counter()
    out = est.replay(*args)
    torch.cuda.synchronize()
    ms_per_kf = 1e3 * (time.perf_counter() - t0) / N_KEYFRAMES
    launches = kernel_launches("knn") - before

    check(launches == N_KEYFRAMES,
          f"knn kernel launched {launches} times in {N_KEYFRAMES} keyframes")
    for f in out._fields:
        check(bool(torch.isfinite(getattr(out, f).double()).all()), f"replay output {f} not finite")
    check(tuple(out.p.shape) == (N_KEYFRAMES, 3), f"replay p has shape {tuple(out.p.shape)}")
    nlf = out.n_lidar_factors.cpu().numpy()
    check(np.array_equal(nlf, fx["n_lidar_factors"]),
          f"n_lidar_factors {nlf.tolist()} != JAX {fx['n_lidar_factors'].tolist()}")
    dp = np.abs(out.p.cpu().numpy() - fx["p"]).max(axis=1)
    dq = np.abs(out.q.cpu().numpy() - fx["q"]).max()
    check(dp.max() <= P_TOL_M, f"max |p - p_jax| = {dp.max()} m > {P_TOL_M} m")
    gt_err = np.linalg.norm(out.p.cpu().numpy() - ep.gt_p, axis=1)
    print(f"replay {N_KEYFRAMES} keyframes (width 50, scan 1024, map 16384, 15 LM iters): "
          f"{ms_per_kf:.2f} ms per keyframe (warm-up run {warm_s:.1f} s); "
          f"knn launches {launches}")
    print(f"replay vs JAX fixture: n_lidar_factors equal at all {N_KEYFRAMES} steps; "
          f"max |dp| {dp.max():.3e} m (keyframe {int(dp.argmax())}), max |dq| {dq:.3e}; "
          f"error vs ground truth at the last keyframe {gt_err[-1]:.3f} m")
    return launches


def probe_phase():
    """The probe entry point in a subprocess; returns its copy launches."""
    res = subprocess.run([sys.executable, "-m", "glio_tpu_torch.ops.probe"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    out = res.stdout.strip()
    print("probe: " + out.replace("\n", " | "))
    check(res.returncode == 0 and "CUDA-OK" in out,
          f"probe exited {res.returncode}: {out} {res.stderr[-2000:]}")
    n = re.search(r"copy_f32=(\d+)", out)
    launches = int(n.group(1)) if n else 0
    check(launches == 1, f"the probe reported {launches} copy-kernel launches, not 1")
    return launches


def _checksums(*arrays):
    """(n, 2): sum and sum of squares of each array or tensor, f64."""
    out = []
    for a in arrays:
        a = (a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)).astype(np.float64)
        out.append([a.sum(), (a * a).sum()])
    return np.array(out)


def _ypr_diff(a, b):
    """Largest |a - b| of two yaw/pitch/roll arrays, in degrees, across ±180."""
    return float(np.abs((a - b + 180.0) % 360.0 - 180.0).max())


def _sync_s(fn, reps=1):
    """Mean seconds of ``reps`` calls, each closed by a device sync (none
    where no card is present, as in ``scripts/rehearse_torch_sms1.py``)."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync()
    return (time.perf_counter() - t0) / reps, out


def batch_problem(dev):
    """The batch fixture's problem, built by the port on ``dev``; returns
    (fixture, scenario, cfg, problem, p_true, p_odo, host seconds)."""
    fx = np.load(BATCH_FIXTURE)
    sc = json.loads(str(fx["scenario_json"]))
    cfg = GlioConfig()
    check(json.loads(str(fx["config_json"])) == json.loads(json.dumps(dataclasses.asdict(cfg))),
          "the batch fixture was made with another configuration")
    prob, p_true, p_odo, sim_s, build_s = testing.batch_drive_problem(sc, cfg, dev)
    return fx, sc, cfg, prob, p_true, p_odo, (sim_s, build_s)


def batch_phase(dev):
    fx, sc, cfg, prob, p_true, p_odo, (sim_s, build_s) = batch_problem(dev)
    T = sc["n_keyframes"]
    sums = _checksums(prob.p_odo, prob.psr_rov, prob.whiten, prob.ep_valid)
    check(np.allclose(sums, fx["checksums"], rtol=1e-12, atol=0),
          f"the port's problem is not the fixture's: checksums {sums.tolist()} "
          f"!= {fx['checksums'].tolist()}")
    E = prob.ep_left.shape[0]
    print(f"batch problem T={T}, E={E} epochs ({int(prob.ep_valid.sum())} bound), "
          f"checksums equal to the fixture's; simulate {sim_s:.2f} s, "
          f"build_problem {build_s:.2f} s (host)")

    robust = batch_mod.RobustOpts(dd_huber=sc["dd_huber"], epoch_gate=sc["epoch_gate"],
                                  rel_huber=sc["rel_huber"])
    thresholds = tuple(sc["thresholds"])
    n_iter = len(thresholds) * sc["lm_iters"]

    def solve():
        return batch_mod.optimize_batch(cfg, prob, thresholds=thresholds,
                                        lm_iters=sc["lm_iters"], solver=sc["solver"],
                                        robust=robust)

    warm_s, (p1, q1, costs1) = _sync_s(solve)
    solve_s, (p2, q2, costs2) = _sync_s(solve)
    check(torch.equal(p1, p2) and torch.equal(q1, q2) and costs1 == costs2,
          "two batch solves on the card differ")
    for name, a in (("p", p2), ("q", q2)):
        check(bool(torch.isfinite(a).all()), f"batch {name} not finite")
    check(tuple(p2.shape) == (T, 3), f"batch p has shape {tuple(p2.shape)}")
    p = p2.cpu().numpy()
    q = q2.cpu().numpy()
    d64 = np.abs(p - fx["p_f64"]).max()
    dmix = np.abs(p - fx["p_mixed"]).max()
    dq64 = np.abs(q - fx["q_f64"]).max()
    check(d64 <= BATCH_F64_TOL_M, f"max |p - p_jax_f64| = {d64} m > {BATCH_F64_TOL_M} m")
    check(dmix <= BATCH_MIXED_TOL_M, f"max |p - p_jax_mixed| = {dmix} m > {BATCH_MIXED_TOL_M} m")
    rmse = float(np.sqrt(np.mean(np.sum((p - p_true) ** 2, -1))))
    rmse_odo = float(np.sqrt(np.mean(np.sum((p_odo - p_true) ** 2, -1))))
    print(f"batch solve (4 stages x {sc['lm_iters']} LM iters, direct): {solve_s:.3f} s, "
          f"{1e3 * solve_s / n_iter:.2f} ms per LM iteration (warm-up run {warm_s:.2f} s); "
          f"two runs bit-identical; costs {costs2}")
    print(f"batch vs JAX: max |dp| {d64:.3e} m against f64 (tol {BATCH_F64_TOL_M}), "
          f"{dmix:.3e} m against mixed (tol {BATCH_MIXED_TOL_M}); max |dq| {dq64:.3e} "
          f"against f64; RMSE vs truth {rmse:.4f} m (odometry {rmse_odo:.4f} m)")

    # Layer breakdown at the converged trajectory, each closed by a sync.
    hw = cfg.estimator.search_range + 1
    plan = batch_mod.assembly_plan(prob, hw)
    asm_s, (band, grad, *_) = _sync_s(lambda: batch_mod._assemble_core_impl(
        p2, q2, prob, thresholds[-1], hw, robust=robust, plan=plan), reps=5)
    cr_s, _ = _sync_s(lambda: banded.cyclic_reduction_solve(band, -grad), reps=5)
    cost_s, _ = _sync_s(lambda: batch_mod._total_cost(p2, q2, prob, thresholds[-1]), reps=5)
    cov_s, cov = _sync_s(lambda: batch_mod.batch_marginal_covariance(cfg, prob, p2, q2))
    cal_s, (cov_cal, rep) = _sync_s(lambda: batch_mod.calibrate_batch_covariance(
        cfg, prob, p2, q2, cov))
    check(bool(torch.isfinite(cov).all()) and bool(torch.isfinite(cov_cal).all()),
          "batch covariances not finite")
    check(rep["calibrated"] == bool(fx["calibrated"]), "calibration applied differently")
    # Both covariance functions against JAX's on the same inputs: at JAX's
    # f64 trajectory.
    pj = torch.as_tensor(fx["p_f64"], device=dev)
    qj = torch.as_tensor(fx["q_f64"], device=dev)
    cov_j = batch_mod.batch_marginal_covariance(cfg, prob, pj, qj)
    cov_cal_j, _ = batch_mod.calibrate_batch_covariance(cfg, prob, pj, qj, cov_j)
    cov_diag = torch.diagonal(cov_j, dim1=1, dim2=2).cpu().numpy()
    std_cal = np.sqrt(torch.diagonal(cov_cal_j, dim1=1, dim2=2)[:, :3].cpu().numpy())
    dcov = np.abs(cov_diag - fx["cov_diag"]).max() / np.abs(fx["cov_diag"]).max()
    dstd = np.abs(std_cal - fx["std_cal_p"]).max() / np.abs(fx["std_cal_p"]).max()
    check(dcov <= 1e-6 and dstd <= 1e-6,
          f"covariances differ from JAX's: diag {dcov:.3e}, calibrated std {dstd:.3e} (rel)")
    print(f"batch layers: assembly {1e3 * asm_s:.2f} ms, CR solve {1e3 * cr_s:.2f} ms, "
          f"cost {1e3 * cost_s:.2f} ms; marginal covariance {1e3 * cov_s:.1f} ms, "
          f"calibration {1e3 * cal_s:.1f} ms (host); covariances at JAX's trajectory vs "
          f"JAX: diag {dcov:.3e}, calibrated std {dstd:.3e} (max rel)")
    return dict(sc=sc, cfg=cfg, fx=fx, prob=prob, p=p2, q=q2, solve_s=solve_s)


def sms1_config(base):
    return base.replace(estimator=dataclasses.replace(base.estimator, sms_fusion_level=1))


def _rmse(p, p_true):
    p = p.cpu().numpy() if isinstance(p, torch.Tensor) else p
    return float(np.sqrt(np.mean(np.sum((p - p_true) ** 2, -1))))


def sms1_scenario(dev, fixture=SMS1_FIXTURE):
    """The level-1 fixture's scenario, simulated and built by the port on
    ``dev`` and held to the fixture's checksums: a namespace of the fixture
    ``fx``, its scenario ``sc``, ``cfg``, the episode ``ep``, the odometry
    ``p_odo``, ``q_odo``, the problem ``prob`` and the host seconds
    ``sim_s``, ``build_s``."""
    fx = np.load(fixture)
    sc = json.loads(str(fx["scenario_json"]))
    cfg = sms1_config(GlioConfig())
    check(json.loads(str(fx["config_json"])) == json.loads(json.dumps(dataclasses.asdict(cfg))),
          "the level-1 fixture was made with another configuration")
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    t0 = time.perf_counter()
    ep = simulate_episode(n_keyframes=sc["n_keyframes"], scan_points=sc["scan_points"],
                          seed=sc["seed"])
    gnss = simulate_gnss_epochs(ep.gt_p, ep.kf_time, anchor, station, psr_noise=sc["psr_noise"],
                                epoch_stride=sc["epoch_stride"], seed=sc["seed"])
    p_odo = random_walk_odometry(ep.gt_p, sc["seed"], sc["drift_step"], sc["odo_noise"])
    q_odo = ep.gt_q
    sim_s = time.perf_counter() - t0
    sums = _checksums(ep.scan, ep.scan_valid, ep.imu_acc, ep.imu_gyr, ep.imu_dt, ep.gt_p,
                      ep.gt_q, ep.gt_v)
    check(np.allclose(sums, fx["episode_checksums"], rtol=1e-12, atol=0),
          "the port's episode is not the fixture's")
    build_s, prob = _sync_s(lambda: batch_mod.build_problem(
        cfg, p_odo, q_odo, ep.kf_time, gnss, anchor, 0.0, station, device=dev))
    sums = _checksums(prob.p_odo, prob.psr_rov, prob.whiten, prob.ep_valid, prob.rel_dq)
    check(np.allclose(sums, fx["problem_checksums"], rtol=1e-12, atol=0),
          "the port's level-1 problem is not the fixture's")
    return types.SimpleNamespace(fx=fx, sc=sc, cfg=cfg, ep=ep, p_odo=p_odo, q_odo=q_odo,
                                 prob=prob, sim_s=sim_s, build_s=build_s)


def sms1_against_jax(s, sms, chain, out, dev):
    """The port's level-1 association ``sms`` and solve ``out`` (p, q, v,
    ...) on scenario ``s`` against the fixture's JAX results; raises where a
    gate fails. Returns the readings."""
    fx, sc, cfg, ep = s.fx, s.sc, s.cfg, s.ep
    T = sc["n_keyframes"]
    p, q, v = out[:3]
    # The association: masks, and the point each slot holds.
    mask = sms.mask.cpu().numpy()
    mask_j = np.unpackbits(fx["mask_bits"])[:mask.size].reshape(mask.shape).astype(bool)
    agree = float((mask == mask_j).mean())
    count_eq = float((mask.sum(-1) == fx["mask_count"]).mean())
    score_sum = torch.where(sms.mask, sms.score, torch.zeros_like(sms.score)).sum(-1).cpu().numpy()
    dscore = float(np.abs(score_sum - fx["score_sum"]).max())
    per_r, per_r_j = mask.sum((0, 2)), mask_j.sum((0, 2))
    sel_j = torch.as_tensor(fx["sel_idx"].astype(np.int64), device=dev)
    mask_jt = torch.as_tensor(mask_j, device=dev)
    scans = torch.as_tensor(ep.scan, device=dev)
    frame = torch.arange(T, device=dev)[:, None, None]
    pts_j = scans[frame, torch.where(mask_jt, sel_j, torch.zeros_like(sel_j))].to(torch.float64)
    other = int(((sms.pts_i != pts_j).any(-1) & mask_jt & sms.mask).sum())
    print(f"level-1 association: {int(mask.sum())} slots (JAX {int(mask_j.sum())}; per offset "
          f"{per_r.tolist()} against {per_r_j.tolist()}); masks agree in {100 * agree:.4f} % of "
          f"{mask.size} slots (JAX's own +-1e-9 m nudge changes {int(fx['nudge_mask_differ'])}), "
          f"counts per (keyframe, offset) in {100 * count_eq:.3f} %; {other} slots "
          f"({100 * other / max(int(mask_j.sum()), 1):.3f} %) hold another point than JAX's "
          f"(JAX's own +-1e-9 m nudge: {int(fx['nudge_sel_differ'])}; JAX with its eigensystem "
          f"in f64: {int(fx['f64eig_sel_differ'])}); max |score sum - JAX's| per (keyframe, "
          f"offset) {dscore:.3e}")
    check(agree >= SMS1_MASK_AGREE, f"only {agree} of the slots' masks agree with JAX's")
    readings = {"masks_agree": agree, "other_point_slots": other, "dscore": dscore}
    # The solve. JAX's own result moves ~0.1 m under any f32-scale change of
    # the planarities, through the top-25 selection's near-ties: with its
    # eigensystem in f64, as the port evaluates it, JAX gives ~13.5 k slots
    # another point and lands p_f64eig. So p is held to JAX's f64 solve
    # within 10x JAX's own spread under a +-1e-9 m nudge of the odometry
    # (associated and solved again), and p, q and v to JAX with the port's
    # eigensystem within 10x that spread of each.
    report = []
    for key, i, ref in (("p", 0, "f64"), ("p", 0, "f64eig"), ("q", 1, "f64eig"),
                        ("v", 2, "f64eig"), ("q", 1, "f64"), ("v", 2, "f64"), ("p", 0, "mixed")):
        d = float(np.abs(out[i].cpu().numpy() - fx[f"{key}_{ref}"]).max())
        readings[f"d{key}_{ref}"] = d
        if ref == "f64eig" or (key, ref) == ("p", "f64"):
            tol = 10.0 * float(fx[f"nudge_d{key}"])
            check(d <= tol, f"level 1: max |{key} - JAX {ref}| = {d} > {tol}")
            report.append(f"{key} vs JAX {ref} {d:.3e} (tol {tol:.3e})")
        else:
            report.append(f"{key} vs JAX {ref} {d:.3e}")
    moved = ", ".join(f"{k} {np.abs(fx[k + '_f64eig'] - fx[k + '_f64']).max():.3e}" for k in "pqv")
    print("level 1, max |d|: " + ", ".join(report) + f"; tol = 10x JAX's own spread under a "
          f"+-1e-9 m nudge; JAX with its eigensystem in f64 moves {moved} from JAX f64")
    return readings


def sms1_phase(dev):
    """Batch level 1 at the Whampoa length on the card, against
    ``tests/data/sms1_T3493_seed4.npz``. Returns the knn5_pairs_f32 record
    and (scenario, association, IMU chains) for phase 17."""
    s = sms1_scenario(dev)
    fx, sc, cfg, ep, p_odo, q_odo, prob = s.fx, s.sc, s.cfg, s.ep, s.p_odo, s.q_odo, s.prob
    T, R = sc["n_keyframes"], cfg.estimator.search_range
    print(f"level-1 episode T={T}, {sc['scan_points']} points a scan "
          f"({100 * float(ep.scan_valid.mean()):.2f} % valid), {int(prob.ep_valid.sum())} GNSS "
          f"epochs bound; episode and problem checksums equal to the fixture's; simulate "
          f"{s.sim_s:.2f} s, build_problem {s.build_s:.2f} s (host)")

    # The batched kernel on 256 of this episode's keyframe pairs, every offset.
    world = batch_mod.world_points(torch.as_tensor(ep.scan, device=dev),
                                   torch.as_tensor(p_odo, device=dev),
                                   torch.as_tensor(q_odo, device=dev))
    valid = torch.as_tensor(ep.scan_valid, device=dev)
    i_all, j_all, _ = batch_mod.sms1_pairs(T, R, dev)
    n_pairs = i_all.shape[0]
    pick = torch.linspace(0, n_pairs - 1, 256, device=dev).round().long()
    ii, jj = i_all[pick].contiguous(), j_all[pick].contiguous()
    d_k, i_k = knn_mod.knn_pairs(world, valid, ii, jj)
    d_r, i_r = knn_mod.knn_pairs_reference(world, valid, ii, jj)
    torch.cuda.synchronize()
    check(torch.equal(i_k, i_r) and torch.equal(d_k, d_r),
          "knn_pairs on the episode's pairs: kernel and plain differ")
    print(f"knn_pairs on 256 of the episode's {n_pairs} pairs: kernel == plain bit for bit")
    del d_k, i_k, d_r, i_r

    # The main path: association, IMU chains, 15-dof solve (warm-up, then timed).
    thresholds = tuple(sc["thresholds"])
    n_iter = len(thresholds) * sc["lm_iters"]

    def solve():
        return batch_mod.optimize_batch_sms1_imu(cfg, prob, sms, chain, thresholds=thresholds,
                                                 lm_iters=sc["lm_iters"], solver=sc["solver"])

    before = kernel_launches("knn_pairs")
    assoc_s, sms = _sync_s(lambda: batch_mod.build_sms1(cfg, ep.scan, ep.scan_valid, p_odo,
                                                        q_odo, device=dev))
    chain_s, chain = _sync_s(lambda: batch_mod.build_imu_chain(
        cfg, ep.imu_acc, ep.imu_gyr, ep.imu_dt, ep.imu_valid, device=dev))
    warm_s, out1 = _sync_s(solve)
    launches = kernel_launches("knn_pairs") - before
    want = -(-n_pairs // batch_mod.SMS1_CHUNK)
    check(launches == want, f"knn_pairs launched {launches} times, the association's "
                            f"chunking says {want}")
    solve_s, out2 = _sync_s(solve)
    check(all(torch.equal(a, b) for a, b in zip(out1[:5], out2[:5])) and out1[5] == out2[5],
          "two level-1 solves on the card differ")
    p, q, v, ba, bg, costs = out2
    for name, a in zip(("p", "q", "v", "ba", "bg"), (p, q, v, ba, bg)):
        check(bool(torch.isfinite(a).all()), f"level-1 {name} not finite")
    check(tuple(p.shape) == (T, 3) and tuple(v.shape) == (T, 3), "level-1 state shapes")

    sms1_against_jax(s, sms, chain, out2, dev)
    p0, _, _ = batch_mod.optimize_batch(cfg, prob, lm_iters=sc["lm_iters"])
    print(f"level-1 solve (4 stages x {sc['lm_iters']} LM iters, 15-dof, direct): "
          f"{solve_s:.3f} s, {1e3 * solve_s / n_iter:.2f} ms per LM iteration (warm-up run "
          f"{warm_s:.2f} s); two runs bit-identical; costs {costs} (JAX f64 "
          f"{fx['costs_f64'].tolist()})")
    print(f"RMSE vs truth: odometry {_rmse(p_odo, ep.gt_p):.4f} m, level 0 "
          f"{_rmse(p0, ep.gt_p):.4f} m, level 1 {_rmse(p, ep.gt_p):.4f} m (JAX f64 level 1 "
          f"{_rmse(fx['p_f64'], ep.gt_p):.4f} m)")

    # Breakdowns, each part closed by a sync.
    timings = {}
    batch_mod.build_sms1(cfg, ep.scan, ep.scan_valid, p_odo, q_odo, device=dev,
                         timings=timings)
    print(f"level-1 association {assoc_s:.3f} s for {n_pairs} pairs in {launches} chunks "
          f"(each step synced: knn {timings['knn']:.3f} s, gather + plane fit "
          f"{timings['planes']:.3f} s, selection {timings['select']:.3f} s); build_imu_chain "
          f"{chain_s:.3f} s")
    hw = R + 1
    plan = batch_mod.assembly_plan(prob, hw)
    imu_plan = batch_mod.imu_chain_plan(T, hw, dev)
    gravity = batch_mod._imu_params(cfg).gravity_vec(dev)
    state = (p, q, v, ba, bg)
    th = thresholds[-1]
    pose_s, _ = _sync_s(lambda: batch_mod._assemble_sms1_pose(p, q, prob, sms, th, hw, plan),
                        reps=3)
    imu_s, _ = _sync_s(lambda: batch_mod._imu_chain_jacobians(*state, chain, gravity), reps=3)
    sys_s, (band, grad) = _sync_s(lambda: batch_mod._sms1_imu_system(
        *state, prob, sms, chain, th, hw, plan, imu_plan, gravity), reps=3)
    batch_mod._damp(band, torch.tensor(1e-4, dtype=torch.float64, device=dev), hw)
    cr_s, dx = _sync_s(lambda: banded.cyclic_reduction_solve(band, -grad), reps=3)
    check(bool(torch.isfinite(dx).all()), "15-dof CR solve not finite")
    cost_s, _ = _sync_s(lambda: batch_mod._sms1_imu_cost(*state, prob, sms, chain, th, gravity),
                        reps=3)
    print(f"level-1 LM iteration parts: pose assembly {1e3 * pose_s:.2f} ms, IMU Jacobians "
          f"{1e3 * imu_s:.2f} ms (15-dof system with both {1e3 * sys_s:.2f} ms), 15-dof CR "
          f"solve {1e3 * cr_s:.2f} ms (band {T} x {2 * hw + 1} x 15 x 15), cost "
          f"{1e3 * cost_s:.2f} ms")

    # The batched kNN: all pairs in one launch, and one association chunk
    # against its plain version and a yardstick.
    sms_count = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = gpu_clock_mhz()
    all_ms = time_device_ms(lambda: knn_mod.knn_pairs(world, valid, i_all, j_all), reps=5)
    all_bound = knn_pairs_bound_ms(valid, i_all, j_all, sms_count, clock)
    ci, cj = i_all[:batch_mod.SMS1_CHUNK], j_all[:batch_mod.SMS1_CHUNK]
    d_k, i_k = knn_mod.knn_pairs(world, valid, ci, cj)
    d_r, i_r = knn_mod.knn_pairs_reference(world, valid, ci, cj)
    check(torch.equal(i_k, i_r) and torch.equal(d_k, d_r),
          "knn_pairs on the timed association chunk: kernel and plain differ")
    del d_k, i_k, d_r, i_r
    ms = time_device_ms(lambda: knn_mod.knn_pairs(world, valid, ci, cj))
    plain_ms = time_device_ms(lambda: knn_mod.knn_pairs_reference(world, valid, ci, cj), reps=2)
    # Yardstick only, not the same function: batched GEMM-expanded
    # distances and topk, no masks; the port never calls it.
    library_ms = time_device_ms(lambda: torch.topk(torch.cdist(world[ci], world[cj]), 5,
                                                   largest=False), reps=5)
    bound_ms = knn_pairs_bound_ms(valid, ci, cj, sms_count, clock)
    print(f"knn_pairs, all {n_pairs} pairs in one launch: {all_ms:.4f} ms against its FP32 "
          f"bound {all_bound:.4f} ms ({all_bound / all_ms:.3f} of it); one association chunk "
          f"of {len(ci)} pairs (kernel == plain bit for bit): kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms, batched "
          f"topk(cdist) {library_ms:.4f} ms (yardstick), bound {bound_ms:.4f} ms (CUDA events, "
          f"median)")
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations", "library_ms": library_ms,
            "library_call": "torch.topk(torch.cdist(qi, pj), 5, largest=False) over the "
                            "chunk's pairs: yardstick only, GEMM expansion and no masks",
            "shape": f"{len(ci)} pairs of {world.shape[1]} x {world.shape[1]}",
            "all_pairs": n_pairs, "all_pairs_ms": all_ms, "all_pairs_bound_ms": all_bound}, (
        s, sms, chain)


def pipeline_phase(dev, level=0):
    """``run_pipeline`` on 15 bench-shape keyframes, its batch stage at
    ``level``, against the JAX pipeline's CSV rows."""
    fx = np.load(PIPE_FIXTURE if level == 0 else PIPE_SMS1_FIXTURE)
    sc = json.loads(str(fx["scenario_json"]))
    cfg = bench_config() if level == 0 else sms1_config(bench_config())
    check(json.loads(str(fx["config_json"])) == json.loads(json.dumps(dataclasses.asdict(cfg))),
          "the pipeline fixture was made with another configuration")
    n = sc["n_keyframes"]
    ep = simulate_episode(n_keyframes=n, scan_points=sc["scan_points"], seed=sc["seed"])
    anchor = np.asarray(cfg.initialization.anc_ecef)
    ep.gnss = simulate_gnss_epochs(ep.gt_p, ep.kf_time, anchor,
                                   np.asarray(cfg.initialization.station_ecef),
                                   epoch_stride=sc["epoch_stride"], seed=sc["gnss_seed"])
    ep.anchor_ecef = anchor
    with tempfile.TemporaryDirectory() as tmp:
        before = kernel_launches("knn"), kernel_launches("knn_pairs")
        run_s, res = _sync_s(lambda: run_pipeline(ep, cfg, out_dir=tmp, device=dev))
        launches = kernel_launches("knn") - before[0]
        pair_launches = kernel_launches("knn_pairs") - before[1]
        rows = {name: np.loadtxt(os.path.join(tmp, name + ".csv"), delimiter=",", ndmin=2,
                                 skiprows=3 if name.endswith("cov") else 0)
                for name in ("tc_sw_result", "tc_batch_result", "tc_batch_cov", "lc_result")}
    check(launches == n, f"knn kernel launched {launches} times in {n} keyframes")
    want_pairs = 0 if level == 0 else -(-sum(max(n - r - 1, 0) for r in range(
        cfg.estimator.search_range)) // batch_mod.SMS1_CHUNK)
    check(pair_launches == want_pairs,
          f"knn_pairs launched {pair_launches} times, level {level} says {want_pairs}")
    for f in ("p_sw", "q_sw", "p_batch", "q_batch", "cov_batch", "cov_batch_cal", "p_lc", "q_lc"):
        check(np.isfinite(getattr(res, f)).all(), f"pipeline {f} not finite")
    if level == 0:
        check(np.array_equal(res.n_lidar_factors, fx["n_lidar_factors"]),
              f"n_lidar_factors {res.n_lidar_factors.tolist()} != JAX "
              f"{fx['n_lidar_factors'].tolist()}")
    # Stage 1 against JAX's within the replay's tolerances. Stage 2 against
    # JAX's pipeline with its batch solve in f64 (the port's arithmetic):
    # level 0 within the replay's tolerances, which stage 1 hands on; level
    # 1, which re-associates at the stage-1 poses, within this run's stage-1
    # difference times JAX's measured gain from a stage-1 difference to its
    # level-1 batch's, plus 10x JAX's own spread under a +-1e-9 m nudge of
    # stage 1. Against JAX's mixed-precision main path: that plus 10x JAX's
    # own mixed-versus-f64 distance on this episode (yaw/pitch/roll not
    # held at level 0, where that distance reaches 10 deg). Stage 3 starts
    # from stage 1: within this run's stage-1 position and yaw/pitch/roll
    # differences times JAX's gains from each to its stage 3's, plus 10x
    # JAX's own spread under a +-1e-9 m nudge of stage 1 (``lc_*`` keys).
    jax_gap = np.abs(fx["tc_batch_result"][:, 9:12] - fx["tc_batch_result_f64"][:, 9:12]).max()
    jax_gap_ypr = _ypr_diff(fx["tc_batch_result"][:, 6:9], fx["tc_batch_result_f64"][:, 6:9])
    report = []
    for name, key in (("tc_sw_result", "tc_sw_result"), ("tc_batch_result", "tc_batch_result_f64"),
                      ("tc_batch_result", "tc_batch_result"), ("lc_result", "lc_result")):
        got, want = rows[name], fx[key]
        check(got.shape == want.shape, f"{name}: {got.shape} rows, JAX {want.shape}")
        check(np.array_equal(got[:, :3], want[:, :3]), f"{name}: times differ")
        d_pos = max(np.abs(got[:, 9:12] - want[:, 9:12]).max(),
                    np.abs(got[:, 5] - want[:, 5]).max())
        # lat/lon are written to 1e-8 degrees, ~1.1 mm: add that rounding.
        d_ll = M_PER_DEG_LAT * np.abs(got[:, 3:5] - want[:, 3:5]).max()
        d_ypr = _ypr_diff(got[:, 6:9], want[:, 6:9])
        if key == "tc_sw_result":
            tol, tol_ypr, d_sw, d_sw_ypr = P_TOL_M, YPR_TOL_DEG, d_pos, d_ypr
        elif key == "lc_result":
            tol = (float(fx["lc_gain_p_per_m"]) * d_sw + float(fx["lc_gain_p_per_deg"]) * d_sw_ypr
                   + 10.0 * float(fx["lc_nudge_dp"]))
            tol_ypr = (float(fx["lc_gain_ypr_per_m"]) * d_sw
                       + float(fx["lc_gain_ypr_per_deg"]) * d_sw_ypr
                       + 10.0 * float(fx["lc_nudge_ypr"]))
        elif key == "tc_batch_result_f64":
            tol, tol_ypr = (P_TOL_M, YPR_TOL_DEG) if level == 0 else (
                float(fx["gain_p_per_m"]) * d_sw + 10.0 * float(fx["nudge_dp"]),
                float(fx["gain_ypr_per_m"]) * d_sw + 10.0 * float(fx["nudge_ypr"]))
            tol_f64, tol_ypr_f64 = tol, tol_ypr
        else:
            tol = tol_f64 + 10.0 * jax_gap
            tol_ypr = None if level == 0 else tol_ypr_f64 + 10.0 * jax_gap_ypr
        check(d_pos <= tol and d_ll <= tol + 1.2e-3,
              f"{name}: positions differ from JAX's {key} by {d_pos} m, lat/lon by "
              f"{d_ll} m (tol {tol})")
        check(tol_ypr is None or d_ypr <= tol_ypr,
              f"{name}: yaw/pitch/roll differ from JAX's {key} by {d_ypr} deg (tol {tol_ypr})")
        report.append(f"{name} vs {key}: max ENU/alt diff {d_pos:.3e} m, lat/lon "
                      f"{d_ll:.3e} m (tol {tol:.3e}), ypr {d_ypr:.3e} deg (tol "
                      + ("not held" if tol_ypr is None else f"{tol_ypr:.3e}") + ")")
    cov_got = rows["tc_batch_cov"]
    check(cov_got.shape == (n, 10) and np.isfinite(cov_got).all(),
          "tc_batch_cov.csv is not the expected table")
    cov_note = ""
    if level == 0:
        cov_want = fx["tc_batch_cov_f64"]
        d_std = (np.abs(cov_got[:, 1:] - cov_want[:, 1:]) / np.abs(cov_want[:, 1:])).max()
        cov_note = f"; tc_batch_cov stds vs f64 max rel diff {d_std:.3e}"
    print(f"pipeline {n} keyframes, batch level {level} (stages 1-3 + covariances, CSVs "
          f"written): {run_s:.2f} s; knn launches {launches}, knn_pairs launches "
          f"{pair_launches}")
    print(f"pipeline level {level} vs JAX: " + "; ".join(report) + cov_note
          + f"; JAX's own mixed-vs-f64 batch distance {jax_gap:.3e} m, {jax_gap_ypr:.3e} deg")
    return launches


def _scenario(path, cfg, config_key="config_json"):
    fx = np.load(path)
    check(json.loads(str(fx[config_key])) == json.loads(json.dumps(dataclasses.asdict(cfg))),
          f"{os.path.basename(path)} was made with another configuration")
    return fx, json.loads(str(fx["scenario_json"]))


def lc_phase(dev):
    """Stage 3 at the Whampoa length on the card: every epoch's DD fix, the
    gate and association, then the LC solve twice, against
    ``tests/data/lc_T3493_seed4.npz``."""
    cfg = GlioConfig()
    fx, sc = _scenario(LC_FIXTURE, cfg)
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    kf_time, p_true, q_true, p_odo = drifted_trajectory(sc["n_keyframes"], sc["max_drift"])
    gnss = simulate_gnss_epochs(p_true, kf_time, anchor, station, psr_noise=sc["psr_noise"],
                                epoch_stride=sc["epoch_stride"], seed=sc["seed"])
    E = gnss.time.shape[0]
    pipeline._dd_fixes(cfg, gnss, anchor, station, dev)          # warm-up
    dd_s, (fix, _, ok, _) = _sync_s(lambda: pipeline._dd_fixes(cfg, gnss, anchor, station, dev))
    ok = ok.cpu().numpy()
    check(np.array_equal(ok, fx["ok"]), f"DD fix ok masks differ from JAX's ({int(ok.sum())} "
                                        f"against {int(fx['ok'].sum())} of {E})")
    d_fix = float(np.abs(fix.cpu().numpy() - fx["fixes"])[ok].max())
    tol_fix = 10.0 * float(fx["nudge_fix"])
    check(d_fix <= tol_fix, f"DD fixes: max |fix - JAX| {d_fix} m > {tol_fix} m")
    ep = types.SimpleNamespace(kf_time=kf_time, gnss=gnss)
    gate_s, (gnss_p, gnss_valid, gnss_sigma) = _sync_s(
        lambda: pipeline.lc_fixes(cfg, ep.gnss, kf_time, anchor, 0.0, station, dev))
    prob = lc_fusion.build_problem(p_odo, q_true, gnss_p, gnss_valid, gnss_sigma, device=dev)
    check(np.array_equal(prob.gnss_valid.cpu().numpy(), fx["gnss_valid"]),
          "the gated and spaced GNSS factors differ from JAX's")
    p0 = torch.as_tensor(p_odo, device=dev)
    q0 = torch.as_tensor(q_true, device=dev)
    warm_s, (p1, q1, c1) = _sync_s(lambda: lc_fusion.solve(prob, p0, q0))
    solve_s, (p2, q2, c2) = _sync_s(lambda: lc_fusion.solve(prob, p0, q0))
    check(torch.equal(p1, p2) and torch.equal(q1, q2) and torch.equal(c1, c2),
          "two LC solves on the card differ")
    check(bool(torch.isfinite(p2).all() & torch.isfinite(q2).all()), "LC result not finite")
    dp = float(np.abs(p2.cpu().numpy() - fx["p_lc"]).max())
    dq = float(np.abs(q2.cpu().numpy() - fx["q_lc"]).max())
    # 10x JAX's own spread under the larger of its two nudges: the
    # odometry's, and the pseudoranges' (the fixes' own rounding carries
    # into the chain).
    tol_p = 10.0 * max(float(fx["nudge_dp"]), float(fx["nudge_fix_dp"]))
    tol_q = 10.0 * max(float(fx["nudge_dq"]), float(fx["nudge_fix_dq"]))
    check(dp <= tol_p and dq <= tol_q,
          f"LC: max |p - JAX| {dp} m (tol {tol_p}), |q - JAX| {dq} (tol {tol_q})")
    print(f"stage 3 T={sc['n_keyframes']}: {E} DD fixes in {1e3 * dd_s:.2f} ms "
          f"({int(ok.sum())} ok, as JAX; max |fix - JAX| {d_fix:.3e} m, tol {tol_fix:.3e}); gate + "
          f"association {1e3 * gate_s:.2f} ms; {int(gnss_valid.sum())} fixes gated in, "
          f"{int(prob.gnss_valid.sum())} factors after the 5 m spacing (as JAX); LC solve "
          f"(8 GN iterations, CR at hw 1) {1e3 * solve_s:.2f} ms (warm-up {1e3 * warm_s:.2f}), "
          f"two runs bit-identical")
    print(f"stage 3 vs JAX: max |dp| {dp:.3e} m (tol {tol_p:.3e}), max |dq| {dq:.3e} (tol "
          f"{tol_q:.3e}); RMSE vs truth: odometry {_rmse(p_odo, p_true):.4f} m, LC "
          f"{_rmse(p2, p_true):.4f} m (JAX {float(fx['rmse_lc']):.4f} m)")


@contextlib.contextmanager
def _timed_fusion():
    """Within the block, each backend-fusion solve (``pipeline._fusion_window``)
    is timed; yields the list of their seconds."""
    fusion_s = []
    window = pipeline._fusion_window

    def timed_window(*args, **kw):
        s, out = _sync_s(lambda: window(*args, **kw))
        fusion_s.append(s)
        return out
    pipeline._fusion_window = timed_window
    try:
        yield fusion_s
    finally:
        pipeline._fusion_window = window


def fusion_phase(dev):
    """Backend fusion at the bench shapes on the divergence scenario, against
    ``tests/data/backend_fusion_w50_seed21.npz``. Returns the kNN launches."""
    cfg = bench_config()
    fx, sc = _scenario(FUSION_FIXTURE, cfg, "config_json_gated")
    T = sc["n_keyframes"]
    ep = divergence_episode(sc, simulate_episode)
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    ep.gnss = simulate_gnss_epochs(ep.gt_p, ep.kf_time, anchor, station, psr_noise=0.5,
                                   epoch_stride=sc["epoch_stride"], seed=sc["seed"])
    buf = io.StringIO()
    with _timed_fusion() as fusion_s, contextlib.redirect_stdout(buf):
        before = kernel_launches("knn")
        run_s, (p, q) = _sync_s(lambda: pipeline.replay_with_backend_fusion(
            cfg, ep, ep.to_inputs(dev), anchor, 0.0, station, every=sc["every"],
            fusion_span=sc["fusion_span"], debug=True))
        launches = kernel_launches("knn") - before
    lines = buf.getvalue().splitlines()
    # (The plain version on the CPU launches nothing: the CPU rehearsal.)
    check(dev.type != "cuda" or launches == T,
          f"knn launched {launches} times in {T} keyframes of backend fusion")
    check(np.isfinite(p).all() and np.isfinite(q).all(), "backend fusion output not finite")
    got, want = reset_decisions(lines), reset_decisions(json.loads(str(fx["lines_gated"])))
    err = np.linalg.norm(p - ep.gt_p, axis=-1)
    err_j = np.linalg.norm(fx["p_gated"] - ep.gt_p, axis=-1)
    if bool(fx["decisions_stable"]):
        check(got == want, f"reset decisions {got} != JAX's {want}")
        gate = "equal to JAX's (stable under JAX's own +-1e-9 m nudges of p0)"
    else:
        check(err[-8:].min() < 6.0, f"no re-lock in the last 8 keyframes: {err[-8:]}")
        gate = f"JAX's {want} are not stable under nudges: phase-robust criteria held"
    dp = float(np.abs(p - fx["p_gated"]).max())
    tol = 10.0 * float(fx["nudge_dp"])
    check(dp <= tol, f"backend fusion: max |p - JAX| {dp} m > {tol} m")
    replay_s = run_s - sum(fusion_s)
    print(f"backend fusion {T} keyframes (every {sc['every']}, span {sc['fusion_span']}, bench "
          f"shapes): {1e3 * run_s / T:.1f} ms per keyframe ({run_s:.2f} s; "
          f"{len(fusion_s)} fusion solves, {statistics.mean(fusion_s):.3f} s each, "
          f"{sum(fusion_s):.2f} s in all; the rest {1e3 * replay_s / T:.1f} ms per keyframe); "
          f"knn launches {launches}")
    print(f"backend fusion resets {got}: {gate}; max |p - JAX| {dp:.3e} m (tol {tol:.3e}: 10x "
          f"JAX's own nudge spread); error vs truth, last 8 keyframes: mean {err[-8:].mean():.2f} "
          f"m, min {err[-8:].min():.2f} m (JAX {err_j[-8:].mean():.2f}, {err_j[-8:].min():.2f})")
    return launches


def loop_phase(dev):
    """Loop closure on a two-lap drive of 1024-point scans, against
    ``tests/data/loop_closure_seed17.npz``. Returns (kNN launches, the
    kNN's record at the ICP's shape)."""
    cfg = bench_config()
    cfg = cfg.replace(estimator=dataclasses.replace(
        cfg.estimator, loop_closure_on=True, lc_search_radius=15.0, lc_time_thres=10.0,
        lc_icp_thres=0.3))
    fx, sc = _scenario(LOOP_FIXTURE, cfg)
    est = cfg.estimator
    ep, p_drift = loop_episode(sc, simulate_episode)
    q = ep.gt_q
    cands = loop_closure.detect_loops(p_drift, ep.kf_time, search_radius=est.lc_search_radius,
                                      time_thresh=est.lc_time_thres)
    check(np.array_equal(np.array([tuple(c) for c in cands]).reshape(-1, 2), fx["cands"]),
          f"loop candidates {cands} differ from JAX's {fx['cands'].tolist()}")
    before = kernel_launches("knn")
    run_s, (p, q_out, n_edges) = _sync_s(
        lambda: pipeline.apply_loop_closure(cfg, ep, p_drift, q, device=dev))
    launches = kernel_launches("knn") - before
    check(dev.type != "cuda" or launches == 3 * len(cands),
          f"knn launched {launches} times for {len(cands)} candidates, not 3 each")
    check(n_edges == int(fx["n_edges"]), f"{n_edges} loop edges, JAX {int(fx['n_edges'])}")
    check(np.isfinite(p).all() and np.isfinite(q_out).all(), "loop closure output not finite")
    # Each candidate's ICP apart (launches not counted above).
    w = max(est.lc_map_width // 2, 1)
    T = p_drift.shape[0]
    f = lambda a, dt=torch.float64: torch.as_tensor(np.asarray(a), device=dev).to(dt)
    icp_s, icp_dp, flags = [], [], []
    for k, c in enumerate(cands):
        j0, j1 = max(c.old - w, 0), min(c.old + w + 1, T)
        args = (f(ep.scan[c.cur], torch.float32), f(ep.scan_valid[c.cur], torch.bool),
                f(ep.scan[j0:j1], torch.float32), f(ep.scan_valid[j0:j1], torch.bool),
                f(p_drift[j0:j1]), f(q[j0:j1]), f(p_drift[c.cur]), f(q[c.cur]))
        t, (p_c, _, _, ok) = _sync_s(lambda: loop_closure.verify_loop(cfg, *args))
        icp_s.append(t)
        flags.append(bool(ok))
        icp_dp.append(float(np.abs(p_c.cpu().numpy() - fx["icp_p"][k]).max()))
    check(flags == fx["icp_accepted"].tolist(), f"accepted flags {flags} != JAX's "
                                                f"{fx['icp_accepted'].tolist()}")
    dp = float(np.abs(p - fx["p"]).max())
    tol = 10.0 * float(fx["nudge_f32_dp"])
    check(dp <= tol, f"loop closure: max |p - JAX| {dp} m > {tol} m")
    g_true = ep.gt_p[-1] - ep.gt_p[0]
    z_after = abs((p[-1] - p[0])[2] - g_true[2])
    print(f"loop closure ({T} keyframes, {len(cands)} candidates, map width "
          f"{est.lc_map_width}): {run_s:.2f} s through apply_loop_closure; knn launches "
          f"{launches}; {n_edges} edges (as JAX), accepted flags as JAX's; one ICP "
          f"(3 rounds) {1e3 * statistics.mean(icp_s):.1f} ms on average; max |p_icp - JAX| "
          f"{max(icp_dp):.3e} m; corrected chain max |p - JAX| {dp:.3e} m (tol {tol:.3e}: 10x "
          f"JAX's own spread under a 1e-5 m nudge, the f32 resolution of the world points; "
          f"under 1e-9 m: {float(fx['nudge_dp']):.3e}); closure z error {z_after:.3f} m "
          f"(before {float(fx['z_before']):.3f}, JAX after {float(fx['z_after']):.3f})")
    return launches, (ep, p_drift, q, cands, w)


def loop_kernel(dev, ep, p_drift, q, cands, w):
    """The 5-NN at loop closure's ICP shape, kernel against plain bit for
    bit, and timed: the first candidate with a full local map, its first
    round's queries. Returns the kNN's record at that shape."""
    T = p_drift.shape[0]
    f = lambda a, dt=torch.float64: torch.as_tensor(np.asarray(a), device=dev).to(dt)
    k = next(i for i, c in enumerate(cands) if c.old - w >= 0 and c.old + w + 1 <= T)
    c = cands[k]
    mp, mv = loop_closure.local_map(f(ep.scan[c.old - w:c.old + w + 1], torch.float32),
                                    f(ep.scan_valid[c.old - w:c.old + w + 1], torch.bool),
                                    f(p_drift[c.old - w:c.old + w + 1]),
                                    f(q[c.old - w:c.old + w + 1]))
    qry = loop_closure.place(f(ep.scan[c.cur], torch.float32), f(p_drift[c.cur]), f(q[c.cur]))
    qv = f(ep.scan_valid[c.cur], torch.bool).contiguous()
    d_k, i_k = knn_mod.knn(qry, qv, mp, mv)
    d_r, i_r = knn_mod.knn_reference(qry, qv, mp, mv)
    torch.cuda.synchronize()
    check(torch.equal(i_k, i_r) and torch.equal(d_k, d_r),
          "knn at the loop-closure ICP's shape: kernel and plain differ")
    fin = torch.isfinite(d_r)
    err = float((d_k[fin] - d_r[fin]).abs().max()) if fin.any() else 0.0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ms = time_device_ms(lambda: knn_mod.knn(qry, qv, mp, mv))
    plain_ms = time_device_ms(lambda: knn_mod.knn_reference(qry, qv, mp, mv))
    library_ms = time_device_ms(lambda: torch.topk(torch.cdist(qry, mp), 5, largest=False))
    bound_ms = knn_bound_ms(qv, mv, sms, gpu_clock_mhz())
    shape = f"{qry.shape[0]} x {mp.shape[0]}"
    print(f"knn at loop verify {shape} (candidate {tuple(c)}): kernel == plain bit for bit; "
          f"kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms, topk(cdist) {library_ms:.4f} ms "
          f"(yardstick), FP32 bound {bound_ms:.4f} ms ({bound_ms / ms:.2f} of it)")
    return {"shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "library_ms": library_ms, "max_abs_err": err, "launches_per_candidate": 3}


def dense_phase(dev):
    """Dense-frame interpolation and the map export at the bench scan width,
    against ``tests/data/dense_pcd_seed19.npz``."""
    cfg = GlioConfig()
    fx, sc = _scenario(DENSE_FIXTURE, cfg)
    est = cfg.estimator
    ep, kf_p = dense_episode(sc, simulate_episode)
    f = lambda a: torch.as_tensor(np.asarray(a, float), device=dev)
    args = (f(kf_p), f(ep.gt_q), f(ep.dense_rel_dp), f(ep.dense_rel_dq),
            torch.as_tensor(ep.dense_rel_valid, device=dev))
    local_graph.interpolate_segments(*args, max_dense=sc["dense_frames"])
    dense_s, (p_d, q_d, v_d) = _sync_s(
        lambda: local_graph.interpolate_segments(*args, max_dense=sc["dense_frames"]))
    check(np.array_equal(v_d.cpu().numpy(), fx["dense_valid"]), "dense validity differs")
    dp = float(np.abs(p_d.cpu().numpy() - fx["p_dense"]).max())
    dq = float(np.abs(q_d.cpu().numpy() - fx["q_dense"]).max())
    check(dp <= DENSE_TOL and dq <= DENSE_TOL,
          f"dense frames: max |p - JAX| {dp} m, |q - JAX| {dq} (tol {DENSE_TOL})")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.pcd")

        def export():
            world, valid = pointcloud.assemble_map(ep.scan, ep.scan_valid, kf_p, ep.gt_q,
                                                   every=max(est.mapping_interval, 1),
                                                   ql2b=est.ql2b, tl2b=est.tl2b, device=dev)
            return world, pointcloud.write_pcd(path, world, valid)

        map_s, (world, n) = _sync_s(export)
        pts = pointcloud.read_pcd(path)
    sums = np.array([world.sum(), (world ** 2).sum()])
    check(pts.shape == fx["pcd_points"].shape, f"map.pcd holds {pts.shape[0]} points, JAX's "
                                               f"{fx['pcd_points'].shape[0]}")
    d_pcd = float(np.abs(pts - fx["pcd_points"]).max())
    check(d_pcd <= 1e-4 and np.allclose(sums, fx["world_checksum"], rtol=1e-12, atol=0),
          f"map export differs from JAX's: PCD {d_pcd}, checksums {sums} vs "
          f"{fx['world_checksum']}")
    print(f"dense frames ({tuple(p_d.shape)}, one batched LM over the segments): "
          f"{1e3 * dense_s:.1f} ms; max |p - JAX| {dp:.3e} m, |q - JAX| {dq:.3e} (tol "
          f"{DENSE_TOL}); map export ({n} points, one keyframe in {est.mapping_interval}): "
          f"assemble + write_pcd {1e3 * map_s:.1f} ms; PCD within {d_pcd:.1e} of JAX's, "
          f"checksums to 1e-12")


class _Recorder:
    """Wraps a module's ``knn`` and keeps each call's arguments (tensors
    are not copied; no caller writes to them after the call)."""

    def __init__(self, module):
        self.module, self.calls = module, []

    def __enter__(self):
        self.knn = self.module.knn

        def knn(*args, **kw):
            self.calls.append(args)
            return self.knn(*args, **kw)
        self.module.knn = knn
        return self

    def __exit__(self, *exc):
        self.module.knn = self.knn


def _knn_record(dev, args, label):
    """The 5-NN at one caller's real inputs: kernel against plain bit for
    bit, then kernel, plain and ``topk(cdist)`` timed beside the FP32
    bound of the valid pairs. Returns the record."""
    args = [a.contiguous() for a in args]
    d_k, i_k = knn_mod.knn(*args)
    d_r, i_r = knn_mod.knn_reference(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    check(torch.equal(i_k, i_r) and torch.equal(d_k, d_r),
          f"knn at {label}: kernel and plain differ")
    fin = torch.isfinite(d_r)
    err = float((d_k[fin] - d_r[fin]).abs().max()) if fin.any() else 0.0
    shape = f"{args[0].shape[0]} x {args[2].shape[0]}"
    rec = {"shape": shape, "max_abs_err": err,
           "valid_pairs": int(args[1].sum()) * int(args[3].sum())}
    if dev.type == "cuda":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rec.update(ms=time_device_ms(lambda: knn_mod.knn(*args)),
                   plain_ms=time_device_ms(lambda: knn_mod.knn_reference(*args)),
                   library_ms=time_device_ms(lambda: torch.topk(torch.cdist(args[0], args[2]), 5,
                                                                largest=False)),
                   bound_ms=knn_bound_ms(args[1], args[3], sms, gpu_clock_mhz()))
        print(f"knn at {label} {shape}: kernel == plain bit for bit; kernel {rec['ms']:.4f} ms, "
              f"plain torch {rec['plain_ms']:.4f} ms, topk(cdist) {rec['library_ms']:.4f} ms "
              f"(yardstick), FP32 bound {rec['bound_ms']:.4f} ms for its "
              f"{rec['valid_pairs']} valid pairs ({rec['bound_ms'] / rec['ms']:.2f} of it)")
    else:
        print(f"knn at {label} {shape}: kernel == plain (the CPU runs the plain version)")
    return rec


def raw_input_phase(dev):
    """Raw sensor input at the HDL-32E width: a bz2 ROS1 bag of 20 raycast
    32 x 1800 frames at 10 Hz with the IMU stream, through
    ``ingest.episode_from_rosbag`` (organisation on the host, features and
    odometry on ``dev``) and ``run_pipeline`` (stage 1 with
    ``diverse_select``), against ``tests/data/frontend_hdl32_seed8.npz``.
    Returns (odometry launches, replay launches, the kNN's records at the
    odometry's and the window's shapes)."""
    cfg = raw_config(config_mod)
    fx, sc = _scenario(FRONTEND_FIXTURE, cfg)
    n = sc["n_frames"]
    t0 = time.perf_counter()
    drive, frames, valid = raw_drive(sc, workers=RAYCAST_WORKERS)
    raycast_s = time.perf_counter() - t0
    check(frames_digest(frames, valid) == str(fx["frames_sha256"]),
          "the raycast frames differ from the fixture's")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "drive.bag")
        t0 = time.perf_counter()
        write_raw_bag(path, drive, frames, valid, sc["t0"])
        bag_s, bag_mb = time.perf_counter() - t0, os.path.getsize(path) / 2**20
        print(f"raw input: {n} frames of {sc['rings']} x {sc['cols']} raycast in {raycast_s:.1f} s "
              f"({RAYCAST_WORKERS} host processes; host work, not the pipeline's), digest equal to "
              f"the fixture's; bz2 bag {bag_mb:.1f} MiB written in {bag_s:.1f} s")
        rec = {}
        before = kernel_launches("knn")
        with _Recorder(lidar_odometry) as odo_calls:
            ingest_s, ep = _sync_s(lambda: ingest.episode_from_rosbag(
                path, cfg, n_cols=int(fx["n_cols"]), device=dev, record=rec))
        odo_launches = kernel_launches("knn") - before
    check(dev.type != "cuda" or odo_launches == 2 * n,
          f"knn launched {odo_launches} times in the odometry of {n} frames, not 2 each")

    # The front end against JAX's.
    surf, surf_valid = rec["surf"].cpu().numpy(), rec["surf_valid"].cpu().numpy()
    odo = rec["odom"]
    differ = (surf != fx["surf"]).any((1, 2)) | (surf_valid != fx["surf_valid"]).any(1)
    check(not differ.any(), f"surf clouds differ from JAX's at frames {np.nonzero(differ)[0]}")
    is_kf = odo.is_keyframe.cpu().numpy()
    check(np.array_equal(is_kf, fx["is_keyframe"]),
          f"keyframe flags {is_kf.astype(int)} != JAX {fx['is_keyframe'].astype(int)}")
    # The odometry's plane fits see f32 world points, where JAX's f32 sums
    # (FMA-fused by XLA's CPU) differ from the port's in the last bits; so
    # the poses are held to 10x JAX's own spread under a +-1e-5 m nudge of
    # p0 (the f32 resolution of the map), n_matches to that nudge's change.
    reading = {}
    for key in ("p", "q", "rel_p", "rel_q"):
        got = getattr(odo, key).cpu().numpy()
        reading[key] = float(np.abs(got - fx[f"odo_{key}"]).max())
        tol = 10.0 * float(fx[f"odo_nudge5_d{key}"])
        check(reading[key] <= tol, f"odometry {key}: max |d| {reading[key]} > {tol} "
                                   f"(10x JAX's spread under a +-1e-5 m nudge)")
    nm = odo.n_matches.cpu().numpy()
    nudge_dn = np.abs(fx["nudge_n_matches"] - fx["n_matches"]).max(0)
    dn = np.abs(nm - fx["n_matches"])
    check((dn <= nudge_dn).all(), f"n_matches {nm.tolist()} against JAX {fx['n_matches'].tolist()} "
                                  f"beyond JAX's own nudge spread {nudge_dn.tolist()}")
    # The Episode: IMU bins, attitude and seeds to 1e-12; the dense channel
    # is the odometry's relatives, held as they are.
    for f in ("kf_time", "imu_acc", "imu_gyr", "imu_dt", "p0", "q0", "v0", "acc0", "gyr0"):
        d = float(np.abs(np.asarray(getattr(ep, f), float) - fx["ep_" + f]).max())
        check(d <= EPISODE_TOL, f"episode {f} differs from JAX's by {d}")
    for f in ("imu_valid", "dense_rel_valid", "dense_time"):
        check(np.array_equal(getattr(ep, f), fx["ep_" + f]), f"episode {f} differs from JAX's")
    for f, key in (("dense_rel_dp", "rel_p"), ("dense_rel_dq", "rel_q")):
        d = float(np.abs(getattr(ep, f) - fx["ep_" + f]).max())
        tol = 10.0 * float(fx[f"odo_nudge5_d{key}"])
        check(d <= tol, f"episode {f} differs from JAX's by {d} > {tol}")
    check(np.array_equal(ep.scan, fx["surf"][fx["is_keyframe"]]), "episode scans differ")
    T = ep.kf_time.shape[0]
    pre_ms = 1e3 * rec["preprocess_s"] / n
    odo_ms = 1e3 * rec["odometry_s"] / n
    print(f"ingest {ingest_s:.2f} s: bag read + parse {rec['read_s']:.2f} s, organise "
          f"{1e3 * rec['organize_s'] / n:.1f} ms per scan (host), preprocessing {pre_ms:.2f} ms "
          f"per scan, odometry {odo_ms:.2f} ms per frame (against the {SCAN_PERIOD_MS:.0f} ms scan "
          f"period; the reference caps its solve at {SOLVE_CAP_MS:.0f} ms); knn launches "
          f"{odo_launches} ({odo_launches / n:.1f} per frame); {T} keyframes of {n} frames")
    print(f"front end vs JAX: surf clouds and masks equal at all {n} frames "
          f"({int(surf_valid.sum())} points), keyframe flags equal; odometry max |dp| "
          f"{reading['p']:.3e} m (tol {10 * float(fx['odo_nudge5_dp']):.3e}; JAX's spread under "
          f"+-1e-9 m {float(fx['odo_nudge9_dp']):.3e}), |dq| {reading['q']:.3e}; n_matches "
          f"differ at {int((dn > 0).sum())} frames (JAX's own +-1e-5 m nudge changes "
          f"{int((nudge_dn > 0).sum())}); episode IMU, q0 and seeds within {EPISODE_TOL}")
    odo_rec = _knn_record(dev, odo_calls.calls[2 * (n - 1)], "the last frame's first ICP call")
    odo_rec["launches_per_frame"] = odo_launches / n

    # Stage 1 on the ingested episode.
    with tempfile.TemporaryDirectory() as tmp, _Recorder(sw_mod) as sw_calls:
        before = kernel_launches("knn")
        run_s, res = _sync_s(lambda: run_pipeline(ep, cfg, out_dir=tmp, device=dev))
        sw_launches = kernel_launches("knn") - before
        rows = np.loadtxt(os.path.join(tmp, "tc_sw_result.csv"), delimiter=",", ndmin=2)
    check(dev.type != "cuda" or sw_launches == T,
          f"knn launched {sw_launches} times in {T} keyframes of the raw-input replay")
    check(np.isfinite(res.p_sw).all() and np.isfinite(res.q_sw).all(), "stage 1 not finite")
    check(np.array_equal(res.n_lidar_factors, fx["n_lidar_factors"]),
          f"n_lidar_factors {res.n_lidar_factors.tolist()} != JAX "
          f"{fx['n_lidar_factors'].tolist()}")
    want = fx["tc_sw_result"]
    check(rows.shape == want.shape and np.array_equal(rows[:, :3], want[:, :3]),
          "tc_sw_result rows or times differ from JAX's")
    d_pos = max(np.abs(rows[:, 9:12] - want[:, 9:12]).max(), np.abs(rows[:, 5] - want[:, 5]).max())
    d_ll = M_PER_DEG_LAT * np.abs(rows[:, 3:5] - want[:, 3:5]).max()
    spread = float(fx["sw_nudge_dp"])
    tol = 10.0 * spread
    check(d_pos <= tol and d_ll <= tol + 1.2e-3,
          f"tc_sw_result positions differ from JAX's by {d_pos} m, lat/lon {d_ll} m (tol {tol})")
    why = ("" if tol <= P_TOL_M else
           f" (above the replay phase's {P_TOL_M} m: a 1e-9 m nudge of p0 moves JAX's own "
           f"stage 1 {spread:.3e} m on this drive)")
    print(f"raw-input stage 1 ({T} keyframes, diverse_select, 300 features, scan 2048): "
          f"{1e3 * run_s / T:.1f} ms per keyframe through run_pipeline ({run_s:.2f} s); knn "
          f"launches {sw_launches} ({sw_launches / T:.1f} per keyframe); n_lidar_factors equal "
          f"at all {T} steps; tc_sw_result max ENU/alt diff {d_pos:.3e} m, lat/lon {d_ll:.3e} m "
          f"(tol {tol:.3e}: 10x JAX's own spread under a +-1e-9 m nudge of p0){why}")
    win_rec = _knn_record(dev, sw_calls.calls[-1], "the window association, last keyframe")
    win_rec["launches_per_keyframe"] = sw_launches / T
    return odo_launches, sw_launches, odo_rec, win_rec


# --- phase 15: GNSS ---------------------------------------------------------------------

def _gnss_scenario(path, cfg, want_sc):
    fx, sc = _scenario(path, cfg)
    check(sc == json.loads(json.dumps(want_sc)),
          f"{os.path.basename(path)} was made for another scenario")
    return fx, sc


def rinex_phase(dev):
    """15.1: the synthetic RINEX of the Whampoa-length drive written, held
    to the fixture's digest, and converted (native decoder where g++ is) into
    ``GnssEpochs`` held to JAX's per-field digests. Returns (fixture, the
    drive, the epochs)."""
    cfg = testing.gnss_batch_config(config_mod)
    fx, sc = _gnss_scenario(GNSS_FIXTURE, cfg, testing.GNSS_DRIVE)
    station = np.asarray(cfg.initialization.station_ecef)
    drive = testing.gnss_drive(sc)
    t_gps, rover = drive[4], drive[5]
    with tempfile.TemporaryDirectory() as tmp:
        obs, nav = os.path.join(tmp, "drive.obs"), os.path.join(tmp, "drive.nav")
        write_s, info = _sync_s(lambda: testing.write_synthetic_rinex(
            obs, nav, t_gps, rover, seed=sc["seed"], n_gps=sc["n_gps"], n_bds=sc["n_bds"],
            psr_noise=sc["psr_noise"]))
        digest = testing.files_digest(obs, nav)
        check(digest == str(fx["rinex_sha256"]),
              f"the RINEX files differ from the fixture's: sha256 {digest}")
        native = gnss_native.available()
        tm = {}
        g = gnss_converter.convert(obs, nav, station, timings=tm)
        size_mb = (os.path.getsize(obs) + os.path.getsize(nav)) / 2**20
    got, want = testing.gnss_fields_digest(g), json.loads(str(fx["gnss_digest_json"]))
    check(sorted(got) == sorted(want), f"GnssEpochs fields {sorted(got)} != JAX {sorted(want)}")
    for f, w in want.items():
        if isinstance(w, str):
            check(got[f] == w, f"GnssEpochs.{f} differs from JAX's")
        else:
            check(np.allclose(got[f], w, rtol=GNSS_SUM_RTOL, atol=0),
                  f"GnssEpochs.{f} checksums {got[f]} != JAX {w}")
    E, n_rec = g.time.shape[0], int(g.valid.sum())
    print(f"gnss input: {E} epochs at 1 Hz, satellites {' '.join(info['sats'])}; RINEX 3 obs + "
          f"nav ({size_mb:.1f} MiB) written in {write_s:.2f} s (host), digest equal to the "
          f"fixture's; convert {tm['decode'] + tm['convert']:.2f} s: decode {tm['decode']:.2f} s "
          f"({'native decoder' if native else 'Python parser'}), the rest {tm['convert']:.2f} s "
          f"(host); {n_rec} records in {g.sat_pos.shape[1]} slots; slots, masks, masters and "
          f"sat_id equal to JAX's, float fields' checksums within {GNSS_SUM_RTOL} (rel)")
    return fx, drive, g


def spp_phase(dev, fx, drive, g):
    """15.2: SPP of every epoch in one call on the card, then Doppler
    velocity and DOP at the fixes, against JAX's."""
    rover = drive[5]
    station = np.asarray(GlioConfig().initialization.station_ecef)
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    args = (t(g.sat_pos), t(g.psr_rov_corr), t(g.system.astype(np.int32)), t(g.valid),
            t(g.elevation), t(g.snr), t(station))
    x, clk, ok, rms = gnss_spp.solve_epochs(*args)
    v, ddt = gnss_spp.doppler_velocity(t(g.sat_pos), t(g.sat_vel), t(g.dopp_rov),
                                       args[2], args[3], args[4], args[5], x)
    dops = torch.stack(gnss_tools.dop(x, args[0], args[3]), -1)
    ok = ok.cpu().numpy()
    check(np.array_equal(ok, fx["spp_ok"]), f"SPP ok masks differ from JAX's ({int(ok.sum())} "
                                            f"against {int(fx['spp_ok'].sum())})")
    xs = x.cpu().numpy()
    dx = float(np.abs(xs - fx["spp_x"])[ok].max())
    check(dx <= SPP_TOL_M, f"SPP: max |x - JAX| {dx} m > {SPP_TOL_M} m")
    dv = float(np.abs(v.cpu().numpy() - fx["dopp_v"]).max())
    dd = float(np.abs(ddt.cpu().numpy() - fx["dopp_ddt"]).max())
    ddop = float((np.abs(dops.cpu().numpy() - fx["dop"]) / np.abs(fx["dop"])).max())
    check(dv <= SPP_TOL_M and dd <= SPP_TOL_M and ddop <= 1e-9,
          f"Doppler velocity / DOP differ from JAX's: {dv} m/s, {dd} m/s, {ddop} (rel)")
    if dev.type == "cuda":
        spp_ms = time_device_ms(lambda: gnss_spp.solve_epochs(*args))
        vel_ms = time_device_ms(lambda: gnss_spp.doppler_velocity(
            args[0], t(g.sat_vel), t(g.dopp_rov), args[2], args[3], args[4], args[5], x))
        dop_ms = time_device_ms(lambda: gnss_tools.dop(x, args[0], args[3]))
        times = (f"SPP {spp_ms:.3f} ms, Doppler velocity {vel_ms:.3f} ms, DOP {dop_ms:.3f} ms "
                 f"(CUDA events, median of 20)")
    else:
        spp_s, _ = _sync_s(lambda: gnss_spp.solve_epochs(*args))
        times = f"SPP {1e3 * spp_s:.1f} ms (CPU wall clock)"
    rmse = _rmse(xs, rover)
    print(f"gnss SPP of all {ok.shape[0]} epochs in one call: {times}; ok masks equal to JAX's "
          f"({int(ok.sum())} ok), max |x - JAX| {dx:.3e} m (tol {SPP_TOL_M}; JAX's own spread "
          f"under the nudges {float(fx['spp_nudge_dp']):.3e} m), velocity {dv:.3e} m/s, DOP "
          f"{ddop:.3e} (rel); RMSE vs truth {rmse:.3f} m (JAX {float(fx['spp_rmse']):.3f}), "
          f"median PDOP {float(np.median(dops[:, 1].cpu().numpy())):.2f}")


def gnss_batch_phase(dev, fx, drive, g):
    """15.3: level 0 with Doppler rows at T = 3493 on the converted epochs:
    the direct solver twice (bit-identical), then ``chol_pcg``, each held to
    JAX's (see the gates below), its LM closures captured once and then
    replayed, its f32 factor's kernel run once an LM iteration and its solve
    kernel 15 times in a replayed solve. Returns the two kernels' records
    (``band_chol_record``, ``band_chol_solve_record``), with the host's
    launches (``launches``) and the device's runs in a replayed solve
    (``runs``)."""
    kf_time, p_true, q_true, p_odo = drive[:4]
    cfg = testing.gnss_batch_config(config_mod)
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    build_s, prob = _sync_s(lambda: batch_mod.build_problem(
        cfg, p_odo, q_true, kf_time, g, anchor, 0.0, station, device=dev))
    sums = _checksums(prob.p_odo, prob.psr_rov, prob.psr_sta, prob.whiten, prob.ep_valid,
                      prob.dopp, prob.dopp_sigma, prob.sat_vel)
    check(np.allclose(sums, fx["checksums"], rtol=GNSS_SUM_RTOL, atol=0),
          f"the port's problem is not JAX's: checksums {sums.tolist()}")
    gb = testing.GNSS_BATCH
    robust = batch_mod.RobustOpts(dd_huber=gb["dd_huber"], epoch_gate=gb["epoch_gate"],
                                  rel_huber=gb["rel_huber"])
    T = kf_time.shape[0]
    n_iter = len(gb["thresholds"]) * gb["lm_iters"]

    def solve(solver):
        return batch_mod.optimize_batch(cfg, prob, thresholds=gb["thresholds"],
                                        lm_iters=gb["lm_iters"], solver=solver, robust=robust)

    s1, (p1, q1, c1) = _sync_s(lambda: solve("direct"))
    s2, (p2, q2, c2) = _sync_s(lambda: solve("direct"))
    check(torch.equal(p1, p2) and torch.equal(q1, q2) and c1 == c2,
          "two Doppler batch solves on the card differ")
    graphs = lambda: [profiling.tallies().get("batch.graph." + n, 0)
                      for n in ("captures", "replays")]
    before = kernel_launches("band_cholesky"), kernel_launches("band_cholesky_solve"), graphs()
    s3, (p3, q3, _) = _sync_s(lambda: solve("chol_pcg"))
    chol_launches = kernel_launches("band_cholesky") - before[0]
    solve_launches = kernel_launches("band_cholesky_solve") - before[1]
    captures, replays = (a - b for a, b in zip(graphs(), before[2]))
    # On the card each LM iteration's assembly, step and trial cost is the
    # replay of a CUDA graph (models/batch.py::lm_closures), captured at this
    # solver's first iteration: the host launches the step's kernels only
    # there, in the direct run before the capture and in the capture itself.
    # A second chol_pcg solve only replays: the device's records of it count
    # the kernels' runs inside the replays, once an LM iteration for the
    # factor and CHOL_PCG_APPLIES times for the solve.
    if dev.type == "cuda":
        check(captures == 3 and replays == 3 * n_iter,
              f"chol_pcg's LM closures: {captures} captures and {replays} replays in {n_iter} "
              f"LM iterations (want 3 and {3 * n_iter})")
        check(chol_launches == 2 and solve_launches == 2 * CHOL_PCG_APPLIES,
              f"band_cholesky launched {chol_launches} and band_cholesky_solve {solve_launches} "
              f"times by the capture (want 2 and {2 * CHOL_PCG_APPLIES})")
        (chol_runs, solve_runs), (p4, q4, _) = kernel_runs(
            lambda: solve("chol_pcg"), "band_chol_kernel", "band_solve_kernel")
        check(torch.equal(p3, p4) and torch.equal(q3, q4), "two chol_pcg solves on the card differ")
        check(chol_runs == n_iter and solve_runs == CHOL_PCG_APPLIES * n_iter,
              f"band_cholesky ran {chol_runs} and band_cholesky_solve {solve_runs} times in the "
              f"{n_iter} LM iterations of a replayed chol_pcg solve (want {n_iter} and "
              f"{CHOL_PCG_APPLIES * n_iter})")
    # The direct solve: 10x JAX's own spread under a +-1e-9 m nudge of the
    # odometry. chol_pcg stops after 14 CG iterations, 1.1e-2 m short of the
    # exact solve on this drive, so its result moves with the f32 rounding
    # of its preconditioner, which a nudge of the odometry barely changes:
    # it is held to 10x JAX's own spread under a 1-ulp rescaling of that
    # preconditioner (the card's f32 factor rounds otherwise than the CPU's).
    # A direct solve in its place lies 1.1e-2 m away, and fails.
    report = []
    for name, p, q, tol_p, tol_q, key in (
            ("direct", p2, q2, 10.0 * float(fx["nudge_dp"]), 10.0 * float(fx["nudge_dq"]), ""),
            ("chol_pcg", p3, q3, 10.0 * float(fx["f32_nudge_dp_cp"]),
             10.0 * float(fx["f32_nudge_dq_cp"]), "_cp")):
        check(bool(torch.isfinite(p).all() & torch.isfinite(q).all()), f"{name} not finite")
        dp = float(np.abs(p.cpu().numpy() - fx["p" + key]).max())
        dq = float(np.abs(q.cpu().numpy() - fx["q" + key]).max())
        check(dp <= tol_p and dq <= tol_q,
              f"Doppler batch ({name}): max |p - JAX| {dp} m (tol {tol_p}), |q - JAX| {dq} "
              f"(tol {tol_q})")
        report.append(f"{name} max |dp| {dp:.3e} m (tol {tol_p:.3e}), |dq| {dq:.3e} (tol "
                      f"{tol_q:.3e}), RMSE vs truth {_rmse(p, p_true):.4f} m")
    report.append(f"JAX chol_pcg's own spreads: {float(fx['nudge_dp_cp']):.3e} m under the "
                  f"odometry nudge, {float(fx['f32_nudge_dp_cp']):.3e} m under a 1-ulp rescaling "
                  f"of its preconditioner")
    print(f"gnss batch T={T} with Doppler rows ({int(prob.ep_valid.sum())} epochs bound, 4 "
          f"stages x {gb['lm_iters']} LM iterations, bench robust options): build_problem "
          f"{build_s:.2f} s (host); direct {s2:.3f} s ({1e3 * s2 / n_iter:.2f} ms per LM "
          f"iteration; warm-up run {s1:.2f} s), two runs bit-identical; chol_pcg {s3:.3f} s "
          f"({1e3 * s3 / n_iter:.2f} ms per LM iteration)")
    print(f"gnss batch vs JAX (f64): " + "; ".join(report)
          + f"; odometry RMSE {_rmse(p_odo, p_true):.4f} m")
    # The f32 factor and solve kernels at the solve's own input: the
    # equilibrated band of its first LM iteration, and the first apply's
    # right-hand side with that band's preconditioner.
    hw = cfg.estimator.search_range + 1
    band, grad, _, _, _ = batch_mod._assemble_core_impl(
        prob.p_odo, prob.q_odo, prob, gb["thresholds"][0], hw, robust=robust,
        plan=batch_mod.assembly_plan(prob, hw, True), use_doppler=True)
    batch_mod._damp(band, torch.tensor(1e-4, dtype=torch.float64, device=dev), hw)
    rec = band_chol_record(dev, banded._equilibrate(band)[0].to(torch.float32).contiguous())
    M = banded.f32_chol_precond(band)
    solve_rec = band_chol_solve_record(dev, M.Lb, (-grad * M.s).to(torch.float32))
    rec["launches"], solve_rec["launches"] = chol_launches, solve_launches
    if dev.type == "cuda":
        rec["runs"], solve_rec["runs"] = chol_runs, solve_runs
        k_s = chol_runs * rec["ms"] / 1e3
        a_s = solve_runs * solve_rec["ms"] / 1e3
        print(f"chol_pcg T={T}: {captures} graph captures, {replays} replays; host launches "
              f"band_cholesky {chol_launches}, band_cholesky_solve {solve_launches} (at the "
              f"capture); device runs in a replayed solve {chol_runs} and {solve_runs} "
              f"(profiler); split by kernel times x runs: factor {k_s:.3f} s ({chol_runs} x "
              f"{rec['ms']:.3f} ms), applies {a_s:.3f} s ({solve_runs} x "
              f"{solve_rec['ms']:.3f} ms), the rest {s3 - k_s - a_s:.3f} s of {s3:.3f} s")
    return rec, solve_rec


def _dense(band):
    """The dense (T·D, T·D) matrix of a block band."""
    T, Bw, D, _ = band.shape
    hw = (Bw - 1) // 2
    dense = torch.zeros((T * D, T * D), dtype=band.dtype, device=band.device)
    t = torch.arange(T, device=band.device)
    d = torch.arange(D, device=band.device)
    for o in range(Bw):
        j = t + o - hw
        ok = (j >= 0) & (j < T)
        rows, cols = t[ok][:, None] * D + d, j[ok][:, None] * D + d
        dense[rows[:, :, None], cols[:, None, :]] = band[t[ok], o]
    return dense


def band_chol_record(dev, band_s, jitter=3e-4):
    """The f32 block-banded Cholesky kernel (``ops.band_chol``) on the
    equilibrated band of ``chol_pcg``'s preconditioner: against its plain
    version (``banded.block_cholesky``), broken rows equal and the factor
    within ``BAND_CHOL_RTOL`` of its largest entry; then kernel, plain and a
    dense ``torch.linalg.cholesky_ex`` timed beside the bound. Returns the
    record."""
    L_k = band_chol_mod.band_cholesky(band_s, jitter)
    L_p = banded.block_cholesky(band_s, jitter=jitter)
    T, R, D, _ = L_p.shape
    fin = torch.isfinite(L_p)
    check(torch.equal(torch.isfinite(L_k), fin), "band_cholesky: kernel and plain NaN rows differ")
    err = float((L_k - L_p)[fin].abs().max())
    rel = err / float(L_p[fin].abs().max())
    check(rel <= BAND_CHOL_RTOL,
          f"band_cholesky: kernel vs plain {rel} of the largest entry > {BAND_CHOL_RTOL}")
    rec = {"max_abs_err": err, "rel_err": rel, "shape": f"T={T}, hw={R - 1}, D={D}"}
    if dev.type != "cuda":
        print(f"band_cholesky {rec['shape']}: kernel == plain (the CPU runs the plain version)")
        return rec
    hw = R - 1
    # Operations this band needs (no FMA: each multiply and add is one). Per
    # block row t, each column j = t - m: the products L[t][k] L[j][k]^T of
    # the min(hw, t) - m blocks k the two rows share (D^2 dots of D products
    # and D - 1 sums, each subtracted: 2D^3), then X L[j][j]^T = S by
    # substitution (D rows of sum_c (2c + 1) = D^2). The diagonal: the lower
    # triangle of each L[t][k] L[t][k]^T (D(D + 1)/2 entries of 2D), the
    # jitter (D), and its Cholesky (entry (i, j), i >= j: j products, j
    # subtractions and a root or a division; sum_j (D - j)(2j + 1)).
    chol = sum((D - j) * (2 * j + 1) for j in range(D))
    ops = 0
    for t in range(T):
        for m in range(1, min(hw, t) + 1):
            ops += (min(hw, t) - m) * 2 * D ** 3 + D ** 3
        ops += min(hw, t) * D * (D + 1) * D + D + chol
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = gpu_clock_mhz()
    bytes_ = 2 * T * R * D * D * 4      # the band's hw + 1 lower blocks in, the factor out
    ops_ms = ops / (sms * 128 * clock * 1e3)
    bytes_ms = bytes_ / (HBM_GB_S * 1e6)
    dense = _dense(band_s)
    dense.diagonal().add_(jitter)       # in place: at D = 15 the matrix is 11 GB
    rec.update(ms=time_device_ms(lambda: band_chol_mod.band_cholesky(band_s, jitter), reps=5),
               plain_ms=time_device_ms(lambda: banded.block_cholesky(band_s, jitter=jitter),
                                       reps=1),
               library_ms=time_device_ms(lambda: torch.linalg.cholesky_ex(dense), reps=3),
               bound_ms=max(ops_ms, bytes_ms), bound_by="operations" if ops_ms > bytes_ms
               else "bytes", library_call="torch.linalg.cholesky_ex of the dense (T·D)² f32 "
               "matrix + jitter·I: the same factor, dense; yardstick only")
    del dense
    print(f"band_cholesky {rec['shape']}: kernel vs plain {rel:.3e} of the largest entry (tol "
          f"{BAND_CHOL_RTOL}), NaN rows equal; kernel {rec['ms']:.3f} ms ({1e3 * rec['ms'] / T:.3f} "
          f"us a row), plain torch {rec['plain_ms']:.1f} ms, dense cholesky_ex "
          f"{rec['library_ms']:.3f} ms (yardstick); bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}: {bytes_ / 1e6:.1f} MB, {ops / 1e6:.1f} M FP32 ops), kernel at "
          f"{rec['bound_ms'] / rec['ms']:.2e} of it: one thread block walks the {T} dependent "
          f"rows")
    return rec


def _dense_lower(Lb):
    """The dense lower-triangular (T·D, T·D) factor of ``block_cholesky``'s
    blocks Lb (T, hw + 1, D, D)."""
    T, R, D, _ = Lb.shape
    dense = torch.zeros((T * D, T * D), dtype=Lb.dtype, device=Lb.device)
    t = torch.arange(T, device=Lb.device)
    d = torch.arange(D, device=Lb.device)
    for m in range(R):
        ok = t - m >= 0
        rows, cols = t[ok][:, None] * D + d, (t[ok] - m)[:, None] * D + d
        dense[rows[:, :, None], cols[:, None, :]] = Lb[t[ok], m]
    return dense


def band_chol_solve_record(dev, Lb, rhs):
    """The f32 band solve kernel (``ops.band_chol.band_cholesky_solve``) on
    ``chol_pcg``'s factor and a right-hand side of its apply: against its
    plain version (``banded.block_cholesky_solve``) within the larger of
    ``BAND_SOLVE_RTOL`` and 10x the plain version's own f32 round-off (its
    distance to the same sweeps in f64 on the same Lb), of max |x|; then
    kernel, plain and two dense ``solve_triangular`` calls timed beside the
    bound. Returns the record."""
    x_k = band_chol_mod.band_cholesky_solve(Lb, rhs)
    x_p = banded.block_cholesky_solve(Lb, rhs)
    x_64 = banded.block_cholesky_solve(Lb.double(), rhs.double())
    scale = float(x_p.abs().max())
    roundoff = float((x_p.double() - x_64).abs().max()) / scale
    tol = max(BAND_SOLVE_RTOL, 10.0 * roundoff)
    check(bool(torch.isfinite(x_k).all()), "band_cholesky_solve: kernel output not finite")
    err = float((x_k - x_p).abs().max())
    rel = err / scale
    check(rel <= tol, f"band_cholesky_solve: kernel vs plain {rel} of max |x| > {tol}")
    T, R, D, _ = Lb.shape
    rec = {"max_abs_err": err, "rel_err": rel, "plain_f32_roundoff": roundoff,
           "shape": f"T={T}, hw={R - 1}, D={D}"}
    if dev.type != "cuda":
        print(f"band_cholesky_solve {rec['shape']}: kernel == plain (the CPU runs the plain "
              f"version); plain f32 vs f64 {roundoff:.3e} of max |x|")
        return rec
    hw = R - 1
    # Operations these sweeps need (no FMA): per row, each block's matvec
    # (D dots of D products and D - 1 sums) and its D subtractions, then the
    # triangular substitution (D(D - 1) products and subtractions, D
    # divisions); forward over m <= min(hw, t), backward over m <= min(hw,
    # T - 1 - t).
    per_block, subst = D * 2 * D, D * D
    ops = sum((min(hw, t) + min(hw, T - 1 - t)) * per_block + 2 * subst for t in range(T))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bytes_ = T * R * D * D * 4 + 2 * T * D * 4   # Lb once, b in, x out
    ops_ms = ops / (sms * 128 * gpu_clock_mhz() * 1e3)
    bytes_ms = bytes_ / (HBM_GB_S * 1e6)
    dense = _dense_lower(Lb)
    col = rhs.reshape(-1, 1)

    def library():
        y = torch.linalg.solve_triangular(dense, col, upper=False)
        return torch.linalg.solve_triangular(dense.mT, y, upper=True)
    rec.update(ms=time_device_ms(lambda: band_chol_mod.band_cholesky_solve(Lb, rhs), reps=20),
               plain_ms=time_device_ms(lambda: banded.block_cholesky_solve(Lb, rhs), reps=1),
               library_ms=time_device_ms(library, reps=3),
               bound_ms=max(ops_ms, bytes_ms), bound_by="operations" if ops_ms > bytes_ms
               else "bytes", library_call="two torch.linalg.solve_triangular calls on the dense "
               "(T·D)² f32 factor: the same sweeps, dense; yardstick only")
    del dense
    print(f"band_cholesky_solve {rec['shape']}: kernel vs plain {rel:.3e} of max |x| (tol "
          f"{tol:.3e}: the larger of {BAND_SOLVE_RTOL} and 10x the plain version's f32 "
          f"round-off against f64 on the same Lb, {roundoff:.3e}); kernel {rec['ms']:.4f} ms "
          f"({1e3 * rec['ms'] / T:.3f} us a row), plain torch {rec['plain_ms']:.1f} ms, dense "
          f"solve_triangular x 2 {rec['library_ms']:.3f} ms (yardstick); bound "
          f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}: {bytes_ / 1e6:.2f} MB, "
          f"{ops / 1e6:.2f} M FP32 ops), kernel at {rec['bound_ms'] / rec['ms']:.2e} of it: "
          f"one warp walks the {T} dependent rows twice")
    return rec


class _StepRecorder:
    """Within the block, keep every ``StepOutput`` that the window's
    ``replay_from`` returns (``outs``)."""

    def __enter__(self):
        self.outs = []
        self.orig = SlidingWindowEstimator.replay_from
        orig, outs = self.orig, self.outs

        def replay_from(est, carry, inputs):
            carry, out = orig(est, carry, inputs)
            outs.append(out)
            return carry, out
        SlidingWindowEstimator.replay_from = replay_from
        return self

    def __exit__(self, *exc):
        SlidingWindowEstimator.replay_from = self.orig

    def field(self, name):
        return torch.cat([getattr(o, name) for o in self.outs]).cpu().numpy()


def _csv_gate(rows, want, spread, name):
    """Positions of a result CSV within 10x JAX's nudge spread; returns the
    largest difference (m)."""
    check(rows.shape == want.shape and np.array_equal(rows[:, :3], want[:, :3]),
          f"{name} rows or times differ from JAX's")
    d = max(np.abs(rows[:, 9:12] - want[:, 9:12]).max(), np.abs(rows[:, 5] - want[:, 5]).max())
    d_ll = M_PER_DEG_LAT * np.abs(rows[:, 3:5] - want[:, 3:5]).max()
    tol = 10.0 * spread
    check(d <= tol and d_ll <= tol + 1.2e-3,
          f"{name} positions differ from JAX's by {d} m, lat/lon {d_ll} m (tol {tol})")
    return float(d)


def _gnss_pipeline(dev, cfg, ep, **kw):
    """``run_pipeline`` on ``dev`` with the backend fusion's debug lines,
    each fusion solve timed and the window's outputs recorded. Returns
    (seconds, result, CSV rows, debug lines, fusion seconds, recorder, kNN
    launches, band-Cholesky factor and solve launches)."""
    buf = io.StringIO()
    fusion = pipeline.replay_with_backend_fusion
    pipeline.replay_with_backend_fusion = lambda *a, **k: fusion(*a, debug=True, **k)
    try:
        with tempfile.TemporaryDirectory() as tmp, _timed_fusion() as fusion_s, \
                contextlib.redirect_stdout(buf), _StepRecorder() as rec:
            names = ("knn", "band_cholesky", "band_cholesky_solve")
            before = [kernel_launches(n) for n in names]
            run_s, res = _sync_s(lambda: run_pipeline(ep, cfg, out_dir=tmp, device=dev, **kw))
            launches, n_chol, n_solve = (kernel_launches(n) - b for n, b in zip(names, before))
            chol_launches = (n_chol, n_solve)
            rows = {n: np.loadtxt(os.path.join(tmp, n + ".csv"), delimiter=",", ndmin=2)
                    for n in ("tc_sw_result", "tc_batch_result")}
    finally:
        pipeline.replay_with_backend_fusion = fusion
    return run_s, res, rows, buf.getvalue().splitlines(), fusion_s, rec, launches, chol_launches


def long_run_phase(dev):
    """15.4: the long-run configuration (``scripts/long_run.py:26-36``) on
    30 keyframes through ``run_pipeline(..., backend_fusion_every=10)``.
    Returns the kNN launches and the band-Cholesky factor and solve
    launches."""
    cfg = testing.long_run_config(config_mod)
    fx, sc = _gnss_scenario(LONG_RUN_FIXTURE, cfg, testing.LONG_RUN)
    T = sc["n_keyframes"]
    ep = testing.gnss_episode(sc, simulate_episode, simulate_gnss_epochs,
                              np.asarray(cfg.initialization.anc_ecef),
                              np.asarray(cfg.initialization.station_ecef))
    graphs = lambda: [profiling.tallies().get("batch.graph." + n, 0)
                      for n in ("captures", "replays")]
    before = graphs()
    run_s, res, rows, lines, fusion_s, rec, launches, chol_launches = _gnss_pipeline(
        dev, cfg, ep, backend_fusion_every=sc["every"])
    captures, replays = (a - b for a, b in zip(graphs(), before))
    check(dev.type != "cuda" or launches == T,
          f"knn launched {launches} times in {T} keyframes of the long run")
    n_chol, n_solve = chol_launches
    # The batch solves grow T, so each captures its three LM closures anew
    # (models/batch.py::lm_closures); the host launches the step's kernels
    # twice a capture (the direct run before it and the capture) and the
    # replays run them.
    check(dev.type != "cuda" or (captures > 0 and captures % 3 == 0 and replays > 0
                                 and n_chol == 2 * captures // 3
                                 and n_solve == CHOL_PCG_APPLIES * n_chol),
          f"the long run's chol_pcg solves: {captures} graph captures, {replays} replays, "
          f"band_cholesky launched {n_chol} times and band_cholesky_solve {n_solve} times "
          f"(twice a step capture, {CHOL_PCG_APPLIES} applies a step)")
    nlf = rec.field("n_lidar_factors")
    check(np.array_equal(nlf, fx["n_lidar_factors"]),
          f"n_lidar_factors {nlf.tolist()} != JAX {fx['n_lidar_factors'].tolist()}")
    got, want = reset_decisions(lines), reset_decisions(json.loads(str(fx["lines"])))
    check(not bool(fx["decisions_stable"]) or got == want, f"reset decisions {got} != JAX {want}")
    d_sw = _csv_gate(rows["tc_sw_result"], fx["tc_sw_result"], float(fx["sw_nudge_dp"]),
                     "long-run tc_sw_result")
    d_bt = _csv_gate(rows["tc_batch_result"], fx["tc_batch_result"],
                     float(fx["batch_nudge_dp"]), "long-run tc_batch_result")
    fus = sum(fusion_s)
    print(f"long run {T} keyframes (long_run.py: width 20, scan 1024, map 16384, DD rows in the "
          f"window, chol_pcg, backend fusion every {sc['every']}): {run_s:.2f} s through "
          f"run_pipeline (stages 1-3), {len(fusion_s)} fusion solves {fus:.2f} s in all; stage 1 "
          f"{1e3 * (run_s - fus) / T:.1f} ms per keyframe without them, "
          f"{1e3 * run_s / T:.1f} ms with everything (against the 333 ms of a 3 Hz stream); knn "
          f"launches {launches}")
    print(f"long run vs JAX: n_lidar_factors equal at all {T} steps, resets {got} "
          f"(JAX {want}); tc_sw_result max diff {d_sw:.3e} m (tol "
          f"{10 * float(fx['sw_nudge_dp']):.3e}), tc_batch_result {d_bt:.3e} m (tol "
          f"{10 * float(fx['batch_nudge_dp']):.3e}): 10x JAX's own spread under +-1e-9 m nudges "
          f"of p0; ATE RMSE stage 1 {_rmse(res.p_sw, ep.gt_p):.3f} m, batch "
          f"{_rmse(res.p_batch, ep.gt_p):.3f} m; batch graph captures {captures}, replays "
          f"{replays}; host launches band_cholesky {n_chol}, band_cholesky_solve {n_solve}")
    return launches, n_chol, n_solve


def doppler_window_phase(dev):
    """15.5: phase 7's 15 keyframes with DD and Doppler rows in the window
    and Doppler rows in the batch, through ``run_pipeline`` (stages 1-3).
    Returns the kNN launches."""
    cfg = testing.doppler_window_config(config_mod)
    fx, sc = _gnss_scenario(DOPP_WINDOW_FIXTURE, cfg, testing.DOPPLER_WINDOW)
    T = sc["n_keyframes"]
    ep = testing.gnss_episode(sc, simulate_episode, simulate_gnss_epochs,
                              np.asarray(cfg.initialization.anc_ecef),
                              np.asarray(cfg.initialization.station_ecef))
    run_s, res, rows, _, _, rec, launches, _ = _gnss_pipeline(dev, cfg, ep)
    check(dev.type != "cuda" or launches == T,
          f"knn launched {launches} times in {T} keyframes of the Doppler window")
    check(np.array_equal(res.n_lidar_factors, fx["n_lidar_factors"]),
          f"n_lidar_factors {res.n_lidar_factors.tolist()} != JAX "
          f"{fx['n_lidar_factors'].tolist()}")
    d_sw = _csv_gate(rows["tc_sw_result"], fx["tc_sw_result"], float(fx["sw_nudge_dp"]),
                     "Doppler-window tc_sw_result")
    d_bt = _csv_gate(rows["tc_batch_result"], fx["tc_batch_result"],
                     float(fx["batch_nudge_dp"]), "Doppler-window tc_batch_result")
    ddt = rec.field("ddt")
    d_ddt = float(np.abs(ddt - fx["ddt"]).max())
    tol_ddt = 10.0 * float(fx["ddt_nudge"])
    check(d_ddt <= tol_ddt, f"window ddt differs from JAX's by {d_ddt} m/s (tol {tol_ddt})")
    check(np.isfinite(res.p_lc).all(), "stage 3 not finite")
    print(f"Doppler window {T} keyframes (bench shapes, DD + Doppler rows in the window, Doppler "
          f"rows in the batch): {run_s:.2f} s through run_pipeline (stages 1-3), "
          f"{1e3 * run_s / T:.1f} ms per keyframe; knn launches {launches}")
    print(f"Doppler window vs JAX: n_lidar_factors equal at all {T} steps; tc_sw_result max diff "
          f"{d_sw:.3e} m (tol {10 * float(fx['sw_nudge_dp']):.3e}), tc_batch_result {d_bt:.3e} m "
          f"(tol {10 * float(fx['batch_nudge_dp']):.3e}), ddt {d_ddt:.3e} m/s (tol "
          f"{tol_ddt:.3e}): 10x JAX's own spread under +-1e-9 m nudges of p0; receiver clock "
          f"drift at the last keyframe {ddt[-1]:.4f} m/s")
    return launches


def gnss_phase(dev):
    """Phase 15, GNSS: RINEX input, SPP, the Doppler batch, the long-run
    configuration, the Doppler window and the carrier-phase path. Returns the
    kNN launches of the long run and of the Doppler window, the
    band-Cholesky factor and solve kernels' records, and the seconds of
    15.6."""
    fx, drive, g = rinex_phase(dev)
    spp_phase(dev, fx, drive, g)
    chol, solve = gnss_batch_phase(dev, fx, drive, g)
    long_launches, chol["launches_long_run"], solve["launches_long_run"] = long_run_phase(dev)
    dopp_launches = doppler_window_phase(dev)
    carrier_s, _ = _sync_s(lambda: carrier_phase(dev, drive, g))
    return long_launches, dopp_launches, chol, solve, carrier_s


# --- phase 15.6: the carrier-phase path ----------------------------------------------------

def _launches(fn):
    """(CUDA kernel launches, result) of one run of ``fn`` under
    ``torch.profiler``: the device's kernels, copies and sets, as a traced
    run of ``port_bench/run.py --trace 1`` counts them. The CUDA activity alone,
    counted from the profiler's raw records: with every host operator
    recorded and the event tree built, the count of the 1165-epoch filter
    took ~147 s on an H100 80GB HBM3 at 700 W, this way 21-32 s, for the same
    count (None where no card is present)."""
    if not torch.cuda.is_available():
        return None, fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    records = prof.profiler.kineto_results.events()
    return sum(e.device_type() == torch.autograd.DeviceType.CUDA for e in records), out


def _rel_spread(a, b):
    """The largest change of each epoch's entries relative to its largest
    (``scripts/make_torch_carrier_fixture.py::rel_spread``)."""
    scale = np.abs(b).reshape(b.shape[0], -1).max(1)
    return float((np.abs(a - b).reshape(b.shape[0], -1).max(1) / np.maximum(scale, 1e-300))
                 .max())


def carrier_phase(dev, drive, g):
    """15.6: the float/AR variant of stage 3 on phase 15.1's epochs through
    ``pipeline.lc_stage_float_ar``: the carrier-phase float filter on the
    card, integer ambiguity resolution on the host and the LC solve at
    T = 3493, against ``tests/data/carrier_T3493_seed15.npz``; then the
    filter once more under ``torch.profiler`` for its launches."""
    fx = np.load(CARRIER_FIXTURE)
    sc = json.loads(str(fx["scenario_json"]))
    cfg = GlioConfig()
    check(json.loads(str(fx["config_json"])) == json.loads(json.dumps(dataclasses.asdict(cfg)))
          and {k: sc[k] for k in testing.GNSS_DRIVE} == json.loads(json.dumps(
              testing.GNSS_DRIVE)) and (sc["cov_gate"], sc["max_dt"]) == (5.0, 0.25),
          "the carrier fixture was made for another scenario")
    kf_time, p_true, q_true, p_odo, _, rover = drive
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    x0 = fx["x0"]
    tm = {}
    p_lc, q_lc, flt, (gnss_p, gnss_valid, _), fixed = pipeline.lc_stage_float_ar(
        g, kf_time, p_odo, q_true, anchor, 0.0, station, device=dev, x0=x0, timings=tm)
    filter_s, ar_s, lc_s = tm["filter"], tm["ar"], tm["lc"]
    count_s, (n_launch, _) = _sync_s(
        lambda: _launches(lambda: gnss_rtk.run_float_filter(g, station, x0, device=dev)))
    host = pipeline._to_host(flt)
    E = host.pos.shape[0]
    for name in ("ok", "n_dd", "n_car"):
        check(np.array_equal(getattr(host, name), fx[name]), f"float filter {name} differs "
                                                              f"from JAX's")
    check(np.array_equal(gnss_valid, fx["gnss_valid"]), "the gated LC factors differ from JAX's")
    # Each within 10x JAX's own spread under a +-1e-9 m nudge of x0 and a
    # +-1e-8 m pseudorange nudge of alternating sign (the covariances
    # relative to their epoch's largest entry).
    report = []
    sub = fx["sub"]
    for name, got, want, key, rel in (
            ("pos", host.pos, fx["pos"], "nudge_pos", False),
            ("vel", host.vel, fx["vel"], "nudge_vel", False),
            ("amb", host.amb, fx["amb"], "nudge_amb", False),
            ("pos_cov", host.pos_cov, fx["pos_cov"], "nudge_pos_cov", True),
            ("amb_cov", host.amb_cov[sub], fx["amb_cov_sub"], "nudge_amb_cov_sub", True),
            ("pa_cov", host.pa_cov[sub], fx["pa_cov_sub"], "nudge_pa_cov_sub", True),
            ("fixes", gnss_p, fx["gnss_p"], "nudge_gnss_p", False),
            ("LC p", p_lc.cpu().numpy(), fx["p_lc"], "nudge_p_lc", False),
            ("LC q", q_lc.cpu().numpy(), fx["q_lc"], "nudge_q_lc", False)):
        d = _rel_spread(got, want) if rel else float(np.abs(got - want).max())
        tol = 10.0 * float(fx[key])
        check(bool(np.isfinite(got).all()), f"carrier phase: {name} not finite")
        check(d <= tol, f"carrier phase: {name} differs from JAX's by {d} (tol {tol})")
        report.append(f"{name} {d:.3e} (tol {tol:.3e})")
    stable = fx["fixed_stable"]
    check(np.array_equal(fixed[stable], fx["fixed"][stable]),
          "AR fixed flags differ from JAX's where JAX's own are stable")
    moved = int((fixed[~stable] != fx["fixed"][~stable]).sum())
    print(f"carrier phase ({E} epochs, {int(host.n_car.sum())} carrier DD rows): float filter "
          f"{1e3 * filter_s:.1f} ms (synchronized wall clock, {1e3 * filter_s / E:.3f} ms an "
          f"epoch), {n_launch} kernel launches ({(n_launch or 0) / E:.0f} an epoch, "
          f"torch.profiler, counted in {count_s:.1f} s); AR {ar_s:.2f} s (host, one copy of "
          f"the filter's output): "
          f"{int(fixed.sum())} of {E} epochs fixed ({100 * fixed.mean():.1f} %), flags equal to "
          f"JAX's at all {int(stable.sum())} where JAX's own are stable ({moved} of the other "
          f"{int((~stable).sum())} differ); LC solve T={p_odo.shape[0]} {1e3 * lc_s:.1f} ms, "
          f"{int(gnss_valid.sum())} fixes")
    print("carrier phase vs JAX (max |d|; covariances relative to their epoch's largest "
          "entry; tol 10x JAX's own spread under a +-1e-9 m x0 and a +-1e-8 m pseudorange "
          "nudge): " + ", ".join(report) + f"; ok, n_dd, n_car and the gated factors equal; "
          f"RMSE vs truth float {_rmse(host.pos[host.ok], rover[host.ok]):.3f} m, LC "
          f"{_rmse(p_lc, p_true):.3f} m (odometry {_rmse(p_odo, p_true):.3f} m)")


# --- phase 18: the multi-device batch solve ------------------------------------------------

def sharded_phase(dev, ctx):
    """18: four ranks on the one card (``testing.sharded_batch_rank``) against
    the single-device solves of this process on the same bands, and against
    ``tests/data/parallel_T3493_seed4.npz``."""
    px = np.load(PARALLEL_FIXTURE)
    psc = json.loads(str(px["scenario_json"]))
    sc, cfg, fx, prob = ctx["sc"], ctx["cfg"], ctx["fx"], ctx["prob"]
    check(json.loads(str(px["config_json"])) == json.loads(json.dumps(dataclasses.asdict(cfg)))
          and all(psc[k] == sc[k] for k in sc if k != "solver")
          and psc["ranks"] == SHARDED_RANKS and psc["pcg_layout"] == [2, 2],
          "the parallel fixture was made for another scenario")
    spec = dict(scenario=sc, p_solution=ctx["p"].cpu().numpy(), q_solution=ctx["q"].cpu().numpy(),
                p_jax=fx["p_f64"], q_jax=fx["q_f64"], pcg_iters=psc["pcg_iters"],
                assembly_reps=ASSEMBLY_REPS)
    t_launch = time.time()
    t0 = time.perf_counter()
    ranks = run_ranks(testing.sharded_batch_rank, SHARDED_RANKS, dev, args=(spec,))
    wall_s = time.perf_counter() - t0
    r0 = ranks[0]
    # The references, on the same bands.
    (band, rhs), (band2, b2) = testing.sharded_batch_bands(
        batch_mod, cfg, prob, sc, (ctx["p"], ctx["q"]),
        (torch.as_tensor(fx["p_f64"], device=dev), torch.as_tensor(fx["q_f64"], device=dev)))
    for r in ranks:
        check(torch.equal(r["p"], r0["p"]) and torch.equal(r["q"], r0["q"]),
              f"rank {r['rank']} returned another trajectory than rank 0")
    # Each rank's rows of the first assembly of (c) against this process's band.
    band0, grad0, cost0, *_ = batch_mod._assemble_core_impl(
        prob.p_odo, prob.q_odo, prob, sc["thresholds"][0], band.shape[1] // 2,
        robust=testing.robust_opts(batch_mod, sc))
    band0, grad0, cost0 = band0.cpu(), grad0.cpu(), float(cost0)
    T = band0.shape[0]
    rows_err, bit_equal, t_end, cost_sum = 0.0, True, 0, 0.0
    for r in ranks:
        t0, t1 = r["part"][3:]
        b_l, g_l, c_l = r["rows"]
        check(t0 == t_end and b_l.shape[0] == g_l.shape[0] == t1 - t0,
              f"rank {r['rank']} assembled rows [{t0}, {t1}) ({b_l.shape[0]}), not from {t_end}")
        t_end, cost_sum = t1, cost_sum + float(c_l)
        if t1 > t0:
            rows_err = max(rows_err,
                           float((b_l - band0[t0:t1]).abs().max() / band0.abs().max()),
                           float((g_l - grad0[t0:t1]).abs().max() / grad0.abs().max()))
            bit_equal &= torch.equal(b_l, band0[t0:t1]) and torch.equal(g_l, grad0[t0:t1])
    check(t_end == T, f"the ranks' rows end at {t_end}, not at T = {T}")
    cost_err = abs(cost_sum - cost0) / abs(cost0)
    cr_single_s, x_ref = _sync_s(lambda: banded.cyclic_reduction_solve(band, rhs))
    x_ref = x_ref.cpu()
    rel_cr = float((r0["x_cr"] - x_ref).abs().max() / x_ref.abs().max())
    pcg_single_s, pcg_ref = _sync_s(lambda: [banded.pcg_solve(band2[n], b2[n],
                                                              iters=psc["pcg_iters"])[0]
                                             for n in range(2)])
    rel_pcg = max(float((r0["x_pcg"][n] - pcg_ref[n].cpu()).abs().max()
                        / pcg_ref[n].abs().max()) for n in range(2))
    tol_pcg = 10.0 * float(px["pcg_rel"])
    p_dir, q_dir = ctx["p"].cpu(), ctx["q"].cpu()
    d_p = float((r0["p"] - p_dir).abs().max())
    d_q = float((r0["q"] - q_dir).abs().max())
    d_jax = float(np.abs(r0["p"].numpy() - fx["p_f64"]).max())
    # JAX's own sharded-against-single distance, or its spread under four
    # 1e-9 m nudges of the odometry where that is larger: near convergence
    # the LM's accept decisions turn round-off into moves of up to it.
    tol_p = 10.0 * max(float(px["d_p_sharded"]), float(px["nudge_p"]))
    tol_q = 10.0 * max(float(px["d_q_sharded"]), float(px["nudge_q"]))
    startup = max(r["t_ready"] for r in ranks) - t_launch

    def comm(key):
        calls, nbytes, secs = (max(r[key][i] for r in ranks) for i in range(3))
        return f"{calls} collectives, {nbytes / 1e6:.3f} MB a rank, {secs:.3f} s"

    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"
    print(f"multi-device ({SHARDED_RANKS} ranks on {where}, backend "
          f"gloo, file:// rendezvous): ranks started in {startup:.2f} s, problem and bands "
          f"{max(r['setup_s'] for r in ranks):.2f} s a rank, {wall_s:.1f} s in all")
    print(f"multi-device (a) sharded CR solve T={band.shape[0]}: {1e3 * r0['cr_s']:.1f} ms "
          f"(single-device {1e3 * cr_single_s:.1f} ms), {comm('cr_comm')}; vs "
          f"cyclic_reduction_solve {rel_cr:.3e} of max |x| (tol {SPIKE_RTOL})")
    print(f"multi-device (b) sharded PCG dp=2 sp=2, {psc['pcg_iters']} iterations, 2 bands "
          f"T={band2.shape[1]}: {1e3 * r0['pcg_s']:.1f} ms (single-device, both bands "
          f"{1e3 * pcg_single_s:.1f} ms), {comm('pcg_comm')} over all ranks, "
          f"{r0['pcg_sp_comm'][0]} over each sp pair; vs pcg_solve {rel_pcg:.3e} of max |x| "
          f"(tol {tol_pcg:.3e}, 10x JAX's {float(px['pcg_rel']):.3e})")
    def mb(nbytes):
        return "not measured" if nbytes is None else f"{1e-6 * nbytes:.1f} MB"

    print(f"multi-device (c) the ranks' first assembly (odometry, threshold "
          f"{sc['thresholds'][0]:g}): rows vs this process's whole band {rows_err:.3e} of its "
          f"largest entry ({'bit-equal' if bit_equal else 'not bit-equal'}; tol "
          f"{SHARD_ROWS_RTOL}), partial costs summed in rank order {cost_err:.3e} relative")
    for r in ranks:
        t0, t1 = r["part"][3:]
        print(f"multi-device (c) rank {r['rank']}: rows [{t0}, {t1}) of {T}, holds {r['held'][0]} "
              f"of {r['whole'][0]} keyframes and {r['held'][1]} of {r['whole'][1]} epochs; "
              f"assembly {r['local_ms']:.2f} ms an LM iteration (the whole band "
              f"{r['whole_ms']:.2f} ms, the {SHARDED_RANKS} ranks at once, mean of "
              f"{ASSEMBLY_REPS}); peak device memory in (c) {mb(r['batch_peak'])} "
              f"({mb(r['batch_resident'])} resident before it; the whole problem and one "
              f"whole-band assembly {mb(r['whole_peak'])}, this rank's rows "
              f"{mb(r['local_peak'])}); {r['batch_comm'][0]} collectives")
    print(f"multi-device (c) optimize_batch_sharded (4 stages x {sc['lm_iters']} LM "
          f"iterations): {r0['batch_s']:.2f} s (single-device {ctx['solve_s']:.2f} s), "
          f"{comm('batch_comm')}; vs optimize_batch max |dp| {d_p:.3e} m, |dq| {d_q:.3e} "
          f"(tol {tol_p:.3e} m, {tol_q:.3e}: 10x the larger of JAX's own sharded-vs-single "
          f"{float(px['d_p_sharded']):.3e} m, {float(px['d_q_sharded']):.3e} and its spread under "
          f"four 1e-9 m odometry nudges {float(px['nudge_p']):.3e} m, {float(px['nudge_q']):.3e}), vs JAX f64 "
          f"{d_jax:.3e} m (tol {BATCH_F64_TOL_M}); costs {r0['costs']}")
    check(rows_err <= SHARD_ROWS_RTOL, f"a rank's assembled rows vs the whole band: {rows_err:.3e} "
                                       f"of its largest entry > {SHARD_ROWS_RTOL}")
    check(cost_err <= SHARD_ROWS_RTOL, f"the ranks' partial costs vs the whole cost: "
                                       f"{cost_err:.3e} > {SHARD_ROWS_RTOL}")
    check(bool(torch.isfinite(r0["x_cr"]).all()) and tuple(r0["x_cr"].shape) == tuple(rhs.shape),
          "the sharded CR solve is not finite or has the wrong shape")
    check(rel_cr < SPIKE_RTOL, f"sharded CR solve vs cyclic_reduction_solve: {rel_cr:.3e} "
                               f"of max |x| >= {SPIKE_RTOL}")
    check(bool(torch.isfinite(r0["x_pcg"]).all()), "the sharded PCG is not finite")
    check(rel_pcg <= tol_pcg, f"sharded PCG vs pcg_solve: {rel_pcg:.3e} of max |x| > "
                              f"{tol_pcg:.3e} (10x JAX's own)")
    check(bool(torch.isfinite(r0["p"]).all() and torch.isfinite(r0["q"]).all()),
          "the sharded batch trajectory is not finite")
    check(d_p <= tol_p and d_q <= tol_q,
          f"optimize_batch_sharded vs optimize_batch: max |dp| {d_p:.3e} m (tol {tol_p:.3e}), "
          f"|dq| {d_q:.3e} (tol {tol_q:.3e})")
    check(d_jax <= BATCH_F64_TOL_M, f"optimize_batch_sharded vs JAX f64: {d_jax:.3e} m > "
                                    f"{BATCH_F64_TOL_M} m")


# --- phase 19: the small public functions on the card --------------------------------------

def item9_phase(dev):
    """19: ``testing.item9_cases`` on the card against the CPU, same inputs."""
    t0 = time.perf_counter()
    gpu = testing.item9_cases(dev)
    cpu = testing.item9_cases(torch.device("cpu"))
    worst = []
    for name, (got, secs, where) in gpu.items():
        want = cpu[name][0]
        check(where == "cuda", f"{name} ran on {where}, not on the card")
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name}: shape {tuple(got.shape)} or not finite")
        d = float((got - want).abs().max() / max(float(want.abs().max()), 1.0))
        check(d <= ITEM9_RTOL, f"{name} on the card vs the CPU: {d:.3e} > {ITEM9_RTOL}")
        worst.append((d, name))
    d, name = max(worst)
    print(f"small functions: {len(gpu)} on the card, each within {ITEM9_RTOL} of its CPU result "
          f"(largest {d:.3e}, {name}; relative to max(1, max |x|)); "
          f"{time.perf_counter() - t0:.1f} s")


# --- phase 16: the batch variants -----------------------------------------------------

def _held(name, got, fx, key, extra=()):
    """max |got - fx[key]| within 10x the largest of JAX's spreads ``extra``
    (fixture keys); returns the report."""
    d = float(np.abs(got.cpu().numpy() - fx[key]).max())
    tol = 10.0 * max(float(fx[k]) for k in extra)
    check(bool(torch.isfinite(got).all()), f"{name} not finite")
    check(d <= tol, f"{name}: max |d| from JAX {d} > {tol}")
    return f"{name} {d:.3e} (tol {tol:.3e})"


def batch_variants_phase(dev):
    """16: on phase 6's drive at T = 3493, ``optimize_batch_atm`` (direct,
    then ``chol_pcg`` through the D = 7 kernels) and
    ``optimize_batch_incremental`` (every 250, relatives re-derived); on
    that drive cut to its first 300 keyframes, the reference cadence (a
    fresh solve every 10); each against JAX f64. Returns the D = 7 kernels'
    records."""
    fx0, sc, cfg, prob, p_true, p_odo, _ = batch_problem(dev)
    fx = np.load(VARIANTS_FIXTURE)
    vs = json.loads(str(fx["scenario_json"]))
    check(json.loads(str(fx["config_json"])) == json.loads(json.dumps(dataclasses.asdict(cfg))),
          "the batch-variants fixture was made with another configuration")
    robust = batch_mod.RobustOpts(dd_huber=sc["dd_huber"], epoch_gate=sc["epoch_gate"],
                                  rel_huber=sc["rel_huber"])
    thresholds = tuple(vs["thresholds"])
    T = prob.p_odo.shape[0]
    n_iter = len(thresholds) * vs["atm_lm_iters"]

    def atm(solver):
        return batch_mod.optimize_batch_atm(cfg, prob, thresholds=thresholds,
                                            lm_iters=vs["atm_lm_iters"], solver=solver,
                                            robust=robust)
    direct_s, (p, q, z, _) = _sync_s(lambda: atm("direct"))
    rep = [_held(n, a, fx, f"atm_{n}", [f"atm_nudge_d{n}"]) for n, a in zip("pqz", (p, q, z))]
    z_range = (float(z.min()), float(z.max()))
    before = kernel_launches("band_cholesky"), kernel_launches("band_cholesky_solve")
    cp_s, (p, q, z, _) = _sync_s(lambda: atm("chol_pcg"))
    n_chol = kernel_launches("band_cholesky") - before[0]
    n_solve = kernel_launches("band_cholesky_solve") - before[1]
    check(dev.type != "cuda" or (n_chol == n_iter and n_solve == CHOL_PCG_APPLIES * n_iter),
          f"atm chol_pcg launched band_cholesky {n_chol} and band_cholesky_solve {n_solve} "
          f"times in {n_iter} LM iterations")
    rep += [_held(f"{n} (chol_pcg)", a, fx, f"atm_cp_{n}",
                  [f"atm_cp_nudge_d{n}", f"atm_cp_f32_nudge_d{n}"])
            for n, a in zip("pqz", (p, q, z))]
    print(f"batch atm T={T} (7-dof: pose + zenith bias, 4 stages x {vs['atm_lm_iters']} LM "
          f"iterations, bench robust options): direct {direct_s:.3f} s, chol_pcg {cp_s:.3f} s "
          f"(band_cholesky {n_chol} launches, band_cholesky_solve {n_solve}, D = 7); z from "
          f"{z_range[0]:.3f} to {z_range[1]:.3f} m (direct); RMSE vs truth {_rmse(p, p_true):.4f} "
          f"m (chol_pcg)")
    print("batch atm vs JAX f64 (tol 10x JAX's own spread under a +-1e-9 m odometry nudge, "
          "for chol_pcg also under a 1-ulp rescaling of its preconditioner): " + ", ".join(rep))
    # The D = 7 kernels on the atm solve's own first band.
    hw = cfg.estimator.search_range + 1
    z0 = torch.zeros(T, dtype=torch.float64, device=dev)
    band, grad, *_ = batch_mod._atm_system(cfg, prob, prob.p_odo, prob.q_odo, z0, thresholds[0],
                                           hw, robust, batch_mod.assembly_plan(prob, hw))
    batch_mod._damp(band, torch.tensor(1e-4, dtype=torch.float64, device=dev), hw)
    rec = band_chol_record(dev, banded._equilibrate(band)[0].to(torch.float32).contiguous())
    M = banded.f32_chol_precond(band)
    solve_rec = band_chol_solve_record(dev, M.Lb, (-grad * M.s).to(torch.float32))
    rec["launches"], solve_rec["launches"] = n_chol, n_solve
    del band, grad, M

    timings = {}
    incr_s, (p, q) = _sync_s(lambda: batch_mod.optimize_batch_incremental(
        cfg, prob, prob.kf_time.cpu().numpy(), every=vs["incr_every"], thresholds=thresholds,
        lm_iters=vs["incr_lm_iters"], robust=robust, rederive=True, timings=timings))
    rs = np.asarray(timings["resolve_s"])
    rep = [_held(n, a, fx, f"incr_{n}", [f"incr_nudge_d{n}"]) for n, a in zip("pq", (p, q))]
    print(f"batch incremental T={T}, every {vs['incr_every']}, relatives re-derived, 4 stages x "
          f"{vs['incr_lm_iters']} LM iterations: {incr_s:.2f} s, {len(rs)} re-solves, mean "
          f"{rs.mean():.3f} s, max {rs.max():.3f} s (synchronized wall clock); vs JAX f64: "
          + ", ".join(rep) + f"; RMSE vs truth {_rmse(p, p_true):.4f} m")

    fxc = np.load(CADENCE_FIXTURE)
    Tc = vs["cadence_keyframes"]
    kf_time, _, q_true, _ = drifted_trajectory(sc["n_keyframes"], sc["max_drift"])
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    gnss_c = simulate_gnss_epochs(p_true[:Tc], kf_time[:Tc], anchor, station,
                                  psr_noise=sc["psr_noise"], epoch_stride=sc["epoch_stride"],
                                  seed=sc["seed"])
    prob_c = batch_mod.build_problem(cfg, p_odo[:Tc], q_true[:Tc], kf_time[:Tc], gnss_c, anchor,
                                     0.0, station, device=dev)
    cad_s, (p, q, stats) = _sync_s(lambda: batch_mod.optimize_batch_reference_cadence(
        cfg, prob_c, every=vs["cadence_every"], thresholds=thresholds, robust=robust))
    check(stats["n_resolves"] == int(fxc["n_resolves"]),
          f"cadence: {stats['n_resolves']} re-solves, JAX {int(fxc['n_resolves'])}")
    p1, q1, _ = batch_mod.optimize_batch(cfg, prob_c, thresholds=thresholds,
                                         lm_iters=(40, 12, 8, 8), robust=robust)
    check(torch.equal(p, p1) and torch.equal(q, q1),
          "the cadence's final solve is not optimize_batch of the whole prefix, bit for bit")
    rep = [_held(n, a, fxc, n, [f"nudge_d{n}"]) for n, a in zip("pq", (p, q))]
    print(f"batch reference cadence on the drive cut to T={Tc} (of {T}: {stats['n_resolves']} "
          f"re-solves here, {len(range(30, T, vs['cadence_every']))} at full length), every "
          f"{vs['cadence_every']}: {cad_s:.2f} s; re-solves mean {stats['resolve_mean_s']:.3f} "
          f"s, p50 {stats['resolve_p50_s']:.3f} s, max {stats['resolve_max_s']:.3f} s, final "
          f"{stats['final_s']:.3f} s (synchronized wall clock), equal bit for bit to "
          f"optimize_batch of the prefix; vs JAX f64: " + ", ".join(rep))
    return rec, solve_rec


# --- phase 17: level 1's iterative solvers --------------------------------------------------

def sms1_solvers_phase(dev, ctx, fixture=SMS1_SOLVERS_FIXTURE):
    """17: ``optimize_batch_sms1`` and ``optimize_batch_sms1_imu`` with
    ``pcg`` and ``chol_pcg`` (the latter through the D = 6 and D = 15
    kernels) at T = 3493 on phase 8's association, against JAX f64 with its
    plane fits' eigensystem in f64. Returns the D = 15 kernels' records."""
    s, sms, chain = ctx
    fx = np.load(fixture)
    sc, cfg, prob, ep = s.sc, s.cfg, s.prob, s.ep
    check(json.loads(str(fx["config_json"])) == json.loads(json.dumps(dataclasses.asdict(cfg))),
          "the level-1 solvers fixture was made with another configuration")
    check(np.allclose(fx["episode_checksums"], s.fx["episode_checksums"], rtol=1e-12, atol=0),
          "the level-1 solvers fixture was made on another drive")
    thresholds = tuple(sc["thresholds"])
    n_iter = len(thresholds) * sc["lm_iters"]
    T = prob.p_odo.shape[0]
    lines, failed, d15 = [], [], None
    for solve in ("pose", "imu"):
        for solver in ("pcg", "chol_pcg"):
            key = f"{solve}_{solver}"
            before = kernel_launches("band_cholesky"), kernel_launches("band_cholesky_solve")
            if solve == "pose":
                secs, out = _sync_s(lambda: batch_mod.optimize_batch_sms1(
                    cfg, prob, sms, thresholds=thresholds, lm_iters=sc["lm_iters"],
                    solver=solver))
            else:
                secs, out = _sync_s(lambda: batch_mod.optimize_batch_sms1_imu(
                    cfg, prob, sms, chain, thresholds=thresholds, lm_iters=sc["lm_iters"],
                    solver=solver))
            n_chol = kernel_launches("band_cholesky") - before[0]
            n_solve = kernel_launches("band_cholesky_solve") - before[1]
            want = (n_iter, CHOL_PCG_APPLIES * n_iter) if solver == "chol_pcg" else (0, 0)
            check(dev.type != "cuda" or (n_chol, n_solve) == want,
                  f"level 1 {key}: band kernels launched {(n_chol, n_solve)} times, not {want}")
            if key == "imu_chol_pcg":
                d15 = (n_chol, n_solve)
            # 10x JAX's own spread under a +-1e-9 m nudge of the odometry,
            # associated and solved again (for chol_pcg also under a 1-ulp
            # rescaling of its preconditioner), as phase 8 holds the direct solve.
            names = "pqv" if solve == "imu" else "pq"
            rep = []
            # Beside each: how far JAX's result with its own association (f32
            # eigensystem) lies from the one with the f64 eigensystem.
            for n, a in zip(names, out):
                try:
                    rep.append(_held(n, a, fx, f"{key}_{n}", [f"{key}_nudge_d{n}"] + (
                        [f"{key}_f32_nudge_d{n}"] if solver == "chol_pcg" else [])))
                except RuntimeError as err:     # report every solve before failing
                    failed.append(f"level 1 {key}: {err}")
                    rep.append(f"{n} FAILED")
                rep[-1] += f" [JAX f32 eig {float(fx[f'{key}_f32eig_d{n}']):.3e}]"
            lines.append(f"{solve} {solver}: {secs:.3f} s ({1e3 * secs / n_iter:.1f} ms per LM "
                         f"iteration), band kernels {n_chol} / {n_solve}; vs JAX: "
                         + ", ".join(rep) + f"; RMSE vs truth {_rmse(out[0], ep.gt_p):.4f} m")
    print(f"level-1 iterative solvers T={T}, seed {sc['seed']} (4 stages x {sc['lm_iters']} "
          f"LM iterations, phase 8's association; tol 10x JAX f64's own spread, its eigensystem "
          f"in f64; in brackets JAX's own association's distance from that):\n  "
          + "\n  ".join(lines))
    check(not failed, "; ".join(failed))
    # The D = 15 kernels on the 15-dof solve's first band.
    hw = cfg.estimator.search_range + 1
    zeros = torch.zeros((T, 3), dtype=torch.float64, device=dev)
    band, grad = batch_mod._sms1_imu_system(
        prob.p_odo, prob.q_odo, batch_mod.initial_velocity(prob), zeros, zeros, prob, sms,
        chain, thresholds[0], hw, batch_mod.assembly_plan(prob, hw),
        batch_mod.imu_chain_plan(T, hw, dev), batch_mod._imu_params(cfg).gravity_vec(dev))
    batch_mod._damp(band, torch.tensor(1e-4, dtype=torch.float64, device=dev), hw)
    rec = band_chol_record(dev, banded._equilibrate(band)[0].to(torch.float32).contiguous())
    M = banded.f32_chol_precond(band)
    solve_rec = band_chol_solve_record(dev, M.Lb, (-grad * M.s).to(torch.float32))
    rec["launches"], solve_rec["launches"] = d15
    return rec, solve_rec


def main():
    t_start = time.perf_counter()
    dev = device_phase()
    print(f"build: {_build.build_all():.1f} s")
    knn_kern, copy_kern, imu_kern = kernel_phase(dev)
    launches = replay_phase(dev)
    copy_launches = probe_phase()
    batch_ctx = batch_phase(dev)
    pipeline_phase(dev)
    pairs_kern, sms1_ctx = sms1_phase(dev)
    pairs_kern["max_abs_err"] = knn_kern.pop("max_abs_err_pairs")
    pipeline_phase(dev, level=1)
    lc_phase(dev)
    fusion_launches = fusion_phase(dev)
    loop_launches, loop_ctx = loop_phase(dev)
    loop_rec = loop_kernel(dev, *loop_ctx)
    loop_rec["launches"] = loop_launches
    dense_phase(dev)
    odo_launches, raw_launches, odo_rec, win_rec = raw_input_phase(dev)
    knn_kern["odometry_2048x16384"] = odo_rec
    knn_kern["window_10240x16384"] = win_rec
    knn_kern["loop_verify"] = loop_rec
    knn_kern["max_abs_err"] = max(knn_kern["max_abs_err"], loop_rec["max_abs_err"],
                                  odo_rec["max_abs_err"], win_rec["max_abs_err"])
    long_launches, dopp_launches, chol_kern, solve_kern, carrier_s = gnss_phase(dev)
    t16 = time.perf_counter()
    chol7, solve7 = batch_variants_phase(dev)
    t17 = time.perf_counter()
    chol15, solve15 = sms1_solvers_phase(dev, sms1_ctx)
    del sms1_ctx
    t_end = time.perf_counter()
    print(f"phases 15.6-17 (carrier phase, batch variants, level-1 solvers): "
          f"{t_end - t16 + carrier_s:.0f} s ({carrier_s:.0f} + {t17 - t16:.0f} + "
          f"{t_end - t17:.0f})")
    sharded_phase(dev, batch_ctx)
    del batch_ctx
    t19 = time.perf_counter()
    item9_phase(dev)
    print(f"phases 18-19 (multi-device, small functions): {time.perf_counter() - t_end:.0f} s "
          f"({t19 - t_end:.0f} + {time.perf_counter() - t19:.0f})")
    knn_kern["launches_by_path"] = {"replay": launches, "backend_fusion": fusion_launches,
                                    "loop_closure": loop_launches, "odometry": odo_launches,
                                    "raw_input_replay": raw_launches,
                                    "long_run": long_launches, "doppler_window": dopp_launches}
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": [
        {"name": "knn5_f32", "route": "cuda", "source": "glio_tpu_torch/csrc/knn.cu",
         "replaces": "glio_tpu/ops/knn_pallas.py:30", "launches": launches, **knn_kern},
        {"name": "knn5_pairs_f32", "route": "cuda", "source": "glio_tpu_torch/csrc/knn.cu",
         "replaces": "glio_tpu/ops/knn_pallas.py:30", **pairs_kern},
        {"name": "copy_f32", "route": "cuda", "source": "glio_tpu_torch/csrc/copy.cu",
         "replaces": "scripts/probe_pallas.py:28", "launches": copy_launches, **copy_kern},
        {"name": "imu_preint_f64", "route": "cuda", "source": "glio_tpu_torch/csrc/imu_preint.cu",
         "replaces": None, "replaces_note": "no TPU kernel: the port's loop over the IMU slots, "
                                           "factors/imu.py::preintegrate_reference", **imu_kern},
        {"name": "band_chol_f32", "route": "cuda", "source": "glio_tpu_torch/csrc/band_chol.cu",
         "replaces": "glio_tpu/solver/banded.py:135",
         "replaces_note": "no Pallas kernel: the plain-JAX block_cholesky (a lax.scan) that "
                          "_f32_chol_precond calls in f32", **chol_kern},
        {"name": "band_chol_solve_f32", "route": "cuda",
         "source": "glio_tpu_torch/csrc/band_chol.cu", "replaces": "glio_tpu/solver/banded.py:184",
         "replaces_note": "no Pallas kernel: the plain-JAX block_cholesky_solve (two lax.scans) "
                          "that _f32_chol_precond's apply calls in f32", **solve_kern},
        *({"name": f"band_chol_f32_d{D}", "route": "cuda",
           "source": "glio_tpu_torch/csrc/band_chol.cu", "replaces": "glio_tpu/solver/banded.py:135",
           "replaces_note": f"no Pallas kernel: block_cholesky in f32 at D = {D} ({what})",
           **chol} for D, what, chol in ((7, "optimize_batch_atm, chol_pcg", chol7),
                                         (15, "level 1 with IMU chains, chol_pcg", chol15))),
        *({"name": f"band_chol_solve_f32_d{D}", "route": "cuda",
           "source": "glio_tpu_torch/csrc/band_chol.cu", "replaces": "glio_tpu/solver/banded.py:184",
           "replaces_note": f"no Pallas kernel: block_cholesky_solve in f32 at D = {D} ({what})",
           **solve} for D, what, solve in ((7, "optimize_batch_atm, chol_pcg", solve7),
                                           (15, "level 1 with IMU chains, chol_pcg", solve15)))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
