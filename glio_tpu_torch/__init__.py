"""glio_tpu_torch: the GLIO estimator in PyTorch, with hand-written CUDA kernels for Hopper.

A port of ``glio_tpu`` (JAX), which stays in the repository as the
reference. This package imports torch and never jax. It runs everything the
JAX package runs:

* ``pipeline.run_pipeline``, stages 1-3: the tightly-coupled sliding-window
  replay (``models.sliding_window``), with GNSS and Doppler rows and backend
  fusion; the batch fusion at level 0 and level 1 (``models.batch``: the
  ``direct``, ``pcg`` and ``chol_pcg`` solvers, the zenith-bias, cadence and
  incremental variants, the covariances); the RTK / LC stage and its
  carrier-phase variant (``gnss``, ``models.lc_fusion``); loop closure, dense
  frames and the map export;
* raw input: rosbag / PCD ingest, the LiDAR front end and odometry, RINEX
  decoding and conversion (``data``, ``models.preprocessing``, ``gnss``);
* the multi-device batch solve over ``torch.distributed`` (``parallel``:
  the SPIKE-partitioned cyclic reduction, the time-sharded PCG and
  ``models.batch.optimize_batch_sharded``, ranks started by
  ``parallel.launch.run_ranks``);
* the small helpers: SO(3) and quaternion utilities, the dense solvers, the
  KML and skyplot writers, the npz checkpoint and the profiler.

Its CUDA kernels (``csrc/``, bound by ``ops``): the exact 5-NN ``knn.cu``
(the JAX package's one Pallas kernel), the toolchain probe's copy
``copy.cu``, and the f32 band Cholesky factor and solve ``band_chol.cu`` of
``chol_pcg``. On CPU tensors each wrapper runs its plain torch version.
"""
