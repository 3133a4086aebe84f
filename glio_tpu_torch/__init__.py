"""glio_tpu_torch: the GLIO estimator in PyTorch, with hand-written CUDA kernels for Hopper.

A port of ``glio_tpu`` (JAX), which stays in the repository as the
reference. This package imports torch and never jax. Ported so far:
``pipeline.run_pipeline`` stages 1 and 2 — the tightly-coupled
sliding-window replay (``models.sliding_window.SlidingWindowEstimator``),
whose 5-NN association runs the CUDA kernel ``csrc/knn.cu`` on the card,
and the level-0 batch fusion (``models.batch``) — and the toolchain probe
``ops.probe`` with its CUDA copy kernel ``csrc/copy.cu``.
"""
