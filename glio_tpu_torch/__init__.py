"""glio_tpu_torch: the GLIO estimator in PyTorch, with hand-written CUDA kernels for Hopper.

A port of ``glio_tpu`` (JAX), which stays in the repository as the
reference. This package imports torch and never jax. The slice ported so
far is the tightly-coupled sliding-window replay
(``models.sliding_window.SlidingWindowEstimator``); its 5-NN association
runs the CUDA kernel ``csrc/knn.cu`` on the card.
"""
