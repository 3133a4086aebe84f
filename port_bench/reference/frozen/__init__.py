"""A frozen copy of the plain paths of ``glio_tpu_torch`` that the benchmark's
cells run: the sliding-window step, the level-0 batch, their factors and
solvers, the simulator that makes the traffic and the configuration.

Copied file for file with the package layout kept, trimmed to what the
reference calls, with three changes: the plain 5-NN (``ops/knn.py``) stands
where the port launches its CUDA kernel; float64 is read from
``precision.F64`` at every call, so that ``precision.lowered()`` runs the
same code in float32 (the control); and nothing here imports the port, so a
change to the program changes neither the traffic nor the reference.
"""
