"""The working precision of the frozen reference.

``F64`` is read at every call, so ``lowered()`` runs the same code with
float32 wherever the port computes in float64: the control of the
benchmark's correctness comparison.
"""

import contextlib

import torch

F64 = torch.float64


@contextlib.contextmanager
def lowered():
    """float32 in place of float64 while the block runs."""
    global F64
    F64 = torch.float32
    try:
        yield
    finally:
        F64 = torch.float64
