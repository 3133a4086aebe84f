"""A uniform sample of a run's units, drawn from the seed as they come."""

import numpy as np


class Reservoir:
    """Algorithm R over units 0, 1, ...: ``slot(i)`` says, before unit i
    runs, which of the ``n`` places it takes (None: it is not kept), so the
    unit's outputs can be kept without keeping every unit's."""

    def __init__(self, n: int, seed: int):
        self.n = n
        self.rng = np.random.default_rng([seed, 0x5A3])
        self.items = [None] * n

    def slot(self, i: int):
        if i < self.n:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.n else None

    def put(self, slot, item):
        if slot is not None:
            self.items[slot] = item

    def kept(self) -> list:
        return [x for x in self.items if x is not None]
