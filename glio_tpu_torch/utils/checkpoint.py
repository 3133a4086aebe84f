"""Checkpoint / resume of estimator state (port of ``glio_tpu/utils/checkpoint.py``'s npz pair).

An estimator's carry is a tree of tensors (named tuples, tuples, lists and
dicts), so a checkpoint is its leaves in an npz archive. The leaves are in
the order ``jax.tree_util`` flattens the JAX package's carries: tuple and
named-tuple fields in order, dict entries by sorted key, ``None`` no leaf.
So an archive of ``SlidingWindowEstimator.make_initial_carry`` lines up with
one of the JAX ``init_carry``. The JAX package's orbax pair has no torch
counterpart and is not ported.
"""

import numpy as np
import torch


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(like, leaves):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(t, leaves) for t in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(t, leaves) for t in like)
    return next(leaves)


def cloned(tree):
    """A (nested) named tuple of tensors with every tensor cloned."""
    return _rebuild(tree, iter([x.clone() for x in _leaves(tree)]))


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_pytree(path: str, tree) -> None:
    """Save a tree of tensors as an npz archive of its leaves."""
    np.savez_compressed(path, *[_host(x) for x in _leaves(tree)])


def load_pytree(path: str, like):
    """Load a checkpoint written by ``save_pytree`` into the structure of the
    template ``like``: tensors of the template leaves' dtypes on their devices."""
    z = np.load(path)
    arrays = [z[k] for k in z.files]
    flat = _leaves(like)
    if len(arrays) != len(flat):
        raise ValueError(f"checkpoint has {len(arrays)} leaves, template has {len(flat)}")
    out = [torch.as_tensor(a).to(dtype=t.dtype, device=t.device) if isinstance(t, torch.Tensor)
           else torch.as_tensor(a) for a, t in zip(arrays, flat)]
    return _rebuild(like, iter(out))
