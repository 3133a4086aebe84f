"""Port parity: ``optimize_batch_incremental``, ``_original_hops`` and
``_chain_hops`` (``models/batch.py``) against the JAX package, on the problem
of ``tests/test_torch_batch_variants.py``.

The incremental modes chain odometry hops on the host and re-derive the
relatives from each result: held to 1e-6 m and 1e-8.
"""

import numpy as np
import pytest

from glio_tpu.models import batch as JB
from glio_tpu_torch.models import batch as TB
from test_torch_batch_variants import CFG, TCFG, _close, _f64, problem  # noqa: F401


@pytest.mark.parametrize("rederive", [True, False], ids=["rederive", "original"])
def test_optimize_batch_incremental_matches_jax(problem, rederive):
    """Re-solves every 40 keyframes, the hops chained on the host, then two
    relaxation passes (with ``rederive``)."""
    prob, prob_t, kf_time, p_true = problem
    kw = dict(every=40, lm_iters=3, rederive=rederive,
              relaxation_passes=2 if rederive else 0)
    p_j, q_j = _f64(lambda: JB.optimize_batch_incremental(CFG, prob, kf_time, **kw))
    p_t, q_t = TB.optimize_batch_incremental(TCFG, prob_t, kf_time, **kw)
    _close(p_t, p_j, 1e-6, "p")
    _close(q_t, q_j, 1e-8, "q")
    e0 = np.linalg.norm(prob_t.p_odo.numpy() - p_true, axis=-1).mean()
    assert np.linalg.norm(p_t.numpy() - p_true, axis=-1).mean() < e0


def test_original_hops_and_chain_match_jax(problem):
    prob, prob_t, _, _ = problem
    got, want = TB._original_hops(prob_t), JB._original_hops(prob)
    for a, b in zip(got, want):
        _close(a, b, 1e-12, "hops")
    p_t, q_t = (np.zeros((120, 3)), np.tile([1.0, 0, 0, 0], (120, 1)))
    p_j, q_j = p_t.copy(), q_t.copy()
    TB._chain_hops(p_t, q_t, *got, 0, 120)
    JB._chain_hops(p_j, q_j, *want, 0, 120)
    _close(p_t, p_j, 1e-9, "p")
    _close(q_t, q_j, 1e-12, "q")
