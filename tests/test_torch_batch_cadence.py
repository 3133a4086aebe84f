"""Port parity: ``optimize_batch_reference_cadence`` and ``_mask_prefix``
(``models/batch.py``) against the JAX package, on the problem of
``tests/test_torch_batch_variants.py``. The cadence's solves are ``direct``:
held to ``P_TOL`` / ``Q_TOL`` against JAX's f64, and bit for bit to the
port's own ``optimize_batch`` of the whole problem.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.models import batch as JB
from glio_tpu_torch.models import batch as TB
from test_torch_batch_variants import CFG, P_TOL, Q_TOL, TCFG, _close, _f64, problem  # noqa: F401


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_reference_cadence_matches_jax(problem, warm):
    """Re-solves every 40 keyframes (30, 70, 110), then the full problem:
    the result is ``optimize_batch`` of the whole problem, bit for bit, and
    JAX's within round-off."""
    prob, prob_t, _, _ = problem
    kw = dict(every=40, lm_iters=3, final_lm_iters=5, warm_start=warm, warm_lm_iters=3)
    p_j, q_j, st_j = _f64(lambda: JB.optimize_batch_reference_cadence(CFG, prob, **kw))
    p_t, q_t, st_t = TB.optimize_batch_reference_cadence(TCFG, prob_t, **kw)
    assert st_t["n_resolves"] == st_j["n_resolves"] == 3
    assert 0 < st_t["resolve_max_s"] and st_t["total_s"] >= st_t["final_s"] > 0
    p_once, q_once, _ = TB.optimize_batch(TCFG, prob_t, lm_iters=5)
    assert torch.equal(p_t, p_once) and torch.equal(q_t, q_once)
    _close(p_t, p_j, P_TOL, "p")
    _close(q_t, q_j, Q_TOL, "q")


def test_mask_prefix_matches_jax(problem):
    prob, prob_t, _, _ = problem
    for n in (30, 70, 119):
        got = TB._mask_prefix(prob_t.rel_valid, prob_t.ep_valid, prob_t.ep_left, n)
        want = JB._mask_prefix(prob.rel_valid, prob.ep_valid, prob.ep_left,
                               jnp.asarray(n, jnp.int32))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
