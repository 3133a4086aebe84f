"""The window LM as one function of its tensors (``_solve_window``) and, on a
CUDA device, as the replay of a CUDA graph captured for each input signature
(``SlidingWindowEstimator._lm``).

On the CPU: the function gives, bit for bit, what the step's former closure
gave (``closure_path`` below), with and without GNSS and Doppler rows; a CPU
step counts one direct call and no graph; ``lm_solve``'s damping starts at
``LAMBDA_INIT``. The tests marked ``cuda`` need an NVIDIA GPU and skip
without one; the file imports no jax, so on a machine with only torch:

    python -m pytest --noconftest -m cuda tests/test_torch_window_lm_graph.py
"""

import numpy as np
import pytest
import torch

from glio_tpu_torch.config import EstimatorConfig, GlioConfig, ShapeConfig
from glio_tpu_torch.data.simulator import simulate_episode, simulate_gnss_epochs
from glio_tpu_torch.models import sliding_window as sw
from glio_tpu_torch.solver import dense
from glio_tpu_torch.solver.manifold import POSE_DOF, retract, tree_where
from glio_tpu_torch.utils import profiling, quat
from glio_tpu_torch.utils.checkpoint import _leaves

ROWS = {"lio": {}, "dd": {"gnss_in_sliding_window": True},
        "doppler": {"gnss_in_sliding_window": True, "doppler_in_window": True}}


def _setup(rows: str, n_keyframes: int, device, sw_max_iter: int = 3):
    cfg = GlioConfig().replace(
        shapes=ShapeConfig(max_imu_per_interval=40, scan_points=256, map_points=2048),
        estimator=EstimatorConfig(local_map_width=8, sw_max_iter=sw_max_iter, **ROWS[rows]))
    ep = simulate_episode(n_keyframes=n_keyframes, scan_points=256, seed=1)
    if rows != "lio":
        ep.gnss = simulate_gnss_epochs(
            ep.gt_p, ep.kf_time, np.asarray(cfg.initialization.anc_ecef),
            np.asarray(cfg.initialization.station_ecef), psr_noise=0.3, epoch_stride=1,
            seed=1)
    est = sw.SlidingWindowEstimator(cfg, device)
    inputs = ep.to_inputs(device)
    max_sv = 32 if inputs.gnss is None else inputs.gnss.sv_valid.shape[-1]
    carry = est.make_initial_carry(ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0,
                                   n_imu=inputs.imu_acc.shape[-2], max_sv=max_sv)
    return est, inputs, carry


def closure_path(est, w_new, ddt_ring, pres, imu_S, imu_edge_valid, lidar32,
                 prior_sqrt_jac, prior_sqrt_res, prior_valid, prior_lin, gnss_win):
    """Step 6 as the step wrote it before ``_solve_window``: a closure over
    the step's locals, the LM and the divergence gates."""
    K, newest = est.K, est.K - 1

    def residual_anchored(s):
        s, ddt_s = (s.win, s.ddt) if est.use_dopp else (s, None)
        r = est._window_residual(s, pres, imu_S, imu_edge_valid, lidar32,
                                 prior_sqrt_jac, prior_sqrt_res, prior_valid, prior_lin,
                                 gnss_win if est.use_gnss else None, ddt_s)
        anchor = torch.cat([
            1e2 * (s.p[0] - w_new.p[0]),
            1e2 * quat.log(quat.mul(quat.conj(w_new.q[0]), s.q[0])),
        ])
        anchor = torch.where(prior_valid, torch.zeros_like(anchor), anchor)
        bias_reg = torch.cat([10.0 * s.ba.reshape(-1), 30.0 * s.bg.reshape(-1)])
        return torch.cat([r, anchor, bias_reg])

    iters = est.cfg.estimator.sw_max_iter
    if est.use_dopp:
        out = dense.lm_solve(residual_anchored, sw.retract_ddt,
                             sw.WindowStateDdt(w_new, ddt_ring), K * POSE_DOF + K,
                             max_iters=iters)
        solved, ddt_solved = out.x
    else:
        out = dense.lm_solve(residual_anchored, retract, w_new, K * POSE_DOF, max_iters=iters)
        solved, ddt_solved = out.x, ddt_ring
    ok = (torch.isfinite(solved.p).all()
          & (quat.norm(solved.p[newest] - w_new.p[newest]) < 100.0)
          & (torch.sqrt(torch.sum(solved.v * solved.v)) < 100.0 * K)
          & (solved.ba.abs().max() < 2.0)
          & (solved.bg.abs().max() < 2.0)
          & (ddt_solved.abs() < 1e4).all())
    return tree_where(ok, solved, w_new), torch.where(ok, ddt_solved, ddt_ring), out.cost


def _spy(est):
    """Record the arguments of each ``_lm`` call of ``est``."""
    calls, lm = [], est._lm

    def spy(*args):
        calls.append(args)
        return lm(*args)
    est._lm = spy
    return calls


def _equal_trees(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("rows", list(ROWS))
def test_solve_window_equals_the_closure_path(rows):
    """Six keyframes (the prior comes in at the fifth): at each, the
    function's results equal the former closure's bit for bit."""
    est, inputs, carry = _setup(rows, 6, "cpu")
    calls = _spy(est)
    est.replay_from(carry, inputs)
    assert len(calls) == 6
    assert bool(calls[-1][8]) and not bool(calls[0][8])     # prior_valid
    assert (calls[0][-1] is None) == (rows == "lio")
    for args in calls:
        got = est._solve_window(*args)
        assert _equal_trees(got, closure_path(est, *args))


def test_cpu_step_counts_only_direct_calls():
    est, inputs, carry = _setup("doppler", 2, "cpu", sw_max_iter=1)
    before = profiling.tallies()
    est.step(carry, sw.index_inputs(inputs, 0))
    after = profiling.tallies()
    names = ("window.lm.eager", "window.lm.replays", "window.lm.captures")
    got = [after.get(n, 0) - before.get(n, 0) for n in names]
    assert got == [1, 0, 0]
    assert est._lm_graphs == {}


def test_lm_damping_starts_at_lambda_init():
    x0 = sw.WindowState(*(torch.zeros((2, n), dtype=torch.float64) for n in (3, 4, 3, 3, 3)))
    x0 = x0._replace(q=x0.q + torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64))
    out = dense.lm_solve(lambda s: s.p.reshape(-1) - 1.0, retract, x0, 2 * POSE_DOF,
                         max_iters=0)
    assert out.lam.dtype == torch.float64 and out.lam.shape == ()
    assert out.lam.item() == dense.LAMBDA_INIT


# -- on the card -------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the LM is captured as a CUDA graph only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_keyframes_equal_the_direct_path_on_card(cuda):
    """20 keyframes with DD and Doppler rows: each step's carry and output
    through the graph equal those of the direct call on the card, bit for
    bit; one capture, 20 replays; what step t returned is unchanged after
    step t + 1 (no result aliases the graph's static buffers)."""
    graphed, inputs, carry_g = _setup("doppler", 20, cuda, sw_max_iter=15)
    direct, _, carry_d = _setup("doppler", 20, cuda, sw_max_iter=15)
    direct._lm = direct._solve_window
    before = profiling.tallies()
    kept = None
    for t in range(20):
        inp = sw.index_inputs(inputs, t)
        carry_g, out_g = graphed.step(carry_g, inp)
        carry_d, out_d = direct.step(carry_d, inp)
        assert _equal_trees(carry_g, carry_d), t
        assert _equal_trees(out_g, out_d), t
        if kept is not None:
            assert _equal_trees(kept[0], kept[1]), t
        kept = ((carry_g, out_g), (sw.cloned(carry_g), sw.cloned(out_g)))
    after = profiling.tallies()
    assert after.get("window.lm.captures", 0) - before.get("window.lm.captures", 0) == 1
    assert after.get("window.lm.replays", 0) - before.get("window.lm.replays", 0) == 20
    assert after.get("window.lm.eager", 0) == before.get("window.lm.eager", 0)
    assert len(graphed._lm_graphs) == 1


@pytest.mark.cuda
def test_doppler_and_lio_windows_capture_their_own_graphs(cuda):
    keys = []
    for rows in ("doppler", "lio"):
        est, inputs, carry = _setup(rows, 3, cuda)
        before = profiling.tallies().get("window.lm.captures", 0)
        est.replay_from(carry, inputs)
        assert profiling.tallies()["window.lm.captures"] == before + 1
        assert len(est._lm_graphs) == 1
        keys += list(est._lm_graphs)
    assert keys[0] != keys[1]


@pytest.mark.cuda
def test_replay_makes_no_host_sync(cuda):
    est, inputs, carry = _setup("doppler", 3, cuda)
    carry, _ = est.step(carry, sw.index_inputs(inputs, 0))     # the capture
    lm = est._lm

    def strict(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return lm(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    est._lm = strict
    for t in (1, 2):
        carry, _ = est.step(carry, sw.index_inputs(inputs, t))
    torch.cuda.synchronize()
    assert len(est._lm_graphs) == 1
