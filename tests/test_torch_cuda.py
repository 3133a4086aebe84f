"""The port's CUDA path on the card: the k-NN kernel (single problems and
batches of keyframe pairs, the loop-closure ICP's 1024 x 25,600 among them)
and the copy kernel against their plain versions, bit for bit, the IMU
preintegration kernel against its loop within 1e-10, the f32
band Cholesky factor and solve kernels against their plain versions (at
the block sizes 6, 7 and 15) and ``chol_pcg``, the probe, the replay, the batch stage (and its
LM closures as CUDA graphs against the direct calls, bit for bit), batch level 1, stage
3, backend fusion, the LOAM features, the LiDAR odometry, SPP and the GNSS
window on the card against the same code on the CPU.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no jax, so it runs on a machine that has only torch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` sets up jax.)
"""

import dataclasses

import numpy as np
import pytest
import torch

from glio_tpu_torch.config import EstimatorConfig, GlioConfig, ShapeConfig
from glio_tpu_torch.data.simulator import (drifted_trajectory, random_walk_odometry,
                                           simulate_episode, simulate_gnss_epochs)
from glio_tpu_torch.factors import imu as timu
from glio_tpu_torch.lidar import neighbors
from glio_tpu_torch.models import batch
from glio_tpu_torch.models.sliding_window import SlidingWindowEstimator
from glio_tpu_torch.ops import band_chol, imu_preint
from glio_tpu_torch.ops import knn as knn_mod
from glio_tpu_torch.ops import probe
from glio_tpu_torch.solver import banded
from glio_tpu_torch.testing import (IMU_PREINT_CASES, KNN_CASES, KNN_PAIR_CASES, cloud,
                                    spd_band)
from glio_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda
F32 = np.float32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _launches(name):
    """The launches of the kernel wrapper ``name`` so far: its tally."""
    return profiling.tallies().get(name + ".launches", 0)


def _band_launches():
    return _launches("band_cholesky"), _launches("band_cholesky_solve")


@pytest.mark.parametrize("case", sorted(KNN_CASES))
def test_kernel_equals_plain_version(cuda, case):
    args = [torch.tensor(a, device=cuda) for a in KNN_CASES[case](np.random.default_rng(0))]
    before = _launches("knn")
    d_k, i_k = knn_mod.knn(*args)
    d_r, i_r = knn_mod.knn_reference(*args)
    torch.cuda.synchronize()
    assert _launches("knn") == before + 1
    assert torch.equal(i_k, i_r)
    assert torch.equal(d_k, d_r)


def test_kernel_rejects_other_k(cuda):
    args = [torch.tensor(a, device=cuda) for a in KNN_CASES["ragged"](np.random.default_rng(0))]
    with pytest.raises(ValueError):
        knn_mod.knn(*args, k=3)


def test_voxel_downsample_equals_cpu(cuda):
    pts, valid = cloud(np.random.default_rng(1), 51200, spread=60.0)
    out_c, v_c = neighbors.voxel_downsample(torch.tensor(pts), torch.tensor(valid),
                                            0.4, 16384, scatter_keys=True)
    out_g, v_g = neighbors.voxel_downsample(torch.tensor(pts, device=cuda),
                                            torch.tensor(valid, device=cuda),
                                            0.4, 16384, scatter_keys=True)
    assert v_c.all()                     # more voxels than rows: truncated
    assert torch.equal(v_g.cpu(), v_c) and torch.equal(out_g.cpu(), out_c)


def test_replay_on_card_matches_cpu(cuda):
    """Same port, two devices: the association must agree factor for factor
    and the trajectory to 1e-6 m (f64 sums in another order)."""
    cfg = GlioConfig().replace(
        shapes=ShapeConfig(max_imu_per_interval=40, scan_points=256, map_points=2048),
        estimator=EstimatorConfig(local_map_width=8, sw_max_iter=4))
    ep = simulate_episode(n_keyframes=6, scan_points=256, seed=1)
    outs = {}
    for dev in ("cpu", cuda):
        est = SlidingWindowEstimator(cfg, dev)
        outs[str(dev)] = est.replay(ep.to_inputs(dev), ep.p0, ep.q0, ep.v0,
                                    ep.acc0, ep.gyr0)
    c, g = outs["cpu"], outs[str(cuda)]
    assert torch.equal(c.n_lidar_factors, g.n_lidar_factors.cpu())
    np.testing.assert_allclose(g.p.cpu().numpy(), c.p.numpy(), rtol=0, atol=1e-6)


STAGE = probe.STAGE_BYTES // 4
COPY_CASES = {   # name: (elements of a buffer, the view's start, its stop)
    "empty": (0, 0, None),
    "probe_8x128": (8 * 128, 0, None),
    "ragged_1003": (1003, 0, None),
    "one_stage_minus_1": (STAGE - 1, 0, None),
    "one_stage": (STAGE, 0, None),
    "one_stage_plus_1": (STAGE + 1, 0, None),
    "more_chunks_than_sms_ragged": (300 * STAGE + 3, 0, None),
    "view_from_1": (300 * STAGE + 4, 1, None),
    "view_from_2": (300 * STAGE + 4, 2, None),
    "view_from_3": (300 * STAGE + 4, 3, None),
    "empty_view_at_3": (16, 3, 3),
}


@pytest.mark.parametrize("case", list(COPY_CASES))
def test_copy_kernel_equals_plain_version(cuda, case):
    n, start, stop = COPY_CASES[case]
    buf = torch.tensor(np.random.default_rng(0).normal(size=n).astype(F32), device=cuda)
    x = buf[start:stop]
    if case == "probe_8x128":
        x = x.reshape(8, 128)
    if case == "more_chunks_than_sms_ragged":
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert 4 * x.numel() > sms * probe.STAGE_BYTES
    before = _launches("copy")
    y = probe.copy(x)
    torch.cuda.synchronize()
    assert _launches("copy") == before + 1
    bits = x.view(torch.int32)
    assert torch.equal(y.view(torch.int32), bits)
    assert torch.equal(probe.copy_reference(x).view(torch.int32), bits)


def test_knn_launches_on_the_current_stream(cuda):
    """The inputs are written on a side stream after a sleep; a launch on any
    other stream would read them before they are written."""
    src = [torch.tensor(a, device=cuda) for a in KNN_CASES["main_path"](np.random.default_rng(0))]
    d_r, i_r = knn_mod.knn_reference(*src)
    args = [torch.zeros_like(a) for a in src]
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        for a, s in zip(args, src):
            a.copy_(s)
        d_k, i_k = knn_mod.knn(*args)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_r) and torch.equal(d_k, d_r)


def test_probe_passes_on_the_card(cuda, capsys):
    assert probe.main() == 0
    out = capsys.readouterr().out
    assert "CUDA-OK" in out and "copy_f32=1" in out


def test_scatter_add_blocks_on_card_equals_cpu(cuda):
    """Duplicates are summed in a fixed order, so the card gives the CPU's bits."""
    rng = np.random.default_rng(2)
    T, hw, D = 50, 3, 6
    band = rng.normal(size=(T, 2 * hw + 1, D, D))
    rows = rng.integers(0, T, size=2000)
    cols = np.clip(rows + rng.integers(-hw, hw + 1, size=2000), 0, T - 1)
    blocks = rng.normal(size=(2000, D, D))
    cpu = banded.scatter_add_blocks(torch.tensor(band), rows, cols, torch.tensor(blocks), hw)
    gpu = banded.scatter_add_blocks(torch.tensor(band, device=cuda), rows, cols,
                                    torch.tensor(blocks, device=cuda), hw)
    assert torch.equal(gpu.cpu(), cpu)


def _batch_problem(device, T=300):
    cfg = GlioConfig()
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    kf_time, p_true, q_true, p_odo = drifted_trajectory(T)
    gnss = simulate_gnss_epochs(p_true, kf_time, anchor, station, psr_noise=0.5, seed=4)
    return cfg, batch.build_problem(cfg, p_odo, q_true, kf_time, gnss, anchor, 0.0,
                                    station, device=device)


def test_batch_on_card_is_deterministic_and_matches_cpu(cuda):
    """Two solves on the card agree bit for bit; the card and the CPU agree
    to 3e-4 m and the final costs to 5e-7 relative, 10x the spread that
    the LM's accept/reject at the cost's round-off gives JAX's own f64
    solve (a 1e-9 m nudge of the odometry moves it 3.0e-5 m and its cost
    4.6e-8 relative; PERF.md)."""
    robust = batch.RobustOpts(dd_huber=1.0, epoch_gate=2.0, rel_huber=5.0)
    outs = []
    for dev in (cuda, cuda, "cpu"):
        cfg, prob = _batch_problem(dev)
        outs.append(batch.optimize_batch(cfg, prob, robust=robust))
    (p1, q1, c1), (p2, q2, c2), (pc, _, cc) = outs
    assert torch.equal(p1, p2) and torch.equal(q1, q2) and c1 == c2
    np.testing.assert_allclose(p1.cpu().numpy(), pc.numpy(), rtol=0, atol=3e-4)
    np.testing.assert_allclose(c1, cc, rtol=5e-7)


def _drive(device, seed, T=297):
    """A level-0 problem whose GNSS noise comes from ``seed``: drives of one
    shape (T = 297 is no other test's, so the first solve captures)."""
    cfg = GlioConfig()
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    kf_time, p_true, q_true, p_odo = drifted_trajectory(T)
    gnss = simulate_gnss_epochs(p_true, kf_time, anchor, station, psr_noise=0.5, seed=seed)
    return cfg, batch.build_problem(cfg, p_odo, q_true, kf_time, gnss, anchor, 0.0,
                                    station, device=device)


def _eager_closures(data, kind, *fns):
    """``batch.lm_closures`` without graphs, as the closures were before they
    were graphed: each the direct call, the threshold a Python float."""
    prob, plan, threshold = data
    data = (prob, plan, float(threshold))
    return tuple((lambda fn: lambda *args: fn(data, *args))(fn) for fn in fns)


def _recorded_solve(cfg, prob):
    """``optimize_batch`` (``direct``, 4 × 10) with each LM iteration's
    current and trial costs recorded by wrapping ``_lm_stage``, as the
    benchmark's reference does: (p, q, stage costs, currents, trials)."""
    stage, rec = batch._lm_stage, ([], [])

    def recorded(p0, q0, lm_iters, hw, assemble, step, trial_cost, agree=None):
        def assemble_rec(p, q):
            out = assemble(p, q)
            rec[0].append(out[2])
            return out

        def trial_rec(p, q, w_rel, w_dd):
            c = trial_cost(p, q, w_rel, w_dd)
            rec[1].append(c)
            return c
        return stage(p0, q0, lm_iters, hw, assemble_rec, step, trial_rec, agree)
    batch._lm_stage = recorded
    try:
        return (*batch.optimize_batch(cfg, prob), *rec)
    finally:
        batch._lm_stage = stage


def _graph_tallies():
    got = profiling.tallies()
    return [got.get("batch.graph." + n, 0) for n in ("captures", "replays", "eager")]


def test_batch_graphs_replay_each_drives_own_data(cuda, monkeypatch):
    """Two drives of one shape solved in turn through the graphed closures:
    each solve, its stage costs and its 40 + 40 recorded costs equal, bit for
    bit, those of the same solve by direct closures on the card with the
    threshold a Python float, so the second drive's data, not the first's,
    reaches the replayed graphs, and the threshold as a tensor changes no bit. The
    first solve captures the three closures once; no later solve of the
    shape captures; the recorded costs are 80 distinct tensors, read after
    the solve."""
    drives = [_drive(cuda, seed) for seed in (11, 12, 11)]
    before = _graph_tallies()
    graphed = []
    for cfg, prob in drives:
        graphed.append(_recorded_solve(cfg, prob))
        if len(graphed) == 1:
            assert _graph_tallies()[0] - before[0] == 3
    after = _graph_tallies()
    assert after[0] - before[0] == 3
    assert after[1] - before[1] == 3 * 3 * 40 and after[2] == before[2]
    monkeypatch.setattr(batch, "lm_closures", _eager_closures)
    eager = [_recorded_solve(cfg, prob) for cfg, prob in drives]
    assert _graph_tallies() == after
    for g, e in zip(graphed, eager):
        p, q, costs, current, trial = g
        assert torch.equal(p, e[0]) and torch.equal(q, e[1]) and costs == e[2]
        assert len(current) == len(trial) == 40
        assert torch.equal(torch.stack(current), torch.stack(e[3]))
        assert torch.equal(torch.stack(trial), torch.stack(e[4]))
        assert len({c.data_ptr() for c in current + trial}) == 80
    assert not torch.equal(graphed[0][0], graphed[1][0])
    assert torch.equal(graphed[0][0], graphed[2][0])


def test_batch_graph_replay_makes_no_host_sync(cuda, monkeypatch):
    """Once a shape is captured, its graphed closures (the data copied in,
    the replays, the clones) read nothing to the host."""
    cfg, prob = _drive(cuda, 11, T=298)
    batch.optimize_batch(cfg, prob, lm_iters=1)          # the captures
    closures = batch.lm_closures

    def strict(fn):
        def call(*args):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call
    monkeypatch.setattr(batch, "lm_closures",
                        lambda *a: tuple(strict(fn) for fn in closures(*a)))
    before = _graph_tallies()
    p, q, _ = batch.optimize_batch(cfg, _drive(cuda, 12, T=298)[1], lm_iters=2)
    after = _graph_tallies()
    assert after[0] == before[0] and after[1] - before[1] == 4 * 2 * 3
    assert torch.isfinite(p).all() and torch.isfinite(q).all()


def test_cyclic_reduction_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(3)
    T, hw, D = 500, 7, 6
    J = rng.normal(size=(T, 2 * hw + 1, D, D))
    band = np.zeros_like(J)
    band[:, hw] = np.einsum("tij,tkj->tik", J[:, hw], J[:, hw]) + 50 * np.eye(D)
    for o in range(1, hw + 1):
        blk = 0.3 * J[:T - o, hw + o]
        band[:T - o, hw + o] = blk
        band[o:, hw - o] = np.swapaxes(blk, -1, -2)
    b = rng.normal(size=(T, D))
    x_c = banded.cyclic_reduction_solve(torch.tensor(band), torch.tensor(b))
    x_g = banded.cyclic_reduction_solve(torch.tensor(band, device=cuda),
                                        torch.tensor(b, device=cuda)).cpu()
    assert (x_g - x_c).abs().max() <= 1e-10 * x_c.abs().max()
    r = banded.band_matvec(torch.tensor(band), x_g) - torch.tensor(b)
    assert r.abs().max() < 1e-9


def _stiff_band(device, broken=False):
    """The level-0 band at T = 300 at the odometry, threshold 6, the bench
    robust options and damping 1e-6 (a chain where chol_pcg's 14 CG
    iterations stop short); ``broken`` negates block row 150's diagonal
    block, so its f32 Cholesky breaks down there."""
    cfg, prob = _batch_problem(device)
    hw = cfg.estimator.search_range + 1
    band, grad, *_ = batch._assemble_core_impl(
        prob.p_odo, prob.q_odo, prob, 6.0, hw,
        robust=batch.RobustOpts(dd_huber=1.0, epoch_gate=2.0, rel_huber=5.0),
        plan=batch.assembly_plan(prob, hw))
    batch._damp(band, torch.tensor(1e-6, dtype=torch.float64, device=device), hw)
    if broken:
        band[150, hw] = -band[150, hw]
    return band, -grad


def _band_at(D, device, broken=False, T=300):
    """The band the kernels are held on at block size D: at D = 6 the stiff
    level-0 chain (equilibrated, f32); at D = 7 and 15 a diagonally dominant
    band of T block rows at hw 7 (``testing.spd_band``). ``broken`` negates
    block row T // 2's diagonal block."""
    if D == 6 and T == 300:
        band, _ = _stiff_band(device, broken)
        return banded._equilibrate(band)[0].to(torch.float32).contiguous()
    band = spd_band(T, 7, D, seed=D, device=device)
    if broken:
        band[T // 2, 7] = -band[T // 2, 7]
    return band


def _check_factor(band, L_k, broken):
    """The kernel's factor against ``block_cholesky``: NaN in the same rows
    (block row T // 2 alone where it breaks) and the rest within 2e-5 of the
    largest entry (chip_smoke.BAND_CHOL_RTOL)."""
    L_p = banded.block_cholesky(band, jitter=3e-4)
    bad = ~torch.isfinite(L_p).flatten(1).all(1)
    assert torch.equal(torch.isfinite(L_k), torch.isfinite(L_p))
    assert torch.nonzero(bad).flatten().tolist() == ([band.shape[0] // 2] if broken else [])
    fin = torch.isfinite(L_p)
    if bool(fin.any()):
        assert (L_k - L_p)[fin].abs().max() <= 2e-5 * L_p[fin].abs().max()
    return L_p, bad


def _check_solve(Lb, b, x_k):
    """The kernel's solve against ``block_cholesky_solve``: within the larger
    of 2e-5 of max |x| and 10x the plain version's own f32 round-off against
    f64 (chip_smoke.BAND_SOLVE_RTOL and its bound)."""
    x_p = banded.block_cholesky_solve(Lb, b)
    x_64 = banded.block_cholesky_solve(Lb.double(), b.double())
    scale = x_p.abs().max()
    roundoff = (x_p.double() - x_64).abs().max() / scale
    assert bool(torch.isfinite(x_k).all())
    assert (x_k - x_p).abs().max() <= max(2e-5, 10 * float(roundoff)) * scale


def _identity_rows(L, bad):
    """The factor with each broken block row the identity, as
    ``f32_chol_precond`` makes it."""
    D = L.shape[-1]
    eye_row = torch.zeros_like(L[0])
    eye_row[0] = torch.eye(D, device=L.device)
    return torch.where(bad[:, None, None, None], eye_row, L).contiguous()


@pytest.mark.parametrize("D", [6, 7, 15])
@pytest.mark.parametrize("broken", [False, True], ids=["sound", "broken_row"])
def test_band_cholesky_kernel_matches_plain_version(cuda, D, broken):
    """The f32 factor kernel against ``block_cholesky`` on the card at each
    built block size (hw 7), one launch: the stiff level-0 chain at D = 6
    (the pose blocks), a diagonally dominant band at D = 7 (pose and zenith
    bias) and 15 (level 1's IMU-chain states), 300 block rows each."""
    band = _band_at(D, cuda, broken)
    before = _launches("band_cholesky")
    L_k = band_chol.band_cholesky(band, 3e-4)
    assert _launches("band_cholesky") == before + 1
    _check_factor(band, L_k, broken)


@pytest.mark.parametrize("D", [6, 7, 15])
@pytest.mark.parametrize("broken", [False, True], ids=["sound", "identity_row"])
def test_band_cholesky_solve_kernel_matches_plain_version(cuda, D, broken):
    """The f32 solve kernel against ``block_cholesky_solve`` on the card at
    each built block size, one launch: at D = 6 ``chol_pcg``'s factor of the
    stiff chain and its right-hand side, at D = 7 and 15 the factor of
    ``_band_at``'s band and a random right-hand side; where ``broken``, block
    row 150 of the factor is the identity (its Cholesky broke down)."""
    if D == 6:
        band, g = _stiff_band(cuda, broken)
        M = banded.f32_chol_precond(band)
        Lb, b = M.Lb, (g * M.s).to(torch.float32)
    else:
        band = _band_at(D, cuda, broken)
        Lb = _identity_rows(*_check_factor(band, band_chol.band_cholesky(band, 3e-4), broken))
        b = torch.tensor(np.random.default_rng(D).normal(size=(300, D)), dtype=torch.float32,
                         device=cuda)
    eye_row = torch.zeros_like(Lb[0])
    eye_row[0] = torch.eye(D, device=cuda)
    assert torch.equal(Lb[150], eye_row) == broken
    before = _launches("band_cholesky_solve")
    x_k = band_chol.band_cholesky_solve(Lb, b)
    assert _launches("band_cholesky_solve") == before + 1
    _check_solve(Lb, b, x_k)


@pytest.mark.parametrize("D", [6, 7, 15])
@pytest.mark.parametrize("T", [1, 5])
def test_band_kernels_on_short_chains(cuda, D, T):
    """Chains shorter than the kernels' pipelines (T = 5 < hw + 2, and T =
    1): both kernels at hw 7 against their plain versions, as above, with
    block row T // 2 broken where T > 1."""
    broken = T > 1
    band = _band_at(D, cuda, broken, T=T)
    before = _band_launches()
    L_p, bad = _check_factor(band, band_chol.band_cholesky(band, 3e-4), broken)
    Lb = _identity_rows(L_p, bad)
    b = torch.tensor(np.random.default_rng(T).normal(size=(T, D)), dtype=torch.float32,
                     device=cuda)
    _check_solve(Lb, b, band_chol.band_cholesky_solve(Lb, b))
    after = _band_launches()
    assert after == (before[0] + 1, before[1] + 1)


def test_band_kernels_refuse_unaligned_views(cuda):
    """A band or factor that starts 4 bytes into its buffer: the kernels
    stream rows in 16-byte copies, so the wrappers raise, launching
    nothing."""
    band, g = _stiff_band(cuda)
    band_s = banded._equilibrate(band)[0].to(torch.float32).contiguous()
    M = banded.f32_chol_precond(band)

    def shifted(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        return view
    before = _band_launches()
    with pytest.raises(ValueError):
        band_chol.band_cholesky(shifted(band_s), 3e-4)
    with pytest.raises(ValueError):
        band_chol.band_cholesky_solve(shifted(M.Lb), (g * M.s).to(torch.float32))
    assert _band_launches() == before


def test_band_kernels_refuse_unbuilt_shapes_on_card(cuda):
    """D = 8 and D = 15 at hw = 9 (past its shared memory): the wrappers
    raise, launching nothing."""
    before = _band_launches()
    for D, hw in ((8, 3), (15, 9)):
        band = spd_band(20, hw, D, device=cuda)
        with pytest.raises(ValueError):
            band_chol.band_cholesky(band, 3e-4)
        with pytest.raises(ValueError):
            band_chol.band_cholesky_solve(torch.zeros((20, hw + 1, D, D), device=cuda),
                                          torch.zeros((20, D), device=cuda))
    assert _band_launches() == before


def test_atm_chol_pcg_on_card_matches_cpu(cuda):
    """The 7-dof band of ``optimize_batch_atm`` on the T = 300 drive (its
    zenith biases at 0.1 m, threshold 6, damping 1e-6): ``pcg_chol_solve``
    on the card (the D = 7 kernels) against the CPU within 1e-5 of |x|, as
    at D = 6."""
    xs = []
    for dev in (cuda, "cpu"):
        cfg, prob = _batch_problem(dev)
        hw = cfg.estimator.search_range + 1
        z = torch.full((300,), 0.1, dtype=torch.float64, device=dev)
        band, grad, *_ = batch._atm_system(cfg, prob, prob.p_odo, prob.q_odo, z, 6.0, hw,
                                           batch.NO_ROBUST, batch.assembly_plan(prob, hw))
        assert band.shape == (300, 2 * hw + 1, 7, 7)
        batch._damp(band, torch.tensor(1e-6, dtype=torch.float64, device=dev), hw)
        xs.append(banded.pcg_chol_solve(band, -grad).cpu())
    assert (xs[0] - xs[1]).abs().max() <= 1e-5 * xs[1].abs().max()


def test_chol_pcg_on_card_matches_cpu(cuda):
    """``pcg_chol_solve`` on the stiff chain, card (the kernels' factor and
    solves) against CPU (``block_cholesky``, ``block_cholesky_solve``): 14
    iterations stop 2.8e-4 of |x| short of the exact step (CPU), so each
    side's f32 rounding shows; they agree within 1e-5 of |x|."""
    x = [banded.pcg_chol_solve(*_stiff_band(dev)).cpu() for dev in (cuda, "cpu")]
    assert (x[0] - x[1]).abs().max() <= 1e-5 * x[1].abs().max()


@pytest.mark.parametrize("case", sorted(KNN_PAIR_CASES))
def test_knn_pairs_kernel_equals_plain_version(cuda, case):
    args = [torch.tensor(a, device=cuda) for a in KNN_PAIR_CASES[case](np.random.default_rng(0))]
    before = _launches("knn_pairs")
    d_k, i_k = knn_mod.knn_pairs(*args)
    d_r, i_r = knn_mod.knn_pairs_reference(*args)
    torch.cuda.synchronize()
    assert _launches("knn_pairs") == before + 1
    assert torch.equal(i_k, i_r)
    assert torch.equal(d_k, d_r)


def test_knn_pairs_launches_on_the_current_stream(cuda):
    src = [torch.tensor(a, device=cuda)
           for a in KNN_PAIR_CASES["pairs_256x1024"](np.random.default_rng(0))]
    d_r, i_r = knn_mod.knn_pairs_reference(*src)
    args = [torch.zeros_like(a) for a in src]
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        for a, s in zip(args, src):
            a.copy_(s)
        d_k, i_k = knn_mod.knn_pairs(*args)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_r) and torch.equal(d_k, d_r)


@pytest.mark.parametrize("case", sorted(IMU_PREINT_CASES))
def test_imu_preint_kernel_matches_loop(cuda, case):
    """The kernel against the loop run on the same card tensors, every field
    within the 1e-10 that tests/test_torch_imu.py holds the loop to against
    JAX (the same f64 recurrence, sums taken in another order)."""
    args = [torch.tensor(a, device=cuda)
            for a in IMU_PREINT_CASES[case](np.random.default_rng(0))]
    before = _launches("imu_preint")
    tally = profiling.tallies().get("imu.preintegrate.kernel", 0)
    got = timu.preintegrate(*args)
    ref = timu.preintegrate_reference(*args)
    torch.cuda.synchronize()
    assert _launches("imu_preint") == before + 1
    assert profiling.tallies()["imu.preintegrate.kernel"] == tally + 1
    for name, g, r in zip(timu.Preintegrated._fields, got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype and g.is_cuda, name
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-10, msg=lambda m: f"{name}: {m}")


def test_imu_preint_launches_on_the_current_stream(cuda):
    src = [torch.tensor(a, device=cuda)
           for a in IMU_PREINT_CASES["window_4x40"](np.random.default_rng(1))]
    ref = timu.preintegrate_reference(*src)
    args = [torch.zeros_like(a) for a in src]
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        for a, s in zip(args, src):
            a.copy_(s)
        got = timu.preintegrate(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-10)


def test_imu_preint_kernel_refuses_other_shapes(cuda):
    args = [torch.tensor(a, device=cuda)
            for a in IMU_PREINT_CASES["window_4x40"](np.random.default_rng(2))]
    with pytest.raises(ValueError):
        imu_preint.preintegrate(*args[:-1], args[-1][:15, :15])
    with pytest.raises(ValueError):
        imu_preint.preintegrate(args[0], args[1], args[2][:, :39], *args[3:])
    with pytest.raises(TypeError):
        imu_preint.preintegrate(*args[:3], args[3].to(torch.uint8), *args[4:])


def _level1_scenario(T, seed=4):
    cfg = GlioConfig()
    cfg = cfg.replace(estimator=dataclasses.replace(cfg.estimator, sms_fusion_level=1))
    ep = simulate_episode(n_keyframes=T, scan_points=1024, seed=seed)
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    gnss = simulate_gnss_epochs(ep.gt_p, ep.kf_time, anchor, station, psr_noise=0.5,
                                epoch_stride=3, seed=seed)
    p_odo = random_walk_odometry(ep.gt_p, seed)
    return cfg, ep, gnss, p_odo, anchor, station


def test_build_sms1_on_card_equals_cpu(cuda):
    """The kNN is bit for bit the plain version, and the plane fits sum in a
    fixed order and solve their eigensystems by elementwise Jacobi
    rotations: the card's association is the CPU's, bit for bit."""
    cfg, ep, _, p_odo, _, _ = _level1_scenario(40)
    g, c = (batch.build_sms1(cfg, ep.scan, ep.scan_valid, p_odo, ep.gt_q, device=dev)
            for dev in (cuda, "cpu"))
    assert int(c.mask.sum()) > 1000
    for f in batch.Sms1Data._fields:
        assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), f


def test_level1_solve_on_card_is_deterministic_and_matches_cpu(cuda):
    """T = 300, the card's association handed to both devices: two solves
    on the card agree bit for bit, the card and the CPU to 3e-4 m and their
    costs to 5e-7 relative, the level-0 test's bounds."""
    cfg, ep, gnss, p_odo, anchor, station = _level1_scenario(300)
    sms = batch.build_sms1(cfg, ep.scan, ep.scan_valid, p_odo, ep.gt_q, device=cuda)
    outs = []
    for dev in (cuda, cuda, "cpu"):
        prob = batch.build_problem(cfg, p_odo, ep.gt_q, ep.kf_time, gnss, anchor, 0.0, station,
                                   device=dev)
        chain = batch.build_imu_chain(cfg, ep.imu_acc, ep.imu_gyr, ep.imu_dt, ep.imu_valid,
                                      device=dev)
        sms_d = batch.Sms1Data(*(a.to(dev) for a in sms))
        outs.append(batch.optimize_batch_sms1_imu(cfg, prob, sms_d, chain))
    (g1, g2, c) = outs
    assert all(torch.equal(a, b) for a, b in zip(g1[:5], g2[:5])) and g1[5] == g2[5]
    assert all(bool(torch.isfinite(a).all()) for a in g1[:5])
    np.testing.assert_allclose(g1[0].cpu().numpy(), c[0].numpy(), rtol=0, atol=3e-4)
    np.testing.assert_allclose(g1[5], c[5], rtol=5e-7)


def test_stage3_on_card_is_deterministic_and_matches_cpu(cuda):
    """300 keyframes of the batch drive with GNSS every third: the DD fixes
    on the card equal the CPU's to 1e-7 m (the T = 3493 gate is 5.2e-7 m,
    10x JAX's own spread) with the same ok masks, and two LC solves on the
    card agree bit for bit and with the CPU's to 1e-7 m: the chain follows
    its fixes about one to one."""
    from glio_tpu_torch import pipeline
    from glio_tpu_torch.models import lc_fusion
    cfg = GlioConfig()
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    kf_time, p_true, q_true, p_odo = drifted_trajectory(300)
    gnss = simulate_gnss_epochs(p_true, kf_time, anchor, station, psr_noise=0.5, seed=4)
    outs = {}
    for dev in ("cpu", cuda):
        fix, _, ok, _ = pipeline._dd_fixes(cfg, gnss, anchor, station, dev)
        gp, gv, gs = pipeline.lc_fixes(cfg, gnss, kf_time, anchor, 0.0, station, dev)
        prob = lc_fusion.build_problem(p_odo, q_true, gp, gv, gs, device=dev)
        p0, q0 = (torch.as_tensor(a, device=dev) for a in (p_odo, q_true))
        outs[str(dev)] = (fix, ok, lc_fusion.solve(prob, p0, q0), lc_fusion.solve(prob, p0, q0))
    c, g = outs["cpu"], outs[str(cuda)]
    assert torch.equal(c[1], g[1].cpu()) and bool(c[1].all())
    np.testing.assert_allclose(g[0].cpu().numpy(), c[0].numpy(), rtol=0, atol=1e-7)
    assert all(torch.equal(a, b) for a, b in zip(g[2], g[3]))
    np.testing.assert_allclose(g[2][0].cpu().numpy(), c[2][0].numpy(), rtol=0, atol=1e-7)


def test_backend_fusion_on_card_matches_cpu(cuda):
    """A short divergence run (24 keyframes of 256 points, lidar blinded on
    12-19, GNSS every keyframe, a fusion every 8 over 16): the kNN launches
    once per keyframe on the card, the reset decisions are the CPU's (one
    re-anchor from direct fixes at keyframe 24), and the trajectory matches
    the CPU's to 1e-2 m: 10x the CPU's own spread under a +-1e-9 m nudge of
    p0 (8.9e-4 m; the reset re-seeds the window from fixes)."""
    import contextlib
    import io

    from glio_tpu_torch import pipeline
    from glio_tpu_torch.testing import reset_decisions
    cfg = GlioConfig().replace(
        shapes=ShapeConfig(max_imu_per_interval=40, scan_points=256, map_points=2048),
        estimator=EstimatorConfig(local_map_width=8, sw_max_iter=4))
    ep = simulate_episode(n_keyframes=24, scan_points=256, seed=21)
    ep.imu_acc[12:16] += np.array([1.5, 0.0, 0.0])
    ep.scan_valid[12:20] = False
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    ep.gnss = simulate_gnss_epochs(ep.gt_p, ep.kf_time, anchor, station, psr_noise=0.5,
                                   epoch_stride=1, seed=21)
    outs = {}
    for dev in ("cpu", cuda):
        before = _launches("knn")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            p, q = pipeline.replay_with_backend_fusion(
                cfg, ep, ep.to_inputs(dev), anchor, 0.0, station, every=8, fusion_span=16,
                debug=True)
        outs[str(dev)] = (p, q, reset_decisions(buf.getvalue().splitlines()))
        launched = _launches("knn") - before
    assert launched == 24
    (pc, _, dc), (pg, qg, dg) = outs["cpu"], outs[str(cuda)]
    assert dg == dc == [(24, "direct RTK fix")]
    assert np.isfinite(pg).all() and np.isfinite(qg).all()
    np.testing.assert_allclose(pg, pc, rtol=0, atol=1e-2)


def _raw_frames(n, seed=3):
    """``n`` 16 x 360 raycast frames of a 10 Hz drive (the port's simulator)."""
    from glio_tpu_torch.data.simulator import PlaneWorld, _quat_rotmat, raycast_scan
    ep = simulate_episode(n_keyframes=n, kf_dt=0.1, scan_points=256, seed=seed,
                          scan_noise=0.01, q_lb=(1, 0, 0, 0), t_lb=(0, 0, 0))
    world = PlaneWorld(extent=max(200.0, np.abs(ep.gt_p).max() + 80.0), seed=seed)
    frames = [raycast_scan(world, ep.gt_p[k], _quat_rotmat(ep.gt_q[k]), n_rings=16, n_cols=360,
                           rng=np.random.default_rng(100 + k)) for k in range(n)]
    return ep, frames


def test_features_on_card_equal_cpu(cuda):
    """LOAM curvature, masks and the feature clouds on the card, bit for bit
    the CPU's (the curvature adds in a fixed order on both)."""
    from glio_tpu_torch.lidar import features
    from glio_tpu_torch.models.preprocessing import make_preprocessor
    _, frames = _raw_frames(2)
    for img, iv in frames:
        out_c = features.extract_features(torch.tensor(img), torch.tensor(iv))
        out_g = features.extract_features(torch.tensor(img, device=cuda),
                                          torch.tensor(iv, device=cuda))
        for k in out_c:
            assert torch.equal(out_g[k].cpu(), out_c[k]), k
        fc = make_preprocessor(GlioConfig(), "cpu", surf_out=512)(img, iv)
        fg = make_preprocessor(GlioConfig(), cuda, surf_out=512)(img, iv)
        for f in fc._fields:
            assert torch.equal(getattr(fg, f).cpu(), getattr(fc, f)), f
        assert fg.surf.device.type == "cuda" and fc.surf_valid.sum() > 100


def test_odometry_on_card_matches_cpu(cuda):
    """A 4-frame odometry run on the card against the CPU: the kNN twice a
    frame, the keyframe flags equal, the poses within 10x the CPU run's own
    spread under a +-1e-5 m nudge of p0 (the plane fits' f32 sums add in
    another order on the card, a change at the f32 resolution of the map
    that the ICP carries on, as a nudge there does)."""
    from glio_tpu_torch.models.lidar_odometry import make_odometry
    from glio_tpu_torch.models.preprocessing import make_preprocessor
    cfg = GlioConfig().replace(shapes=ShapeConfig(scan_points=512, map_points=2048))
    ep, frames = _raw_frames(4)
    pre = make_preprocessor(cfg, "cpu", surf_out=512)
    feats = [pre(img, iv) for img, iv in frames]
    scans = torch.stack([f.surf for f in feats])
    valid = torch.stack([f.surf_valid for f in feats])
    before = _launches("knn")
    out_g = make_odometry(cfg, cuda)(scans.to(cuda), valid.to(cuda), ep.gt_p[0], ep.gt_q[0])
    torch.cuda.synchronize()
    assert _launches("knn") - before == 8
    odo_c = make_odometry(cfg, "cpu")
    out_c = odo_c(scans, valid, ep.gt_p[0], ep.gt_q[0])
    spread = max(float((odo_c(scans, valid, ep.gt_p[0] + s * 1e-5, ep.gt_q[0]).p - out_c.p)
                       .abs().max()) for s in (1, -1))
    assert torch.equal(out_g.is_keyframe.cpu(), out_c.is_keyframe)
    assert float((out_g.p.cpu() - out_c.p).abs().max()) <= 10 * spread
    assert int(out_c.n_matches[-1]) > 300


def test_spp_on_card_matches_cpu(cuda, tmp_path):
    """SPP, Doppler velocity and DOP of the synthetic RINEX's epochs (the
    port's writer and converter) in one call on the card against the CPU:
    ok masks equal, fixes within 1e-6 m (f64 sums in another order)."""
    from glio_tpu_torch import testing
    from glio_tpu_torch.gnss import converter, spp, tools
    sc = dict(testing.GNSS_DRIVE, n_keyframes=180)
    _, _, _, _, t_gps, rover = testing.gnss_drive(sc)
    obs, nav = str(tmp_path / "d.obs"), str(tmp_path / "d.nav")
    testing.write_synthetic_rinex(obs, nav, t_gps, rover, seed=sc["seed"])
    station = np.asarray(GlioConfig().initialization.station_ecef)
    g = converter.convert(obs, nav, station)
    outs = {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
        x, clk, ok, _ = spp.solve_epochs(t(g.sat_pos), t(g.psr_rov_corr),
                                         t(g.system.astype(np.int32)), t(g.valid),
                                         t(g.elevation), t(g.snr), t(station))
        v, ddt = spp.doppler_velocity(t(g.sat_pos), t(g.sat_vel), t(g.dopp_rov),
                                      t(g.system), t(g.valid), t(g.elevation), t(g.snr), x)
        gdop = tools.dop(x, t(g.sat_pos), t(g.valid))[0]
        outs[str(dev)] = [a.cpu().numpy() for a in (x, clk, ok, v, ddt, gdop)]
    (xc, cc, okc, vc, dc, gc), (xg, cg, okg, vg, dg, gg) = outs["cpu"], outs[str(cuda)]
    assert np.array_equal(okg, okc) and okc.all()
    np.testing.assert_allclose(xg, xc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(cg, cc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(vg, vc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gg, gc, rtol=1e-9)


def test_gnss_window_step_on_card_matches_cpu(cuda):
    """One GNSS-window replay (DD and Doppler rows, the clock-drift state)
    on the card against the CPU: n_lidar_factors equal, positions within
    1e-6 m and the drift within 1e-6 m/s."""
    cfg = GlioConfig().replace(
        shapes=ShapeConfig(max_imu_per_interval=40, scan_points=256, map_points=2048),
        estimator=EstimatorConfig(local_map_width=8, sw_max_iter=4, gnss_in_sliding_window=True,
                                  doppler_in_window=True))
    ep = simulate_episode(n_keyframes=6, scan_points=256, seed=1)
    ep.gnss = simulate_gnss_epochs(ep.gt_p, ep.kf_time, np.asarray(cfg.initialization.anc_ecef),
                                   np.asarray(cfg.initialization.station_ecef), psr_noise=0.3,
                                   epoch_stride=1, seed=1)
    outs = {}
    for dev in ("cpu", cuda):
        before = _launches("knn")
        est = SlidingWindowEstimator(cfg, dev)
        outs[str(dev)] = est(ep.to_inputs(dev), ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0)
        launched = _launches("knn") - before
    assert launched == 6
    oc, og = outs["cpu"], outs[str(cuda)]
    assert torch.equal(og.n_lidar_factors.cpu(), oc.n_lidar_factors)
    np.testing.assert_allclose(og.p.cpu().numpy(), oc.p.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(og.ddt.cpu().numpy(), oc.ddt.numpy(), rtol=0, atol=1e-6)
    assert (oc.ddt[1:] != 0).all()
