"""Port parity: IMU preintegration, whitening and the whitened IMU residual.

Inputs are the simulator's IMU runs (with bias and noise) and random window
states, made with numpy. The port batches the window's edges in one call;
JAX is called per edge. Tolerances:
* 1e-10 against JAX ``preintegrate(cov_dtype=float64)``: the same f64
  recurrence over 37 samples, with a few sums taken in another order;
* rtol 1e-5 on the covariance against the f32 associative-scan fast path
  that JAX's replay uses: that path propagates the covariance in f32, whose
  rounding scales with the largest terms summed, so entries that cancel
  get an absolute floor of 1e-5 of the largest entry;
* 1e-9 on the whitened residual, whose whitening entries reach 1e3.

On the CPU ``preintegrate`` runs the loop, ``preintegrate_reference``; the
CUDA kernel that takes its place on the card copies the loop's handling of
invalid samples, held here bit for bit, and is held to the loop in
``tests/test_torch_cuda.py``. The benchmark's ``window.preint_kernel_share``
reads the tallies each call leaves.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.data.simulator import simulate_episode
from glio_tpu.factors import imu as jimu
from glio_tpu_torch import testing
from glio_tpu_torch.factors import imu as timu
from glio_tpu_torch.utils import profiling
from port_bench.harness import cells

PARAMS = jimu.ImuParams()
FIELDS = ("delta_p", "delta_q", "delta_v", "jacobian", "covariance", "sum_dt")


@pytest.fixture(scope="module")
def runs():
    """Three edges: two full IMU runs and one cut short (padded tail)."""
    ep = simulate_episode(n_keyframes=4, scan_points=16, seed=2)
    rng = np.random.default_rng(0)
    acc, gyr = ep.imu_acc[1:].copy(), ep.imu_gyr[1:].copy()
    dt, valid = ep.imu_dt[1:].copy(), ep.imu_valid[1:].copy()
    valid[2, 20:] = False
    ba = rng.normal(size=(3, 3)) * 0.02
    bg = rng.normal(size=(3, 3)) * 0.002
    seed = np.stack([ep.acc0, ep.imu_acc[1, 32], ep.imu_acc[2, 32]])
    gseed = np.stack([ep.gyr0, ep.imu_gyr[1, 32], ep.imu_gyr[2, 32]])
    return dict(acc=acc, gyr=gyr, dt=dt, valid=valid, ba=ba, bg=bg,
                acc0=seed, gyr0=gseed)


def _port(r):
    t = {k: torch.tensor(v) for k, v in r.items()}
    return timu.preintegrate(t["acc"], t["gyr"], t["dt"], t["valid"], t["ba"],
                             t["bg"], t["acc0"], t["gyr0"],
                             timu.ImuParams().noise_cov())


def _jax(r, e, cov_dtype):
    j = {k: jnp.asarray(v[e]) for k, v in r.items()}
    return jimu.preintegrate(j["acc"], j["gyr"], j["dt"], j["valid"], j["ba"],
                             j["bg"], j["acc0"], j["gyr0"], params=PARAMS,
                             cov_dtype=cov_dtype)


@pytest.mark.parametrize("field", FIELDS)
def test_preintegrate_matches_f64(runs, field):
    pt = _port(runs)
    for e in range(3):
        pj = _jax(runs, e, jnp.float64)
        np.testing.assert_allclose(getattr(pt, field)[e].numpy(),
                                   np.asarray(getattr(pj, field)),
                                   rtol=1e-10, atol=1e-10)


def test_preintegrate_matches_f32_fast_path(runs):
    pt = _port(runs)
    for e in range(3):
        pj = _jax(runs, e, jnp.float32)
        cj = np.asarray(pj.covariance)
        np.testing.assert_allclose(pt.covariance[e].numpy(), cj, rtol=1e-5,
                                   atol=1e-5 * np.abs(cj).max())
        np.testing.assert_allclose(pt.delta_p[e].numpy(), np.asarray(pj.delta_p),
                                   rtol=1e-10, atol=1e-10)


def _window(rng):
    q = rng.normal(size=(4, 4)) * 0.05
    q[:, 0] = 1.0
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return [rng.normal(size=(4, 3)) * 5, q, rng.normal(size=(4, 3)),
            rng.normal(size=(4, 3)) * 0.02, rng.normal(size=(4, 3)) * 0.002]


def test_sqrt_info_and_whitened_residual(runs):
    pt = _port(runs)
    St = timu.sqrt_info(pt)
    p, q, v, ba, bg = _window(np.random.default_rng(1))
    gravity = PARAMS.gravity_vec()
    rt = timu.whitened_residual_cached(
        St, pt, *(torch.tensor(a[:-1]) for a in (p, q, v, ba, bg)),
        *(torch.tensor(a[1:]) for a in (p, q, v, ba, bg)),
        gravity=torch.tensor(np.asarray(gravity)))
    for e in range(3):
        pj = _jax(runs, e, jnp.float64)
        Sj = jimu.sqrt_info(pj)
        np.testing.assert_allclose(St[e].numpy(), np.asarray(Sj), rtol=1e-10)
        rj = jimu.whitened_residual_cached(
            Sj, pj, *(jnp.asarray(a[e]) for a in (p, q, v, ba, bg)),
            *(jnp.asarray(a[e + 1]) for a in (p, q, v, ba, bg)), gravity=gravity)
        np.testing.assert_allclose(rt[e].numpy(), np.asarray(rj), rtol=1e-9, atol=1e-9)


def _compacted_and_scattered(seed):
    """One batch of four edges twice: compacted (each edge's valid samples
    first, in order, then invalid padding) and with the same valid samples
    scattered, in order, among invalid slots of finite garbage; one edge has
    no valid sample."""
    rng = np.random.default_rng(seed)
    acc, gyr, dt, _, ba, bg, acc0, gyr0, noise = testing.imu_runs(rng, (4,), n=40)
    counts = [40, 23, 7, 0]
    n_wide = 64
    c_valid = np.arange(40)[None, :] < np.array(counts)[:, None]
    s_acc = rng.normal(size=(4, n_wide, 3)) * 1e3
    s_gyr = rng.normal(size=(4, n_wide, 3)) * 1e2
    s_dt = rng.uniform(1.0, 10.0, size=(4, n_wide))
    s_valid = np.zeros((4, n_wide), bool)
    for e, c in enumerate(counts):
        slots = np.sort(rng.choice(n_wide, size=c, replace=False))
        s_acc[e, slots], s_gyr[e, slots], s_dt[e, slots] = acc[e, :c], gyr[e, :c], dt[e, :c]
        s_valid[e, slots] = True
    rest = (ba, bg, acc0, gyr0, noise)
    return ((acc, gyr, dt, c_valid, *rest), (s_acc, s_gyr, s_dt, s_valid, *rest))


@pytest.mark.parametrize("seed", [0, 1])
def test_invalid_samples_are_skipped_bit_for_bit(seed):
    """The contract the kernel copies: an invalid sample, whatever finite
    values it holds, leaves every state as it was (a_prev and g_prev too)."""
    compact, scattered = _compacted_and_scattered(seed)
    a = timu.preintegrate(*(torch.tensor(x) for x in compact))
    b = timu.preintegrate(*(torch.tensor(x) for x in scattered))
    for field, x, y in zip(timu.Preintegrated._fields, a, b):
        assert torch.equal(x, y), field
    assert torch.equal(a.jacobian[3], torch.eye(15, dtype=torch.float64))
    assert torch.equal(a.covariance[3], 1e-3 * torch.eye(15, dtype=torch.float64))


def test_cpu_call_runs_the_loop():
    args = [torch.tensor(a) for a in testing.imu_runs(np.random.default_rng(3), (2,))]
    before = profiling.tallies()
    got = timu.preintegrate(*args)
    after = profiling.tallies()
    assert after["imu.preintegrate.loop"] == before.get("imu.preintegrate.loop", 0) + 1
    assert after.get("imu.preintegrate.kernel", 0) == before.get("imu.preintegrate.kernel", 0)
    for x, y in zip(got, timu.preintegrate_reference(*args)):
        assert torch.equal(x, y)


def _share():
    return cells.load_reader("window.preint_kernel_share").read(
        types.SimpleNamespace(trace=None, units=2, driver=None))


def test_kernel_share_none_without_tallies(monkeypatch):
    monkeypatch.setattr(profiling, "tallies", dict)
    assert _share() is None
    monkeypatch.delattr(profiling, "tallies")
    assert _share() is None


def test_kernel_share_zero_after_a_cpu_call():
    timu.preintegrate(*(torch.tensor(a) for a in testing.imu_runs(np.random.default_rng(4), ())))
    assert _share() == 0.0


@pytest.mark.parametrize("counts, share", [
    ({"imu.preintegrate.kernel": 51}, 100.0),
    ({"imu.preintegrate.kernel": 3, "imu.preintegrate.loop": 1, "window.lm.replays": 9}, 75.0),
    ({"window.lm.replays": 9}, None),
])
def test_kernel_share_of_calls(monkeypatch, counts, share):
    monkeypatch.setattr(profiling, "tallies", lambda: dict(counts))
    assert _share() == share
