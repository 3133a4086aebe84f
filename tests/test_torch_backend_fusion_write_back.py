"""Backend fusion's write-back (``pipeline.replay_with_backend_fusion``), as
in the JAX package.

The reference quirk is copied, not fixed: the write-back of the fused
poses reaches ``map_p`` / ``map_q`` only, and the step associates against
the cached ``map_world`` clouds.
"""

import numpy as np
import torch

from glio_tpu_torch import pipeline
from glio_tpu_torch.data.simulator import simulate_episode, simulate_gnss_epochs
from glio_tpu_torch.models.sliding_window import index_inputs
from test_torch_backend_fusion import _cfg


def test_map_write_back_reaches_map_p_q_only(monkeypatch):
    """The fused poses land in ``map_p`` / ``map_q`` of the frames that left
    the window, ``map_world`` is untouched, and a step does not read
    ``map_p`` / ``map_q``: as in the JAX package."""
    cfg = _cfg(1e9, 1e9)
    ep = simulate_episode(n_keyframes=20, scan_points=256, seed=21)
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    ep.gnss = simulate_gnss_epochs(ep.gt_p, ep.kf_time, anchor, station, psr_noise=0.5,
                                   epoch_stride=1, seed=21)
    seen = []
    make = pipeline.make_replay

    def recording(cfg_, device):
        est = make(cfg_, device)
        replay_from = est.replay_from

        def record(carry, inputs):
            out = replay_from(carry, inputs)
            seen.append((carry, out[0]))
            return out
        est.replay_from = record
        seen.append(est)
        return est

    monkeypatch.setattr(pipeline, "make_replay", recording)
    pipeline.replay_with_backend_fusion(cfg, ep, ep.to_inputs("cpu"), anchor, 0.0, station,
                                        every=8, fusion_span=16)
    est, (c0_in, c0_out), (c1_in, c1_out), (c2_in, _) = seen
    K, M = cfg.estimator.slide_window_width, cfg.estimator.local_map_width
    # The fusion after 16 keyframes corrected frames 16 − M .. 16 − K − 1.
    b_out, b_in = c1_out.base, c2_in.base
    assert torch.equal(b_in.map_world, b_out.map_world)
    moved = [i % M for i in range(16 - M, 16 - K)]
    assert not torch.equal(b_in.map_p[moved], b_out.map_p[moved])
    kept = [s for s in range(M) if s not in moved]
    assert torch.equal(b_in.map_p[kept], b_out.map_p[kept])
    # A step from either carry gives the same keyframe.
    inp = index_inputs(ep.to_inputs("cpu"), 16)
    _, o1 = est.step(c2_in, inp)
    _, o2 = est.step(c2_in._replace(base=c2_in.base._replace(map_p=b_out.map_p,
                                                            map_q=b_out.map_q)), inp)
    assert torch.equal(o1.p, o2.p) and torch.equal(o1.q, o2.q)
