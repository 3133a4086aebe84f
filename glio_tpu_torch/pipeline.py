"""End-to-end pipeline (port of ``glio_tpu/pipeline.py``).

One call runs

  episode → sliding-window fusion        → tc_sw_result.csv
          → batch fusion (GNSS DD)       → tc_batch_result.csv, tc_batch_cov.csv
          → RTK DD fixes + LC fusion     → lc_result.csv

on one device, with the reference's CSV rows
(``t, week, tow, lat, lon, alt, yaw, pitch, roll, E, N, U``):

    res = run_pipeline(ep, cfg, out_dir="out")                  # on cuda:0
    res = run_pipeline(ep, cfg, backend_fusion_every=10)        # long drives

Stage 1 is one of two drivers: the window replayed in ``sw_chunk`` pieces
through ``replay_from``, or, with ``backend_fusion_every > 0`` and GNSS,
``replay_with_backend_fusion``, which interleaves batch solves over the
trailing keyframes and resets a diverged window. ``_finish_pipeline`` then
applies loop closure (``loop_closure_on``), refines the dense frames when the
episode carries them (``dense_path.csv``), exports the map (``save_pcd``),
runs stage 2 at ``sms_fusion_level`` 0 or 1 and stage 3. Both stage-1
paths hand the window the GNSS epochs bound to its keyframes
(``Episode.to_inputs``), which it reads with ``gnss_in_sliding_window``.
``lc_stage_float_ar`` is stage 3's carrier-phase variant (the float filter,
integer ambiguity resolution, the float/AR fixes into the LC solve), which,
as in the JAX package, no ``run_pipeline`` option selects.
"""

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .config import GlioConfig
from .data.episode import Episode
from .eval import trajectory as traj
from .gnss import rtk
from .models import batch as batch_mod
from .models import lc_fusion
from .models.sliding_window import index_inputs, make_replay
from .utils import coords as C
from .utils import quat


@dataclass
class PipelineResult:
    kf_time: np.ndarray
    p_sw: np.ndarray
    q_sw: np.ndarray
    p_batch: Optional[np.ndarray] = None
    q_batch: Optional[np.ndarray] = None
    cov_batch: Optional[np.ndarray] = None      # (T, 6, 6) formal marginals
    cov_batch_cal: Optional[np.ndarray] = None  # (T, 6, 6) calibrated
    p_lc: Optional[np.ndarray] = None
    q_lc: Optional[np.ndarray] = None
    n_loop_edges: int = 0
    p_dense: Optional[np.ndarray] = None        # (T-1, D, 3)
    q_dense: Optional[np.ndarray] = None        # (T-1, D, 4)
    dense_valid: Optional[np.ndarray] = None    # (T-1, D)
    # Port only: lidar factors per keyframe in stage 1 (chunked replay).
    n_lidar_factors: Optional[np.ndarray] = None


def _georef(p_local, q_local, anchor_ecef, yaw_enu_local, device):
    """Local → (llh, ypr in degrees, enu) for CSV output, computed on
    ``device``. With yaw 0 the local frame is ENU."""
    def t(a):
        return torch.as_tensor(np.asarray(a, float), dtype=torch.float64, device=device)
    sy, cy = np.sin(yaw_enu_local), np.cos(yaw_enu_local)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    enu = p_local @ Rz.T
    llh = C.ecef2llh(C.enu2ecef(t(enu), t(anchor_ecef))).cpu().numpy()
    ypr = np.rad2deg(quat.to_ypr(t(q_local)).cpu().numpy())
    return llh, ypr, enu


def _local_from_ecef(ecef, anchor_ecef, yaw_enu_local, device):
    """ECEF positions (..., 3), numpy or a tensor, → the local frame (ENU
    rotated by −yaw), numpy."""
    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)
    enu = C.ecef2enu(t(ecef), t(anchor_ecef)).cpu().numpy()
    sy, cy = np.sin(yaw_enu_local), np.cos(yaw_enu_local)
    return enu @ np.array([[cy, sy, 0], [-sy, cy, 0], [0, 0, 1.0]]).T


def _dd_fixes(cfg, g, anchor, station, device, sel=slice(None)):
    """RTK DD fixes of the GNSS epochs ``sel`` on ``device``: (pos_ecef,
    cov, ok, n_dd) tensors, with the configured robust options."""
    def f(a):
        return torch.as_tensor(np.asarray(a, float), dtype=torch.float64, device=device)

    def i(a):
        return torch.as_tensor(np.asarray(a[sel]), device=device)

    return rtk.solve_epochs_dd(f(g.sat_pos[sel]), f(g.psr_rov[sel]), f(g.psr_sta[sel]),
                               i(g.valid).bool(), i(g.system).long(), i(g.master).long(),
                               f(station), f(g.elevation[sel]), f(g.snr[sel]), f(anchor),
                               huber=cfg.estimator.rtk_fix_huber,
                               trim=cfg.estimator.rtk_fix_trim)


def _slice_epochs_fixed(g, t0, t1, n_out):
    """Fixed-shape epoch window: the epochs with time in [t0, t1], padded
    with invalid entries (a time before every keyframe, so
    ``batch.build_problem`` binds none of them)."""
    time = np.asarray(g.time)
    idx = np.nonzero((time >= t0) & (time <= t1))[0][:n_out]

    class _G:
        pass

    out = _G()
    for f in ("sat_pos", "psr_rov", "psr_sta", "valid", "system", "master", "elevation",
              "snr", "sat_vel", "sat_ddt", "dopp_rov"):
        a = np.asarray(getattr(g, f))
        pad = np.zeros((n_out,) + a.shape[1:], a.dtype)
        pad[:len(idx)] = a[idx]
        setattr(out, f, pad)
    t = np.full(n_out, -1e18)
    t[:len(idx)] = time[idx]
    out.time = t
    return out


def _fusion_window(cfg, ep, p_hist, q_hist, s0, t, fusion_span, kf_dt, anchor, yaw, station,
                   device):
    """Batch-solve keyframes s0..t-1 against their GNSS epochs, padded to
    ``fusion_span`` keyframes by repeating the last pose; returns the
    corrected (p, q) of the real keyframes, numpy."""
    kf_time = np.asarray(ep.kf_time)
    n = t - s0
    pw = np.zeros((fusion_span, 3))
    qw = np.zeros((fusion_span, 4))
    qw[:, 0] = 1.0
    tw = np.zeros(fusion_span)
    pw[:n] = p_hist[s0:t]
    qw[:n] = q_hist[s0:t]
    tw[:n] = kf_time[s0:t]
    if n < fusion_span:
        # Relatives stay consistent; no epoch binds past the real segment.
        pw[n:] = pw[n - 1]
        qw[n:] = qw[n - 1]
        tw[n:] = tw[n - 1] + kf_dt * np.arange(1, fusion_span - n + 1)
    gsub = _slice_epochs_fixed(ep.gnss, tw[0], kf_time[t - 1], fusion_span)
    prob = batch_mod.build_problem(cfg, pw, qw, tw, gsub, anchor, yaw, station, device=device)
    # Robust IRLS, as the production batch: without it a diverged window
    # tail drags the whole fused chain toward the divergence.
    pc, qc, _ = batch_mod.optimize_batch(
        cfg, prob, solver=cfg.estimator.batch_solver,
        robust=batch_mod.RobustOpts(dd_huber=1.0, epoch_gate=2.0, rel_huber=5.0))
    return pc[:n].cpu().numpy(), qc[:n].cpu().numpy()


def replay_with_backend_fusion(cfg: GlioConfig, ep: Episode, inputs, anchor, yaw, station,
                               every: int = 40, fusion_span: int = 160, debug: bool = False):
    """Sliding window interleaved with online batch correction
    (``backendFusionThread``, Estimator.cpp:5352 and :2739-2748), on the
    device of ``inputs`` (``ep.to_inputs(device)``).

    Every ``every`` keyframes: batch-solve the trailing ``fusion_span``
    keyframes against the GNSS DD factors, write the corrected poses into
    ``p_hist`` and into the map ring's ``map_p`` / ``map_q`` for frames that
    have left the window, and reset the window when it has walked away from
    the fused estimate (``reset_drift_threshold``) or the fused tail
    disagrees with an independent RTK DD fix (``reset_fix_disagree``): snap
    to a plausible fused tail, or else re-anchor from direct fixes with
    biases zeroed, the prior dropped and the map slots wiped. A final
    ordered pass of overlapping windows re-corrects the early segments.
    ``debug`` prints the JAX package's ``[fusion t=…]`` lines.

    As in the JAX package, the write-back reaches ``map_p`` / ``map_q``
    only; the step associates against the cached ``map_world`` clouds, so
    only a reset acts on the association. Returns (p, q) numpy (T, 3/4).
    """
    est = cfg.estimator
    K = est.slide_window_width
    M = est.local_map_width
    device = inputs.scan.device
    replay = make_replay(cfg, device)
    kf_time = np.asarray(ep.kf_time)
    T = kf_time.shape[0]
    kf_dt = float(np.median(np.diff(kf_time))) if T > 1 else 0.33
    carry = replay.make_initial_carry(ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0,
                                      n_imu=inputs.imu_acc.shape[-2],
                                      max_sv=inputs.gnss.sv_valid.shape[-1])
    g = ep.gnss
    drift_thr = est.reset_drift_threshold
    fix_gate = est.reset_fix_disagree
    vmax = est.reset_max_speed

    def dd_fix_at(t_query):
        """The DD fix at the epoch before t_query, in the local frame; None
        when there is no such epoch or it does not solve."""
        ei = int(np.searchsorted(np.asarray(g.time), t_query)) - 1
        if ei < 0:
            return None
        fx, _, ok, _ = _dd_fixes(cfg, g, anchor, station, device, slice(ei, ei + 1))
        if not bool(ok[0]):
            return None
        return _local_from_ecef(fx[0], anchor, yaw, device)

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    p_hist = np.zeros((0, 3))
    q_hist = np.zeros((0, 4))
    for s in range(0, T, every):
        part = index_inputs(inputs, slice(s, s + every))
        carry, out = replay.replay_from(carry, part)
        p_hist = np.concatenate([p_hist, out.p.cpu().numpy()])
        q_hist = np.concatenate([q_hist, out.q.cpu().numpy()])
        t = p_hist.shape[0]
        s0 = max(0, t - fusion_span)
        if t - s0 < 3 * K or g is None:
            continue
        p_hist[s0:t], q_hist[s0:t] = _fusion_window(cfg, ep, p_hist, q_hist, s0, t, fusion_span,
                                                    kf_dt, anchor, yaw, station, device)
        # Correct the map ring for frames that already left the window.
        base = carry.base
        rows = list(range(max(s0, t - M), t - K))
        mp, mq = base.map_p.clone(), base.map_q.clone()
        if rows:
            slots = [i % M for i in rows]
            mp[slots] = dev(p_hist[rows])
            mq[slots] = dev(q_hist[rows])
        base = base._replace(map_p=mp, map_q=mq)

        # Divergence signals: (a) window tail against fused tail; (b) fused
        # tail against an independent DD fix, for when the robust batch
        # rejected the diverged tail's epochs and (a) stays silent.
        w = base.window
        p_fix = dd_fix_at(kf_time[t - 1])
        drift = float(np.linalg.norm(w.p[-1].cpu().numpy() - p_hist[t - 1]))
        fix_dis = 0.0 if p_fix is None else float(np.linalg.norm(p_hist[t - 1] - p_fix))
        pk = p_hist[t - K:t]
        qk = q_hist[t - K:t]
        hop = (np.linalg.norm(np.diff(pk, axis=0), axis=-1) / kf_dt
               if pk.shape[0] > 1 else np.zeros(1))
        # Snap only to a plausible fused target.
        target_sane = bool(np.isfinite(pk).all() and hop.max() < vmax and fix_dis <= fix_gate)
        did_reset = False
        if debug:
            print(f"[fusion t={t}] drift={drift:.2f} fix_dis={fix_dis:.2f}"
                  f" hop_max={float(hop.max()):.2f} sane={target_sane}", flush=True)
        prior_off = dict(prior_valid=torch.zeros_like(base.prior_valid),
                         prior_sqrt_jac=torch.zeros_like(base.prior_sqrt_jac),
                         prior_sqrt_res=torch.zeros_like(base.prior_sqrt_res))
        if drift > drift_thr and target_sane:
            did_reset = True
            if debug:
                print(f"[fusion t={t}] RESET → fused tail", flush=True)
            vk = np.clip(np.gradient(pk, kf_dt, axis=0), -vmax, vmax)
            w = w._replace(p=dev(pk), q=dev(qk), v=dev(vk))
            base = base._replace(window=w, **prior_off)
        elif (drift > drift_thr or fix_dis > fix_gate) and p_fix is not None:
            # The fused tail itself is broken: re-anchor from direct fixes,
            # one per window keyframe (the newest where an epoch does not
            # solve), biases from zero, and the local map dropped.
            did_reset = True
            if debug:
                print(f"[fusion t={t}] RESET → direct RTK fix", flush=True)
            pk2 = np.repeat(p_fix[None], K, 0)
            got = np.zeros(K, bool)
            for j in range(K):
                fj = dd_fix_at(kf_time[max(0, t - K + j)])
                if fj is not None:
                    pk2[j], got[j] = fj, True
            vk2 = (np.clip(np.gradient(pk2, kf_dt, axis=0), -vmax, vmax)
                   if got.all() else np.zeros((K, 3)))
            w = w._replace(p=dev(pk2), v=dev(vk2), ba=torch.zeros_like(w.ba),
                           bg=torch.zeros_like(w.bg))
            base = base._replace(window=w, map_slot_valid=torch.zeros_like(base.map_slot_valid),
                                 **prior_off)
            p_hist[t - K:t] = pk2
        if did_reset:
            # Per-slot receiver clock drifts absorbed the wrong velocity
            # during the divergence; they re-estimate from zero.
            carry = carry._replace(ddt=torch.zeros_like(carry.ddt))
        carry = carry._replace(base=base)

    # Final sweep of overlapping fusion windows over the whole trajectory.
    if g is not None and T > fusion_span // 2:
        for s0 in range(0, max(1, T - fusion_span // 2), fusion_span // 2):
            t = min(s0 + fusion_span, T)
            s0 = max(0, t - fusion_span)
            if t - s0 < 3 * K:
                continue
            p_hist[s0:t], q_hist[s0:t] = _fusion_window(
                cfg, ep, p_hist, q_hist, s0, t, fusion_span, kf_dt, anchor, yaw, station, device)
    return p_hist, q_hist


def run_pipeline(ep: Episode, cfg: GlioConfig = GlioConfig(),
                 out_dir: Optional[str] = None,
                 run_batch: Optional[bool] = None,
                 run_lc: Optional[bool] = None,
                 sw_chunk: int = 100,
                 backend_fusion_every: int = 0,
                 device="cuda") -> PipelineResult:
    """Stages 1-3 on ``device``; CSVs into ``out_dir`` when given.
    ``run_batch=None`` runs stage 2 when the episode has GNSS and
    ``enable_batch_fusion`` is on; ``run_lc=None`` runs stage 3 when the
    episode has GNSS."""
    have_gnss = ep.gnss is not None
    if run_batch is None:
        run_batch = have_gnss and cfg.estimator.enable_batch_fusion
    device = torch.device(device)
    anchor = (np.asarray(ep.anchor_ecef) if ep.anchor_ecef is not None
              else np.asarray(cfg.initialization.anc_ecef))
    yaw = float(ep.yaw_enu_local if ep.yaw_enu_local is not None
                else cfg.initialization.yaw_enu_local)
    station = np.asarray(cfg.initialization.station_ecef)

    # --- stage 1: tightly-coupled sliding window.
    inputs = ep.to_inputs(device)
    if backend_fusion_every > 0 and have_gnss:
        p_sw, q_sw = replay_with_backend_fusion(cfg, ep, inputs, anchor, yaw, station,
                                                every=backend_fusion_every)
        nlf = None
    else:
        # In bounded chunks through the checkpoint/resume API (the same
        # result as one replay).
        est = make_replay(cfg, device)
        T = int(np.asarray(ep.kf_time).shape[0])
        carry = est.make_initial_carry(ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0,
                                       n_imu=inputs.imu_acc.shape[-2],
                                       max_sv=inputs.gnss.sv_valid.shape[-1])
        ps, qs, nl = [], [], []
        for s in range(0, T, sw_chunk):
            part = index_inputs(inputs, slice(s, s + sw_chunk))
            carry, out = est.replay_from(carry, part)
            ps.append(out.p)
            qs.append(out.q)
            nl.append(out.n_lidar_factors)
        p_sw = torch.cat(ps).cpu().numpy()
        q_sw = torch.cat(qs).cpu().numpy()
        nlf = torch.cat(nl).cpu().numpy()
    res = _finish_pipeline(ep, cfg, out_dir, run_batch, run_lc, anchor, yaw, station,
                           p_sw, q_sw, device)
    res.n_lidar_factors = nlf
    return res


def apply_loop_closure(cfg: GlioConfig, ep: Episode, p_sw, q_sw, *, device):
    """Detect, ICP-verify and apply loop closures to the keyframe chain
    (``loopClosureThread``, Estimator.cpp:5090-5273, as one pass over the
    finished trajectory) on ``device``. Returns (p, q, n_edges), numpy."""
    from .models import loop_closure as lc_mod

    est = cfg.estimator
    cands = lc_mod.detect_loops(p_sw, np.asarray(ep.kf_time),
                                search_radius=est.lc_search_radius,
                                time_thresh=est.lc_time_thres)
    if not cands:
        return p_sw, q_sw, 0
    w = max(est.lc_map_width // 2, 1)
    T = p_sw.shape[0]

    def f(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    edges = []
    for c in cands:
        j0, j1 = max(c.old - w, 0), min(c.old + w + 1, T)
        p_c, q_c, _, ok = lc_mod.verify_loop(
            cfg, f(ep.scan[c.cur], torch.float32), f(ep.scan_valid[c.cur], torch.bool),
            f(ep.scan[j0:j1], torch.float32), f(ep.scan_valid[j0:j1], torch.bool),
            f(p_sw[j0:j1]), f(q_sw[j0:j1]), f(p_sw[c.cur]), f(q_sw[c.cur]))
        if not bool(ok):
            continue
        qo = f(q_sw[c.old])
        dq = quat.mul(quat.conj(qo), q_c)
        dp = quat.rotate(quat.conj(qo), p_c - f(p_sw[c.old]))
        edges.append((c.old, c.cur, dp.cpu().numpy(), dq.cpu().numpy()))
    if not edges:
        return p_sw, q_sw, 0
    p, q = lc_mod.solve_with_loops(f(p_sw), f(q_sw), edges)
    return p.cpu().numpy(), q.cpu().numpy(), len(edges)


def _finish_pipeline(ep, cfg, out_dir, run_batch, run_lc, anchor, yaw, station,
                     p_sw, q_sw, device) -> PipelineResult:
    """Loop closure, dense frames, the map export and stages 2-3, with CSV
    output: shared by both stage-1 drivers."""
    res = PipelineResult(kf_time=np.asarray(ep.kf_time), p_sw=p_sw, q_sw=q_sw)
    est = cfg.estimator

    # --- loop closure on the keyframe chain, before the global stages.
    if est.loop_closure_on:
        p_sw, q_sw, res.n_loop_edges = apply_loop_closure(cfg, ep, p_sw, q_sw, device=device)
        res.p_sw, res.q_sw = p_sw, q_sw

    # --- dense inter-keyframe interpolation (optimizeLocalGraph,
    # Estimator.cpp:4274-4558), when the episode carries dense frames.
    if ep.dense_rel_dp is not None:
        from .models import local_graph

        def f(a):
            return torch.as_tensor(np.asarray(a, float), dtype=torch.float64, device=device)
        p_d, q_d, d_valid = local_graph.interpolate_segments(
            f(p_sw), f(q_sw), f(ep.dense_rel_dp), f(ep.dense_rel_dq),
            torch.as_tensor(np.asarray(ep.dense_rel_valid, bool), device=device),
            max_dense=int(ep.dense_rel_dp.shape[1]) - 1)
        res.p_dense = p_d.cpu().numpy()
        res.q_dense = q_d.cpu().numpy()
        res.dense_valid = d_valid.cpu().numpy()
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            dv = res.dense_valid.reshape(-1)
            llh, ypr, enu = _georef(res.p_dense.reshape(-1, 3)[dv],
                                    res.q_dense.reshape(-1, 4)[dv], anchor, yaw, device)
            t_d = (np.asarray(ep.dense_time).reshape(-1)[dv] if ep.dense_time is not None
                   else np.zeros(int(dv.sum())))
            traj.write_result_csv(os.path.join(out_dir, "dense_path.csv"), t_d, llh, ypr, enu)

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        llh, ypr, enu = _georef(p_sw, q_sw, anchor, yaw, device)
        traj.write_result_csv(os.path.join(out_dir, "tc_sw_result.csv"),
                              res.kf_time, llh, ypr, enu)
        if est.save_pcd:
            # Map export (save_pcd + mapping_interval, Estimator.cpp:5324-5349).
            from .eval import pointcloud
            world, valid = pointcloud.assemble_map(
                ep.scan, ep.scan_valid, p_sw, q_sw, every=max(est.mapping_interval, 1),
                ql2b=est.ql2b, tl2b=est.tl2b, device=device)
            pointcloud.write_pcd(os.path.join(out_dir, "map.pcd"), world, valid)

    have_gnss = ep.gnss is not None
    if run_lc is None:
        run_lc = have_gnss

    # --- stage 2: batch fusion.
    if run_batch:
        prob = batch_mod.build_problem(cfg, p_sw, q_sw, res.kf_time, ep.gnss,
                                       anchor, yaw, station, device=device)
        if est.sms_fusion_level == 1:
            # The reference's level 1 (Estimator.cpp:2990-3077), associated at
            # the stage-1 trajectory as in the JAX package.
            sms = batch_mod.build_sms1(cfg, ep.scan, ep.scan_valid, p_sw, q_sw,
                                       device=device)
            chain = batch_mod.build_imu_chain(cfg, ep.imu_acc, ep.imu_gyr, ep.imu_dt,
                                              ep.imu_valid, device=device)
            p_b, q_b, *_ = batch_mod.optimize_batch_sms1_imu(cfg, prob, sms, chain)
        else:
            p_b, q_b, _ = batch_mod.optimize_batch(cfg, prob, solver=est.batch_solver)
        res.p_batch = p_b.cpu().numpy()
        res.q_batch = q_b.cpu().numpy()
        cov = batch_mod.batch_marginal_covariance(cfg, prob, p_b, q_b)
        res.cov_batch = cov.cpu().numpy()
        synth = bool(np.asarray(getattr(ep.gnss, "station_synthesized", False) or False))
        cov_cal, cal_rep = batch_mod.calibrate_batch_covariance(
            cfg, prob, p_b, q_b, cov,
            # Synthesized base: the DD evidence shares the rover's unmodelled
            # atmosphere; 5 m is the JAX package's measured vertical gap.
            atm_floor_z=5.0 if synth else 0.0)
        res.cov_batch_cal = cov_cal.cpu().numpy()
        if out_dir:
            llh, ypr, enu = _georef(res.p_batch, res.q_batch, anchor, yaw, device)
            traj.write_result_csv(os.path.join(out_dir, "tc_batch_result.csv"),
                                  res.kf_time, llh, ypr, enu)
            _write_cov_csv(os.path.join(out_dir, "tc_batch_cov.csv"), res, cal_rep)

    # --- stage 3: loosely-coupled fusion of the RTK DD fixes.
    if run_lc:
        res.p_lc, res.q_lc = lc_stage(cfg, ep, p_sw, q_sw, anchor, yaw, station, device)
        if out_dir:
            llh, ypr, enu = _georef(res.p_lc, res.q_lc, anchor, yaw, device)
            traj.write_result_csv(os.path.join(out_dir, "lc_result.csv"),
                                  res.kf_time, llh, ypr, enu)
    return res


def lc_fixes(cfg, g, kf_time, anchor, yaw, station, device):
    """Stage 3's GNSS input: the DD fix of every epoch of ``g`` on
    ``device``, the covariance gate (``gnss_cov_threshold`` on √(tr Σ / 3))
    and the nearest-time association to keyframes (0.2 s). Returns numpy
    (gnss_p (T, 3) local, gnss_valid (T,), gnss_sigma (T,))."""
    fixes, covs, oks, _ = _dd_fixes(cfg, g, anchor, station, device)
    sig = torch.sqrt(torch.clamp(torch.diagonal(covs, dim1=1, dim2=2).sum(-1) / 3.0,
                                 min=1e-6)).cpu().numpy()
    okn = oks.cpu().numpy() & (sig < cfg.estimator.gnss_cov_threshold)
    enu_local = _local_from_ecef(fixes, anchor, yaw, device)
    ia, ib = traj.associate(kf_time, g.time, max_dt=0.2)
    T = np.asarray(kf_time).shape[0]
    gnss_p = np.zeros((T, 3))
    gnss_valid = np.zeros(T, bool)
    gnss_sigma = np.ones(T)
    keep = okn[ib]
    gnss_p[ia[keep]] = enu_local[ib[keep]]
    gnss_valid[ia[keep]] = True
    gnss_sigma[ia[keep]] = sig[ib[keep]]
    return gnss_p, gnss_valid, gnss_sigma


def lc_stage(cfg, ep, p_sw, q_sw, anchor, yaw, station, device):
    """Stage 3 on ``device``: DD fixes, gate and association (``lc_fixes``),
    then ``lc_fusion.solve`` over the stage-1 chain. Returns (p, q) numpy."""
    gnss_p, gnss_valid, gnss_sigma = lc_fixes(cfg, ep.gnss, np.asarray(ep.kf_time), anchor,
                                              yaw, station, device)
    prob = lc_fusion.build_problem(p_sw, q_sw, gnss_p, gnss_valid, gnss_sigma, device=device)
    f = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64, device=device)
    p_l, q_l, _ = lc_fusion.solve(prob, f(p_sw), f(q_sw))
    return p_l.cpu().numpy(), q_l.cpu().numpy()


def _to_host(out):
    """A NamedTuple of tensors on one device → the same of numpy arrays, in
    one device-to-host copy (every field flattened into one f64 buffer)."""
    fields = [a for a in out if a is not None]
    flat = torch.cat([a.reshape(-1).to(torch.float64) for a in fields]).cpu().numpy()
    host, i = [], 0
    for a in out:
        if a is None:
            host.append(None)
            continue
        n = a.numel()
        dtype = {torch.bool: bool, torch.int64: np.int64}.get(a.dtype, np.float64)
        host.append(flat[i:i + n].reshape(tuple(a.shape)).astype(dtype))
        i += n
    return type(out)(*host)


def float_ar_fixes(g, flt, kf_time, anchor, yaw, device, wavelength=None):
    """Stage 3's GNSS input from the carrier-phase path, composed as the JAX
    package's float/AR LC leg (``tests/test_lc_fusion.py:170-200``): the
    float filter's output ``flt`` (``rtk.run_float_filter``) copied to the
    host once, integer ambiguity resolution over it
    (``lambda_ar.resolve_trajectory``), the fixed position where the ratio
    test passed and the float one elsewhere, σ = √(tr Σ / 3) capped at 0.5 m
    where fixed, the 5 m gate on the float σ, and the nearest-time
    association to keyframes within 0.25 s. Returns numpy (gnss_p (T, 3)
    local, gnss_valid (T,), gnss_sigma (T,) floored at 0.5 m, fixed (E,))."""
    from .gnss import lambda_ar
    flt = _to_host(flt)
    sig = np.sqrt(np.maximum(np.trace(flt.pos_cov, axis1=1, axis2=2) / 3, 1e-6))
    ok = flt.ok & (sig < 5.0)
    pos_ar, fixed, _ = lambda_ar.resolve_trajectory(g, flt, wavelength=wavelength)
    fixes = flt.pos.copy()
    fixes[fixed] = pos_ar[fixed]
    sig = np.where(fixed, np.minimum(sig, 0.5), sig)
    local = _local_from_ecef(fixes, anchor, yaw, device)
    ia, ib = traj.associate(kf_time, g.time, max_dt=0.25)
    T = np.asarray(kf_time).shape[0]
    gnss_p = np.zeros((T, 3))
    gnss_valid = np.zeros(T, bool)
    gnss_sigma = np.ones(T)
    keep = ok[ib]
    gnss_p[ia[keep]] = local[ib[keep]]
    gnss_valid[ia[keep]] = True
    gnss_sigma[ia[keep]] = np.maximum(sig[ib[keep]], 0.5)
    return gnss_p, gnss_valid, gnss_sigma, fixed


def lc_stage_float_ar(g, kf_time, p_sw, q_sw, anchor, yaw, station, *, device, x0=None,
                      wavelength=None, timings: dict = None):
    """The float/AR variant of stage 3 on ``device``: ``run_float_filter``
    from ``x0`` (ECEF; default the first stage-1 pose), ``float_ar_fixes``,
    then ``lc_fusion.solve`` with Huber IRLS (c = 2) on the GNSS factors. With
    ``timings`` (a dict), the seconds of "filter", "ar" and "lc", each
    closed by a device sync. Returns (p, q) tensors, the filter's output,
    the gated fixes (``float_ar_fixes``'s first three) and the AR flags."""
    from .factors.gnss import local_to_ecef
    from .models.batch import _lap

    def f(a):
        return torch.as_tensor(np.asarray(a, float), dtype=torch.float64, device=device)
    dev = torch.device(device)
    if x0 is None:
        x0 = local_to_ecef(f(p_sw[0]), f(anchor), f(float(yaw)))
    t0 = _lap(timings, None, 0.0, dev)
    flt = rtk.run_float_filter(g, station, x0, device=device)
    t0 = _lap(timings, "filter", t0, dev)
    *fixes, fixed = float_ar_fixes(g, flt, kf_time, anchor, yaw, device, wavelength)
    t0 = _lap(timings, "ar", t0, dev)
    prob = lc_fusion.build_problem(p_sw, q_sw, *fixes, device=device)
    p_l, q_l, _ = lc_fusion.solve(prob, f(p_sw), f(q_sw), gnss_huber=2.0)
    _lap(timings, "lc", t0, dev)
    return p_l, q_l, flt, fixes, fixed


def _write_cov_csv(path, res: PipelineResult, cal_rep: dict):
    std_cal = np.sqrt(np.maximum(np.diagonal(res.cov_batch_cal, axis1=1, axis2=2), 0.0))
    std_frm = np.sqrt(np.maximum(np.diagonal(res.cov_batch, axis1=1, axis2=2), 0.0))
    with open(path, "w") as f:
        f.write(
            "# std_p*: CALIBRATED translation stds (m): formal "
            "information-matrix marginal + the global GNSS-"
            "evidence offset + the consistency-attenuated "
            "windowed departure in quadrature (+ a vertical "
            "atmosphere floor when the base station was "
            "synthesized). Sim-validated ~1-2 sigma coverage "
            "(tests/test_batch_cov.py); real-problem per-axis "
            "p90 |err|/std <= 1.9 (README). formal_p* are the "
            "raw information-matrix marginals: they model the "
            "assumed white measurement noise ONLY and are "
            "10-100x optimistic under NLOS/atmosphere bias — "
            "do not gate on them.\n"
            f"# calibration: {'applied' if cal_rep['calibrated'] else 'SKIPPED (too little GNSS)'}"
            f", n_epochs={cal_rep['n_epochs']}\n")
        f.write("time,std_px,std_py,std_pz,"
                "std_rx,std_ry,std_rz,"
                "formal_px,formal_py,formal_pz\n")
        np.savetxt(f, np.column_stack([res.kf_time, std_cal, std_frm[:, :3]]),
                   delimiter=",")
