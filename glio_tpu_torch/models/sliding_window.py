"""Tightly-coupled sliding-window estimator (port of ``glio_tpu/models/sliding_window.py``).

Per keyframe, ``SlidingWindowEstimator.step`` does what the JAX ``step`` of
``make_replay`` does, in the same order and on the same dtypes:

  1. preintegrates the IMU runs of the window's edges (f64);
  2. predicts the incoming keyframe from the newest state and edge;
  3. voxel-downsamples the map ring to 0.4 m;
  4. associates the window's points to the map by 5-NN (the CUDA kernel
     ``ops.knn`` on the card), fits planes and keeps the best per keyframe;
  5. solves the window by manifold LM with forward-mode Jacobians (on a
     CUDA device, as the replay of a CUDA graph captured once: ``_lm``);
  6. Schur-marginalizes the oldest keyframe into the prior;
  7. writes the solved poses back into the map ring.

``lax.scan`` over keyframes becomes a Python loop; every data-dependent
choice inside a step is a ``torch.where`` on the device, so a step never
waits on the host except inside ``torch.linalg.eigh`` in the
marginalization. Feature selection is the global top-F or ``diverse_select``.

With ``gnss_in_sliding_window`` (the reference ships these factors compiled
out, ``#if 0`` Estimator.cpp:2255-2421) the window also carries a ring of the
GNSS epochs bound to its intervals (``GnssKfData``, bound on the host by
``gnss.dd.bind_epochs_to_keyframes``) and adds their whitened DD pseudorange
rows; with ``doppler_in_window`` as well, Doppler rows and the clock-drift
tie, over a state extended by one receiver clock drift per slot
(``WindowStateDdt``). The GNSS rows are f64, as the rest of the window's
rows, and stay out of the marginalization's factor set.
"""

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..config import GlioConfig
from ..factors import gnss as gnss_factors
from ..factors import imu as imu_factors
from ..factors import lidar as lidar_factors
from ..lidar import neighbors, plane_fit
from ..ops.knn import knn
from ..solver import dense, marginalization
from ..solver.manifold import (POSE_DOF, WindowState, local_coordinates,
                               retract, tree_where)
from ..utils import profiling, quat
from ..utils.checkpoint import _leaves, _rebuild

F64 = torch.float64
F32 = torch.float32


class GnssKfData(NamedTuple):
    """The DD epoch bound to a keyframe's interval (zeros where there is
    none). The Doppler channel (sat_vel, sat_ddt, dopp) feeds the
    tcdopplerFactor rows (dopp_factor.hpp:19-85); ``dopp_std`` is the
    reference's per-satellite sigma sqrt(1 / (Doppler2PSRWeight · W_jj)),
    Doppler2PSRWeight = 0.1 (Estimator.cpp:71,2288)."""
    sat_pos: torch.Tensor     # (M, 3)
    psr_rov: torch.Tensor     # (M,)
    psr_sta: torch.Tensor     # (M,)
    sv_valid: torch.Tensor    # (M,) bool
    system: torch.Tensor      # (M,) int32
    master: torch.Tensor      # (4,) int32
    whiten: torch.Tensor      # (4, M, M)
    ratio: torch.Tensor       # () interpolation toward the older keyframe
    valid: torch.Tensor       # () bool
    sat_vel: torch.Tensor     # (M, 3) ECEF satellite velocity
    sat_ddt: torch.Tensor     # (M,) satellite clock drift (m/s)
    dopp: torch.Tensor        # (M,) measured range rate (m/s)
    dopp_valid: torch.Tensor  # (M,) bool
    dopp_std: torch.Tensor    # (M,) per-satellite Doppler sigma (m/s)


GNSS_DTYPES = {"sv_valid": torch.bool, "system": torch.int32, "master": torch.int32,
               "valid": torch.bool, "dopp_valid": torch.bool}


def gnss_from_bound(bound: dict, device) -> GnssKfData:
    """``bind_epochs_to_keyframes``'s arrays (``gnss_`` keys) → stacked
    ``GnssKfData`` on ``device``."""
    return GnssKfData(**{
        f: torch.as_tensor(np.array(bound["gnss_" + f]), device=device).to(
            GNSS_DTYPES.get(f, F64)) for f in GnssKfData._fields})


def empty_gnss(lead: tuple, max_sv: int, device) -> GnssKfData:
    """A ``GnssKfData`` of zeros with leading shape ``lead``: no epoch."""
    shapes = {"sat_pos": (max_sv, 3), "sat_vel": (max_sv, 3), "master": (4,),
              "whiten": (4, max_sv, max_sv), "ratio": (), "valid": ()}
    return GnssKfData(**{
        f: torch.zeros(lead + shapes.get(f, (max_sv,)), dtype=GNSS_DTYPES.get(f, F64),
                       device=device) for f in GnssKfData._fields})


class WindowStateDdt(NamedTuple):
    """The window state and one receiver clock drift per slot: the state of
    the Doppler rows. Slot k carries the drift of the epoch bound to the
    interval (k-1, k] and slides with the window (the reference's global
    ``para_rcv_ddt``, Estimator.cpp:2100-2148)."""
    win: WindowState
    ddt: torch.Tensor   # (K,) m/s


def retract_ddt(state: WindowStateDdt, delta) -> WindowStateDdt:
    """Tangent update of the extended state: [K*15 pose dofs | K ddt]."""
    n = state.win.p.shape[0] * POSE_DOF
    return WindowStateDdt(retract(state.win, delta[:n]), state.ddt + delta[n:])


class KeyframeInput(NamedTuple):
    """Per-keyframe measurements; stacked over time for ``replay``."""
    imu_acc: torch.Tensor     # (NI, 3) f64
    imu_gyr: torch.Tensor     # (NI, 3) f64
    imu_dt: torch.Tensor      # (NI,) f64
    imu_valid: torch.Tensor   # (NI,) bool
    scan: torch.Tensor        # (S, 3) f32 lidar-frame surf points
    scan_valid: torch.Tensor  # (S,) bool
    time: torch.Tensor        # () keyframe timestamp
    gnss: GnssKfData = None   # the DD epoch of this interval, if bound


class SlidingWindowCarry(NamedTuple):
    window: WindowState               # (K, ...) current window estimates
    window_scans: torch.Tensor        # (K, S, 3) f32 lidar-frame clouds
    window_scan_valid: torch.Tensor   # (K, S)
    prior_sqrt_jac: torch.Tensor      # (K*15, K*15)
    prior_sqrt_res: torch.Tensor      # (K*15,)
    prior_valid: torch.Tensor         # () bool
    prior_lin: WindowState            # linearization point of the prior
    map_scans: torch.Tensor           # (M, S, 3) ring of lidar-frame clouds
    map_scan_valid: torch.Tensor      # (M, S)
    map_world: torch.Tensor           # (M, S, 3) f32 cached world clouds
    map_p: torch.Tensor               # (M, 3) poses of the ring's frames
    map_q: torch.Tensor               # (M, 4)
    map_slot_valid: torch.Tensor      # (M,) bool
    map_head: torch.Tensor            # () int32 next write slot
    kf_count: torch.Tensor            # () int32 keyframes processed
    last_acc: torch.Tensor            # (3,) last IMU sample (midpoint seed)
    last_gyr: torch.Tensor            # (3,)


class ReplayCarry(NamedTuple):
    """Everything ``step`` carries from one keyframe to the next."""
    base: SlidingWindowCarry
    imu_acc: torch.Tensor    # (K-1, NI, 3) IMU ring, edge k runs k → k+1
    imu_gyr: torch.Tensor
    imu_dt: torch.Tensor     # (K-1, NI)
    imu_valid: torch.Tensor  # (K-1, NI)
    imu_seed: torch.Tensor   # (K-1, 6) acc0/gyr0 seeds per edge
    gnss_win: GnssKfData     # (K, ...) ring of the intervals' DD epochs
    ddt: torch.Tensor        # (K,) receiver clock drift per bound epoch


class StepOutput(NamedTuple):
    p: torch.Tensor
    q: torch.Tensor
    v: torch.Tensor
    ba: torch.Tensor
    bg: torch.Tensor
    cost: torch.Tensor
    n_lidar_factors: torch.Tensor
    ddt: torch.Tensor   # receiver clock drift of the newest bound epoch (m/s)


class LidarMeas(NamedTuple):
    points: torch.Tensor   # (K, F, 3) lidar-frame points
    normal: torch.Tensor   # (K, F, 3) world plane normals
    d: torch.Tensor        # (K, F) plane offsets
    score: torch.Tensor    # (K, F) lidar_const · fit weight
    mask: torch.Tensor     # (K, F) bool


def _top_k(w, k: int):
    """``lax.top_k`` over the last axis: lax.top_k puts lower indices first
    among equal values, as a stable descending sort does (torch.topk
    promises no order, and the weight −1 is tied almost everywhere)."""
    top_w, top_i = torch.sort(w, dim=-1, descending=True, stable=True)
    return top_w[..., :k], top_i[..., :k]


N_BUCKETS = 18          # 3 dominant-normal axes x 6 azimuth sextants


def _diverse_top(w, normal, scans, Fsel: int):
    """The JAX package's diverse selection (sliding_window.py:228-266): the
    best F/2 of each keyframe by weight, then, with those masked, the best
    D = F − F/2 of the union of each bucket's top ⌈D/18⌉, the buckets being
    the fit normal's dominant axis × the lidar-frame point's azimuth
    sextant. w (K, S), normal (K, S, 3) f32, scans (K, S, 3) f32."""
    G = Fsel // 2
    gw, gi = _top_k(w, G)
    w2 = w.scatter(-1, gi, -1.0)                          # no duplicates
    dom = torch.argmax(normal.abs(), dim=-1)
    az = torch.atan2(scans[..., 1], scans[..., 0])
    # The divisor is a tensor, as in neighbors.voxel_downsample: CUDA divides
    # by a host scalar as a multiply by its reciprocal.
    sextant_rad = torch.full_like(az, torch.pi / 3.0)
    sect = torch.clamp((az + torch.pi) / sextant_rad, 0, 5).to(torch.int64)
    bucket = dom * 6 + sect
    D = Fsel - G
    Fb = -(-D // N_BUCKETS)
    b = torch.arange(N_BUCKETS, device=w.device)[:, None, None]
    wa = torch.where(bucket[None] == b, w2[None], torch.full_like(w2, -1.0)[None])
    twa, tia = _top_k(wa, Fb)                             # (18, K, Fb)
    cw = twa.permute(1, 0, 2).reshape(w.shape[0], N_BUCKETS * Fb)
    ci = tia.permute(1, 0, 2).reshape(w.shape[0], N_BUCKETS * Fb)
    dw, sub = _top_k(cw, D)
    di = torch.gather(ci, -1, sub)
    return torch.cat([gw, dw], dim=-1), torch.cat([gi, di], dim=-1)


def _shift_window(w):
    """Roll out the oldest frame and duplicate the newest slot."""
    return type(w)(*(torch.cat([a[1:], a[-1:]], dim=0) for a in w))


def cloned(tree):
    """A (nested) named tuple of tensors with every tensor cloned."""
    return _rebuild(tree, iter([x.clone() for x in _leaves(tree)]))


def index_inputs(tree, i):
    """``tree[i]`` on every tensor of a (nested) named tuple, such as a
    stacked ``KeyframeInput``; None stays None."""
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else tree[i]
    return type(tree)(*(index_inputs(a, i) for a in tree))



class SlidingWindowEstimator(nn.Module):
    """The replay of ``glio_tpu.models.sliding_window.make_replay`` in torch.

    ``replay`` (also ``forward``) runs a stacked ``KeyframeInput`` from an
    initial state; ``make_initial_carry`` and ``replay_from`` resume from a
    saved carry. The constants are buffers on ``device``. TF32 is switched
    off for the process: the f32 association and residuals must stay f32.
    """

    def __init__(self, cfg: GlioConfig, device):
        super().__init__()
        est = cfg.estimator
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.K = est.slide_window_width
        self.S = cfg.shapes.scan_points
        self.M = est.local_map_width
        params = imu_factors.ImuParams(cfg.imu.acc_n, cfg.imu.gyr_n,
                                       cfg.imu.acc_w, cfg.imu.gyr_w,
                                       cfg.imu.gravity)
        self.register_buffer("gravity", params.gravity_vec(device))
        self.register_buffer("noise_cov", params.noise_cov(device))
        self.register_buffer("q_lb", torch.tensor(est.ql2b, dtype=F64, device=device))
        self.register_buffer("t_lb", torch.tensor(est.tl2b, dtype=F64, device=device))
        self.use_gnss = est.gnss_in_sliding_window
        self.use_dopp = self.use_gnss and est.doppler_in_window
        self._lm_graphs = {}   # input signature → captured LM (CUDA devices)
        init = cfg.initialization
        for name in ("anc_ecef", "station_ecef", "lever_arm", "yaw_enu_local"):
            self.register_buffer(name, torch.tensor(getattr(init, name), dtype=F64,
                                                    device=device))

    @property
    def device(self):
        return self.gravity.device

    def _vec(self, x):
        return torch.as_tensor(x, dtype=F64, device=self.device)

    # -- carry -------------------------------------------------------------

    def make_initial_carry(self, p0, q0, v0, acc0=None, gyr0=None, *, n_imu: int,
                           max_sv: int = 32):
        """Fresh carry for ``replay_from``; ``n_imu`` is the IMU padding NI,
        ``max_sv`` the GNSS slots of the inputs (``Episode.to_inputs``)."""
        K, S, M, dev = self.K, self.S, self.M, self.device
        w = WindowState(p=self._vec(p0).expand(K, 3).clone(),
                        q=self._vec(q0).expand(K, 4).clone(),
                        v=self._vec(v0).expand(K, 3).clone(),
                        ba=torch.zeros((K, 3), dtype=F64, device=dev),
                        bg=torch.zeros((K, 3), dtype=F64, device=dev))
        n = K * POSE_DOF
        map_q = torch.zeros((M, 4), dtype=F64, device=dev)
        map_q[:, 0] = 1.0
        zeros3 = torch.zeros(3, dtype=F64, device=dev)
        base = SlidingWindowCarry(
            window=w,
            window_scans=torch.zeros((K, S, 3), dtype=F32, device=dev),
            window_scan_valid=torch.zeros((K, S), dtype=torch.bool, device=dev),
            prior_sqrt_jac=torch.zeros((n, n), dtype=F64, device=dev),
            prior_sqrt_res=torch.zeros((n,), dtype=F64, device=dev),
            prior_valid=torch.zeros((), dtype=torch.bool, device=dev),
            prior_lin=w,
            map_scans=torch.zeros((M, S, 3), dtype=F32, device=dev),
            map_scan_valid=torch.zeros((M, S), dtype=torch.bool, device=dev),
            map_world=torch.zeros((M, S, 3), dtype=F32, device=dev),
            map_p=torch.zeros((M, 3), dtype=F64, device=dev),
            map_q=map_q,
            map_slot_valid=torch.zeros((M,), dtype=torch.bool, device=dev),
            map_head=torch.zeros((), dtype=torch.int32, device=dev),
            kf_count=torch.zeros((), dtype=torch.int32, device=dev),
            last_acc=zeros3 if acc0 is None else self._vec(acc0),
            last_gyr=zeros3 if gyr0 is None else self._vec(gyr0),
        )
        return ReplayCarry(
            base,
            imu_acc=torch.zeros((K - 1, n_imu, 3), dtype=F64, device=dev),
            imu_gyr=torch.zeros((K - 1, n_imu, 3), dtype=F64, device=dev),
            imu_dt=torch.zeros((K - 1, n_imu), dtype=F64, device=dev),
            imu_valid=torch.zeros((K - 1, n_imu), dtype=torch.bool, device=dev),
            imu_seed=torch.zeros((K - 1, 6), dtype=F64, device=dev),
            gnss_win=empty_gnss((K,), max_sv, dev),
            ddt=torch.zeros((K,), dtype=F64, device=dev),
        )

    # -- replay ------------------------------------------------------------

    def replay_from(self, carry: ReplayCarry, inputs: KeyframeInput):
        """Run the stacked ``inputs`` from ``carry``; returns
        (final carry, StepOutput stacked over time)."""
        outs = []
        for t in range(inputs.scan.shape[0]):
            carry, out = self.step(carry, index_inputs(inputs, t))
            outs.append(out)
        return carry, StepOutput(*(torch.stack(a) for a in zip(*outs)))

    def replay(self, inputs: KeyframeInput, p0, q0, v0, acc0=None, gyr0=None):
        max_sv = 32 if inputs.gnss is None else inputs.gnss.sv_valid.shape[-1]
        carry = self.make_initial_carry(p0, q0, v0, acc0, gyr0,
                                        n_imu=inputs.imu_acc.shape[-2], max_sv=max_sv)
        return self.replay_from(carry, inputs)[1]

    forward = replay

    # -- one keyframe --------------------------------------------------------

    def _to_world(self, scan, p, q):
        """Lidar-frame scan(s) → world, all f32 (extrinsic, then pose)."""
        b = lidar_factors.body_from_lidar(scan.to(F32), self.q_lb.to(F32),
                                          self.t_lb.to(F32))
        return quat.rotate(q.to(F32)[..., None, :], b) + p.to(F32)[..., None, :]

    def _associate(self, window: WindowState, window_scans, window_scan_valid,
                   map_points, map_valid) -> LidarMeas:
        """5-NN plane correspondences for every window keyframe
        (``findCorrespondingSurfFeatures`` + a deterministic top-F by fit
        weight, global or with ``diverse_select`` spread over normal
        directions and azimuths, in place of the reference's random subset)."""
        est = self.cfg.estimator
        K, S = window.p.shape[0], self.S
        Fsel = min(self.cfg.feature_selection.feature_res_num, S)
        world32 = self._to_world(window_scans, window.p, window.q).reshape(K * S, 3)
        valid_flat = window_scan_valid.reshape(K * S)

        d2, idx = knn(world32.contiguous(), valid_flat.contiguous(),
                      map_points, map_valid, k=5)
        neigh = neighbors.gather_neighbors(map_points, idx)
        neigh_ok = (idx >= 0) & (d2 <= est.kd_max_radius ** 2)
        fit = plane_fit.fit_planes(neigh, neigh_ok, world32,
                                   plane_tol=est.surf_dist_thres)
        w = fit.weight
        good = fit.valid & valid_flat & (w > 0.3) & neigh_ok.all(dim=-1)
        w = torch.where(good, w, torch.full_like(w, -1.0)).reshape(K, S)
        if self.cfg.feature_selection.diverse_select:
            top_w, top_i = _diverse_top(w, fit.normal.reshape(K, S, 3), window_scans, Fsel)
        else:
            top_w, top_i = _top_k(w, Fsel)
        flat_i = top_i + torch.arange(K, device=w.device)[:, None] * S
        return LidarMeas(
            points=window_scans.reshape(K * S, 3)[flat_i].to(F64),
            normal=fit.normal[flat_i].to(F64),
            d=fit.d[flat_i].to(F64),
            score=(est.lidar_const * top_w).to(F64),
            mask=top_w > 0)

    def _window_residual(self, state: WindowState, pres, imu_S, imu_edge_valid,
                         lidar32, prior_sqrt_jac, prior_sqrt_res, prior_valid,
                         prior_lin, gnss_win: GnssKfData = None, ddt=None):
        """All window residuals, concatenated (fixed shape)."""
        dx = local_coordinates(state, prior_lin)
        r_prior = prior_sqrt_res + prior_sqrt_jac @ dx
        r_prior = torch.where(prior_valid, r_prior, torch.zeros_like(r_prior))

        r_imu = imu_factors.whitened_residual_cached(
            imu_S, pres,
            state.p[:-1], state.q[:-1], state.v[:-1], state.ba[:-1], state.bg[:-1],
            state.p[1:], state.q[1:], state.v[1:], state.ba[1:], state.bg[1:],
            gravity=self.gravity)
        r_imu = torch.where(imu_edge_valid[:, None], r_imu, torch.zeros_like(r_imu))

        # LiDAR rows are evaluated in f32 with the pose cast to f32, then
        # promoted, as in the JAX package.
        pts, nrm, d, score, mask = lidar32
        r_lidar = lidar_factors.plane_norm_residual(
            pts, nrm, d, score, state.p.to(F32), state.q.to(F32),
            self.q_lb.to(F32), self.t_lb.to(F32), mask).to(F64)
        r_lidar = r_lidar * dense.huber_weight(r_lidar)
        parts = [r_prior, r_imu.reshape(-1), r_lidar.reshape(-1)]
        if gnss_win is not None:
            parts += self._gnss_residual(state, gnss_win, ddt)
        return torch.cat(parts)

    def _gnss_residual(self, state: WindowState, g: GnssKfData, ddt):
        """The window's GNSS rows: slot k's epoch binds to the interval
        (k-1, k]; slot 0's older pose has left the window, so it is masked.
        DD rows (gated at ``window_dd_threshold``) and, with ``ddt`` (the
        Doppler path), Doppler rows and the clock-drift tie of adjacent
        slots that both carry an epoch, both with HuberLoss(1.0) as the
        reference (a tie across an epoch-less interval is dropped)."""
        anchor, station, lever, yaw = (self.anc_ecef, self.station_ecef, self.lever_arm,
                                       self.yaw_enu_local)
        K = state.p.shape[0]
        pair_ok = torch.arange(K, device=self.device) >= 1
        on = g.valid & pair_ok
        p_older = torch.cat([state.p[:1], state.p[:-1]])
        r_dd = gnss_factors.dd_psr_residual(
            p_older, state.p, g.ratio, anchor, yaw, station, g.sat_pos, g.psr_rov,
            g.psr_sta, g.sv_valid, g.system, g.master, g.whiten,
            threshold=self.cfg.estimator.window_dd_threshold, lever_arm=lever)
        parts = [torch.where(on[:, None, None], r_dd, torch.zeros_like(r_dd)).reshape(-1)]
        if ddt is not None:
            v_older = torch.cat([state.v[:1], state.v[:-1]])
            r_dopp = gnss_factors.doppler_residual(
                p_older, v_older, state.p, state.v, g.ratio, ddt, anchor, yaw, g.sat_pos,
                g.sat_vel, g.sat_ddt, g.dopp, g.dopp_valid & g.sv_valid,
                torch.clamp(g.dopp_std, min=1e-3), lever_arm=lever)
            r_dopp = torch.where(on[:, None], r_dopp, torch.zeros_like(r_dopp))
            r_dopp = r_dopp * dense.huber_weight(r_dopp)
            r_tie = gnss_factors.clock_drift_residual(ddt, g.valid[:-1] & g.valid[1:] & pair_ok[1:])
            r_tie = r_tie * dense.huber_weight(r_tie)
            parts += [r_dopp.reshape(-1), r_tie]
        return parts

    def _marginalize_oldest(self, state: WindowState, pres, imu_S, imu_edge_valid,
                            lidar_meas: LidarMeas, prior_sqrt_jac,
                            prior_sqrt_res, prior_valid, prior_lin):
        """Schur-drop keyframe 0 into a prior over frames 1..K-1, padded back
        to the window's dimension. Factors: the previous prior, IMU edge
        (0, 1) and keyframe 0's lidar rows (Estimator.cpp:2462-2608)."""
        n = self.K * POSE_DOF
        pre0 = index_inputs(pres, 0)

        def res_fn(delta):
            s = retract(state, delta)
            dx = local_coordinates(s, prior_lin)
            r_prior = prior_sqrt_res + prior_sqrt_jac @ dx
            r_prior = torch.where(prior_valid, r_prior, torch.zeros_like(r_prior))
            r_imu = imu_factors.whitened_residual_cached(
                imu_S[0], pre0, s.p[0], s.q[0], s.v[0], s.ba[0], s.bg[0],
                s.p[1], s.q[1], s.v[1], s.ba[1], s.bg[1], gravity=self.gravity)
            r_imu = torch.where(imu_edge_valid[0], r_imu, torch.zeros_like(r_imu))
            r_lid = lidar_factors.plane_norm_residual(
                lidar_meas.points[0], lidar_meas.normal[0], lidar_meas.d[0],
                lidar_meas.score[0], s.p[0], s.q[0], self.q_lb, self.t_lb,
                lidar_meas.mask[0])
            r_lid = r_lid * dense.huber_weight(r_lid)
            return torch.cat([r_prior, r_imu, r_lid])

        zero = torch.zeros(n, dtype=F64, device=self.device)
        r = res_fn(zero)
        J = torch.func.jacfwd(res_fn)(zero)
        prior = marginalization.marginalize(J.T @ J, J.T @ r, POSE_DOF)
        sj = nn.functional.pad(prior.sqrt_jac, (0, POSE_DOF, 0, POSE_DOF))
        sr = nn.functional.pad(prior.sqrt_res, (0, POSE_DOF))
        return sj, sr

    def _solve_window(self, w_new: WindowState, ddt_ring, pres, imu_S, imu_edge_valid,
                      lidar32, prior_sqrt_jac, prior_sqrt_res, prior_valid,
                      prior_lin: WindowState, gnss_win: GnssKfData = None):
        """Step 6, the window's LM solve and its divergence gates, as a
        function of these tensors and the estimator's constant buffers alone;
        ``gnss_win`` is None without GNSS rows. Before the first marginal
        prior exists, frame 0's pose is pinned; a weak zero prior on the
        biases is always on and is not part of the marginalized factor set.
        Returns (solved, ddt_solved, cost)."""
        K, newest = self.K, self.K - 1

        def residual_anchored(s):
            s, ddt_s = (s.win, s.ddt) if self.use_dopp else (s, None)
            r = self._window_residual(s, pres, imu_S, imu_edge_valid, lidar32,
                                      prior_sqrt_jac, prior_sqrt_res, prior_valid,
                                      prior_lin, gnss_win, ddt_s)
            anchor = torch.cat([
                1e2 * (s.p[0] - w_new.p[0]),
                1e2 * quat.log(quat.mul(quat.conj(w_new.q[0]), s.q[0])),
            ])
            anchor = torch.where(prior_valid, torch.zeros_like(anchor), anchor)
            bias_reg = torch.cat([10.0 * s.ba.reshape(-1), 30.0 * s.bg.reshape(-1)])
            return torch.cat([r, anchor, bias_reg])

        max_iters = self.cfg.estimator.sw_max_iter
        if self.use_dopp:
            out = dense.lm_solve(residual_anchored, retract_ddt,
                                 WindowStateDdt(w_new, ddt_ring), K * POSE_DOF + K,
                                 max_iters=max_iters)
            solved, ddt_solved = out.x
        else:
            out = dense.lm_solve(residual_anchored, retract, w_new, K * POSE_DOF,
                                 max_iters=max_iters)
            solved, ddt_solved = out.x, ddt_ring

        # Divergence gates (Estimator.cpp:2650-2726): keep the prediction.
        ok = (torch.isfinite(solved.p).all()
              & (quat.norm(solved.p[newest] - w_new.p[newest]) < 100.0)
              & (torch.sqrt(torch.sum(solved.v * solved.v)) < 100.0 * K)
              & (solved.ba.abs().max() < 2.0)
              & (solved.bg.abs().max() < 2.0)
              & (ddt_solved.abs() < 1e4).all())
        solved = tree_where(ok, solved, w_new)
        ddt_solved = torch.where(ok, ddt_solved, ddt_ring)
        return solved, ddt_solved, out.cost

    def _lm(self, *args):
        """``_solve_window(*args)``. Off the card it is called directly. On a
        CUDA device it runs as the replay of a CUDA graph captured at the
        first call with each input signature (the tensors' shapes and dtypes,
        and which rows the window has): the live tensors are copied into the
        graph's static inputs, and the results are clones of its static
        outputs, so that no result aliases a buffer the next call overwrites.
        The solve reads nothing on the host, so the replay runs the same
        kernels on the same inputs as the direct call."""
        if self.device.type != "cuda":
            profiling.tally("window.lm.eager")
            return self._solve_window(*args)
        leaves = _leaves(args)
        key = (self.use_gnss, self.use_dopp) + tuple((x.shape, x.dtype) for x in leaves)
        with torch.cuda.device(self.device):
            if key not in self._lm_graphs:
                self._lm_graphs[key] = self._capture_lm(args)
                profiling.tally("window.lm.captures")
            graph, static_in, static_out = self._lm_graphs[key]
            for buf, x in zip(static_in, leaves):
                buf.copy_(x)
            graph.replay()
            profiling.tally("window.lm.replays")
            return cloned(static_out)

    def _capture_lm(self, args):
        """(graph, static inputs, static outputs) of ``_solve_window`` on
        copies of ``args``: one direct run on a side stream first, as
        capture requires, then the capture."""
        static = cloned(args)
        stream = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._solve_window(*static)
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._solve_window(*static)
        return graph, _leaves(static), out

    def step(self, carry: ReplayCarry, inp: KeyframeInput):
        """One keyframe; returns (new carry, StepOutput)."""
        with profiling.span("window.step"):
            return self._step(carry, inp)

    def _step(self, carry: ReplayCarry, inp: KeyframeInput):
        cfg, est = self.cfg, self.cfg.estimator
        K, M = self.K, self.M
        c = carry.base
        w = c.window
        newest = K - 1
        first = c.kf_count == 0
        dev = self.device

        # IMU accel sanity clamp (Estimator.cpp:4176-4182).
        imu_acc_in = inp.imu_acc.clamp(-18.0, 18.0)

        # 1. Slide the window; the incoming slot is filled in step 3a.
        w_slid = _shift_window(w)
        scans = torch.where(first,
                            torch.cat([c.window_scans[:-1], inp.scan[None]]),
                            torch.cat([c.window_scans[1:], inp.scan[None]]))
        scan_valid = torch.where(
            first, torch.cat([c.window_scan_valid[:-1], inp.scan_valid[None]]),
            torch.cat([c.window_scan_valid[1:], inp.scan_valid[None]]))

        def shift_append(ring, new):
            return torch.where(first, ring, torch.cat([ring[1:], new[None]]))

        imu_acc = shift_append(carry.imu_acc, imu_acc_in.to(F64))
        imu_gyr = shift_append(carry.imu_gyr, inp.imu_gyr.to(F64))
        imu_dt = shift_append(carry.imu_dt, inp.imu_dt.to(F64))
        imu_valid = shift_append(carry.imu_valid, inp.imu_valid & ~first)
        imu_seed = shift_append(carry.imu_seed, torch.cat([c.last_acc, c.last_gyr]))
        gnss_win, ddt_ring = carry.gnss_win, carry.ddt
        if self.use_gnss:
            if inp.gnss is None:
                raise ValueError("gnss_in_sliding_window needs inputs with bound GNSS "
                                 "(Episode.to_inputs)")
            gnss_win = type(gnss_win)(*(shift_append(r, n) for r, n in zip(gnss_win, inp.gnss)))
            # The drift ring slides with the epochs; the incoming slot starts
            # from the last estimate (constantClockDriftFactor's premise).
            ddt_ring = shift_append(carry.ddt, carry.ddt[-1])

        n_edges = torch.clamp(c.kf_count, max=K - 1)
        imu_edge_valid = torch.arange(K - 1, device=dev) >= (K - 1 - n_edges)

        # 2. Preintegrate all window edges at the current bias estimates.
        with profiling.span("window.preintegrate"):
            ba_sel = torch.where(first, w.ba, w_slid.ba)
            bg_sel = torch.where(first, w.bg, w_slid.bg)
            pres = imu_factors.preintegrate(
                imu_acc, imu_gyr, imu_dt, imu_valid, ba_sel[:-1], bg_sel[:-1],
                imu_seed[:, :3], imu_seed[:, 3:], self.noise_cov)
            imu_S = imu_factors.sqrt_info(pres)

        # 3. Predict the incoming keyframe from the newest edge's deltas.
        pre_new = index_inputs(pres, K - 2)
        p_i, q_i, v_i = w.p[newest], w.q[newest], w.v[newest]
        dt_e = pre_new.sum_dt
        g = self.gravity
        p_pred = (p_i + v_i * dt_e - 0.5 * g * dt_e * dt_e
                  + quat.rotate(q_i, pre_new.delta_p))
        q_pred = quat.normalize(quat.mul(q_i, pre_new.delta_q))
        v_pred = v_i - g * dt_e + quat.rotate(q_i, pre_new.delta_v)
        # Seed of the next interval: this interval's last valid sample.
        ni = inp.imu_valid.shape[0]
        last_i = ni - 1 - torch.argmax(inp.imu_valid.flip(0).to(torch.int32))
        any_imu = inp.imu_valid.any()
        a_last = torch.where(any_imu, imu_acc_in[last_i].to(F64), c.last_acc)
        g_last = torch.where(any_imu, inp.imu_gyr[last_i].to(F64), c.last_gyr)

        # 3a. Install the new frame.
        w_new = WindowState(
            p=torch.cat([w_slid.p[:-1], p_pred[None]]),
            q=torch.cat([w_slid.q[:-1], q_pred[None]]),
            v=torch.cat([w_slid.v[:-1], v_pred[None]]),
            ba=w_slid.ba, bg=w_slid.bg)
        w_new = tree_where(first, w, w_new)

        # 4. Local map: 0.4 m voxel grid of the cached world clouds
        # (ds_filter_surf_map.setLeafSize(0.4), Estimator.cpp:854).
        with profiling.span("window.voxel_map"):
            map_valid_pts = c.map_scan_valid & c.map_slot_valid[:, None]
            map_flat, map_valid_flat = neighbors.voxel_downsample(
                c.map_world.reshape(M * self.S, 3), map_valid_pts.reshape(M * self.S),
                0.4, cfg.shapes.map_points, scatter_keys=True)

        # 5. Associate the window scans with the map.
        with profiling.span("window.associate"):
            meas = self._associate(w_new, scans, scan_valid, map_flat, map_valid_flat)
            meas = meas._replace(mask=meas.mask & map_valid_flat.any())
            lidar32 = (meas.points.to(F32), meas.normal.to(F32), meas.d.to(F32),
                       meas.score.to(F32), meas.mask)

        # 6. Solve.
        with profiling.span("window.lm"):
            solved, ddt_solved, cost = self._lm(
                w_new, ddt_ring, pres, imu_S, imu_edge_valid, lidar32, c.prior_sqrt_jac,
                c.prior_sqrt_res, c.prior_valid, c.prior_lin,
                gnss_win if self.use_gnss else None)

        # 7. Marginalize the oldest frame once the window is full.
        with profiling.span("window.marginalize"):
            prior_sqrt_jac, prior_sqrt_res = c.prior_sqrt_jac, c.prior_sqrt_res
            prior_valid, prior_lin = c.prior_valid, c.prior_lin
            if est.enable_marginalization:
                sj, sr = self._marginalize_oldest(
                    solved, pres, imu_S, imu_edge_valid, meas, c.prior_sqrt_jac,
                    c.prior_sqrt_res, c.prior_valid, c.prior_lin)
                window_full = c.kf_count >= K - 1
                prior_sqrt_jac = torch.where(window_full, sj, c.prior_sqrt_jac)
                prior_sqrt_res = torch.where(window_full, sr, c.prior_sqrt_res)
                prior_valid = c.prior_valid | window_full
                prior_lin = tree_where(window_full, _shift_window(solved), c.prior_lin)

        # 8. Map ring: append the newest frame, then write back the solved
        # poses (and world clouds) of the K-1 older window frames.
        with profiling.span("window.map_ring"):
            slot = (c.map_head % M).reshape(1).long()
            map_scans = c.map_scans.index_copy(0, slot, inp.scan[None])
            map_scan_valid = c.map_scan_valid.index_copy(0, slot, inp.scan_valid[None])
            map_p = c.map_p.index_copy(0, slot, solved.p[newest][None])
            map_q = c.map_q.index_copy(0, slot, solved.q[newest][None])
            map_world = c.map_world.index_copy(
                0, slot, self._to_world(inp.scan, solved.p[newest], solved.q[newest])[None])
            map_slot_valid = c.map_slot_valid.index_copy(
                0, slot, torch.ones(1, dtype=torch.bool, device=dev))

            i = torch.arange(K - 1, device=dev)
            wf = K - 2 - i                                    # window frame
            sl = ((c.map_head - 1 - i) % M).long()            # its map slot
            in_window = i < n_edges
            p_wf, q_wf = solved.p[wf], solved.q[wf]
            map_p = map_p.index_copy(
                0, sl, torch.where(in_window[:, None], p_wf, map_p[sl]))
            map_q = map_q.index_copy(
                0, sl, torch.where(in_window[:, None], q_wf, map_q[sl]))
            map_world = map_world.index_copy(
                0, sl, torch.where(in_window[:, None, None],
                                   self._to_world(map_scans[sl], p_wf, q_wf),
                                   map_world[sl]))

        new_base = SlidingWindowCarry(
            window=solved, window_scans=scans, window_scan_valid=scan_valid,
            prior_sqrt_jac=prior_sqrt_jac, prior_sqrt_res=prior_sqrt_res,
            prior_valid=prior_valid, prior_lin=prior_lin,
            map_scans=map_scans, map_scan_valid=map_scan_valid,
            map_world=map_world, map_p=map_p, map_q=map_q,
            map_slot_valid=map_slot_valid, map_head=c.map_head + 1,
            kf_count=c.kf_count + 1, last_acc=a_last, last_gyr=g_last)
        new_carry = ReplayCarry(new_base, imu_acc, imu_gyr, imu_dt, imu_valid,
                                imu_seed, gnss_win, ddt_solved)
        out_rec = StepOutput(
            p=solved.p[newest], q=solved.q[newest], v=solved.v[newest],
            ba=solved.ba[newest], bg=solved.bg[newest], cost=cost,
            n_lidar_factors=meas.mask.sum().to(torch.int32), ddt=ddt_solved[newest])
        return new_carry, out_rec


def make_replay(cfg: GlioConfig, device) -> SlidingWindowEstimator:
    """Counterpart of ``glio_tpu.models.sliding_window.make_replay``: the
    returned module is the replay (``est(inputs, p0, q0, v0, acc0, gyr0)``)
    and carries ``step``, ``make_initial_carry`` and ``replay_from``."""
    return SlidingWindowEstimator(cfg, device)
