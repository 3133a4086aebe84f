"""Scan-to-local-map LiDAR odometry (port of ``glio_tpu/models/lidar_odometry.py``).

The reference's ``LidarOdometry`` node (``GLIO/src/LidarOdometry.cpp``):

* local map: the last 20 keyframe surf clouds (``buildLocalMap``
  :268-292), voxelled at 0.2 m (:306-314) when the ring outgrows the
  search budget;
* pose prediction by composing the last relative motion (:406-433);
* correspondences: 5-NN plane fits with 0.06 m planarity and weight > 0.4
  (``findCorrespondingSurfFeatures`` :343-404), the 5-NN being the CUDA
  kernel ``ops.knn`` on the card;
* solve: point-to-plane with Huber(0.1), at most ``max_num_iter``
  iterations (:474-581), ``max(2, scan_match_cnt)`` rounds;
* keyframe test: Δt > 0.2 m ∨ Δθ > 0.1 rad ∨ a gap of 2 frames (:566-578).

``LidarOdometry.step`` is one frame of the JAX package's ``lax.scan`` body,
in the same order and on the same dtypes; ``run`` loops over frames in
Python. Every decision inside a frame (first frame, map present, solve
accepted, keyframe) is a ``torch.where`` on the device, so a frame never
waits on the host. Frame 0 searches an all-invalid map, as in JAX.
"""

from typing import NamedTuple

import torch
from torch import nn

from ..config import GlioConfig
from ..lidar import neighbors, plane_fit
from ..ops.knn import knn
from ..solver import dense
from ..utils import quat

F64 = torch.float64
F32 = torch.float32


class OdomCarry(NamedTuple):
    p: torch.Tensor               # (3,) current absolute pose
    q: torch.Tensor               # (4,)
    rel_p: torch.Tensor           # (3,) last inter-frame relative motion
    rel_q: torch.Tensor           # (4,)
    kf_p: torch.Tensor            # (3,) last keyframe pose
    kf_q: torch.Tensor            # (4,)
    map_scans: torch.Tensor       # (W, S, 3) f32 keyframe clouds (body frame)
    map_valid: torch.Tensor       # (W, S)
    map_p: torch.Tensor           # (W, 3)
    map_q: torch.Tensor           # (W, 4)
    map_slot_valid: torch.Tensor  # (W,)
    map_head: torch.Tensor        # () int32
    frames_since_kf: torch.Tensor  # () int32
    frame_count: torch.Tensor     # () int32


class OdomOutput(NamedTuple):
    p: torch.Tensor
    q: torch.Tensor
    rel_p: torch.Tensor           # relative to the previous frame
    rel_q: torch.Tensor
    is_keyframe: torch.Tensor
    n_matches: torch.Tensor


class Pose(NamedTuple):
    p: torch.Tensor
    q: torch.Tensor


def _retract(x: Pose, dx):
    return Pose(x.p + dx[:3], quat.normalize(quat.mul(x.q, quat.exp(dx[3:6]))))


class LidarOdometry(nn.Module):
    """``make_odometry``'s ``run`` on ``device`` (also ``forward``), with
    ``initial_carry`` and ``step`` to resume from any frame."""

    def __init__(self, cfg: GlioConfig, device):
        super().__init__()
        lo = cfg.lidar_odometry
        self.lo = lo
        self.W = lo.local_map_frames
        self.S = cfg.shapes.scan_points
        # Budget for the 0.2 m-voxelled local map (the raw ring is W·S).
        self.map_ds = min(self.W * self.S, cfg.shapes.map_points)
        self.rounds = max(2, lo.scan_match_cnt)
        self.device = torch.device(device)

    def initial_carry(self, p0=None, q0=None) -> OdomCarry:
        W, S, dev = self.W, self.S, self.device
        ident = torch.tensor([1.0, 0, 0, 0], dtype=F64, device=dev)
        zero3 = torch.zeros(3, dtype=F64, device=dev)
        i32 = torch.zeros((), dtype=torch.int32, device=dev)
        return OdomCarry(
            p=zero3 if p0 is None else torch.as_tensor(p0, dtype=F64, device=dev),
            q=ident if q0 is None else torch.as_tensor(q0, dtype=F64, device=dev),
            rel_p=zero3, rel_q=ident, kf_p=zero3, kf_q=ident,
            map_scans=torch.zeros((W, S, 3), dtype=F32, device=dev),
            map_valid=torch.zeros((W, S), dtype=torch.bool, device=dev),
            map_p=torch.zeros((W, 3), dtype=F64, device=dev),
            map_q=ident.expand(W, 4).clone(),
            map_slot_valid=torch.zeros((W,), dtype=torch.bool, device=dev),
            map_head=i32, frames_since_kf=i32, frame_count=i32)

    def _icp_round(self, x: Pose, scan, scan64, scan_valid, map_flat, mv_flat, have_map):
        """Associate at ``x``, fit planes, solve 6-dof; returns (pose, n_good)."""
        world_q = (quat.rotate(x.q, scan64) + x.p).to(F32)
        _, idx = knn(world_q, scan_valid, map_flat, mv_flat, k=5)
        neigh = neighbors.gather_neighbors(map_flat, idx)
        neigh_ok = idx >= 0
        fit = plane_fit.fit_planes(neigh, neigh_ok, world_q, plane_tol=0.06)
        good = (fit.valid & scan_valid & (fit.weight > 0.4)
                & neigh_ok.all(dim=-1) & have_map)
        normal, d_pl = fit.normal.to(F64), fit.d.to(F64)

        def residual(s: Pose):
            pw = quat.rotate(s.q, scan64) + s.p
            r = torch.sum(normal * pw, dim=-1) + d_pl
            r = torch.where(good, r, torch.zeros_like(r))
            return r * dense.huber_weight(r, 0.1)

        out = dense.lm_solve(residual, _retract, x, 6, max_iters=self.lo.max_num_iter)
        n_good = good.sum()
        ok = torch.isfinite(out.x.p).all() & (n_good > 10) & have_map
        pose = Pose(torch.where(ok, out.x.p, x.p), torch.where(ok, out.x.q, x.q))
        return pose, n_good.to(torch.int32)

    def step(self, c: OdomCarry, scan, scan_valid):
        """One frame: (new carry, OdomOutput of this frame)."""
        lo, W, S = self.lo, self.W, self.S
        first = c.frame_count == 0

        # 1. Constant-motion prediction (poseInitialization).
        p_pred = torch.where(first, c.p, c.p + quat.rotate(c.q, c.rel_p))
        q_pred = torch.where(first, c.q, quat.normalize(quat.mul(c.q, c.rel_q)))

        # 2. The map in the world, in f64 then cast; voxelled at 0.2 m
        # (downSampleCloud, LidarOdometry.cpp:306-314) when the raw ring
        # exceeds the search budget.
        map_world = (quat.rotate(c.map_q[:, None, :], c.map_scans.to(F64))
                     + c.map_p[:, None, :]).to(F32).reshape(W * S, 3)
        mv = (c.map_valid & c.map_slot_valid[:, None]).reshape(W * S)
        if W * S > self.map_ds:
            map_flat, mv_flat = neighbors.voxel_downsample(
                map_world, mv, lo.voxel_size, self.map_ds, scatter_keys=True)
        else:
            map_flat, mv_flat = map_world, mv
        have_map = mv_flat.any()

        # 3-4. ICP rounds from the prediction; n_matches is the last round's.
        scan64 = scan.to(F64)
        x = Pose(p_pred, q_pred)
        for _ in range(self.rounds):
            x, n_good = self._icp_round(x, scan, scan64, scan_valid, map_flat, mv_flat, have_map)
        p_new, q_new = x

        # 5. Relative motion against the previous frame.
        ident = torch.tensor([1.0, 0, 0, 0], dtype=F64, device=self.device)
        rel_p = torch.where(first, torch.zeros_like(c.p), quat.rotate(quat.conj(c.q), p_new - c.p))
        rel_q = torch.where(first, ident, quat.normalize(quat.mul(quat.conj(c.q), q_new)))

        # 6. Keyframe decision (:566-578).
        d_kf = quat.norm(p_new - c.kf_p)
        a_kf = quat.norm(quat.log(quat.mul(quat.conj(c.kf_q), q_new)))
        is_kf = (first | (d_kf > lo.keyframe_dist_thresh) | (a_kf > lo.keyframe_angle_thresh)
                 | (c.frames_since_kf >= 2))

        # 7. Conditional insert into the map ring.
        slot = (c.map_head % W).reshape(1).long()

        def insert(ring, new):
            return torch.where(is_kf, ring.index_copy(0, slot, new[None]), ring)

        one = torch.ones((), dtype=torch.bool, device=self.device)
        new_c = OdomCarry(
            p=p_new, q=q_new, rel_p=rel_p, rel_q=rel_q,
            kf_p=torch.where(is_kf, p_new, c.kf_p), kf_q=torch.where(is_kf, q_new, c.kf_q),
            map_scans=insert(c.map_scans, scan), map_valid=insert(c.map_valid, scan_valid),
            map_p=insert(c.map_p, p_new), map_q=insert(c.map_q, q_new),
            map_slot_valid=insert(c.map_slot_valid, one),
            map_head=torch.where(is_kf, c.map_head + 1, c.map_head),
            frames_since_kf=torch.where(is_kf, torch.zeros_like(c.frames_since_kf),
                                        c.frames_since_kf + 1),
            frame_count=c.frame_count + 1)
        return new_c, OdomOutput(p_new, q_new, rel_p, rel_q, is_kf, n_good)

    def run_from(self, carry: OdomCarry, scans, scans_valid):
        """Frames (N, S, 3) f32 / (N, S) from ``carry``: (final carry,
        OdomOutput stacked over frames)."""
        scans = torch.as_tensor(scans, device=self.device)
        scans_valid = torch.as_tensor(scans_valid, device=self.device)
        outs = []
        for i in range(scans.shape[0]):
            carry, out = self.step(carry, scans[i], scans_valid[i])
            outs.append(out)
        return carry, OdomOutput(*(torch.stack(a) for a in zip(*outs)))

    def run(self, scans, scans_valid, p0=None, q0=None) -> OdomOutput:
        return self.run_from(self.initial_carry(p0, q0), scans, scans_valid)[1]

    forward = run


def make_odometry(cfg: GlioConfig, device) -> LidarOdometry:
    """Counterpart of ``glio_tpu.models.lidar_odometry.make_odometry``: the
    returned module is ``run`` (``odo(scans, scans_valid, p0, q0)``)."""
    return LidarOdometry(cfg, device)
