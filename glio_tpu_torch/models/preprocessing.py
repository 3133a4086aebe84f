"""Scan preprocessing: ring-ordered range images → feature clouds (port of
``glio_tpu/models/preprocessing.py``).

The reference's ``Preprocessing`` node (``GLIO/src/Preprocessing.cpp``):
optional gyro deskew, LOAM curvature, sextant edge/flat picks, and the
less-flat points voxel-filtered at 0.4 m into the surf cloud that the
odometry and the window consume.

The surf cloud is ``voxel_downsample(..., 0.4, surf_out)`` without
``scatter_keys``, as in the JAX package: when a scan has more voxels than
``surf_out`` it keeps the voxels of lowest x-major key, so the surf cloud
loses the scan's high-x side. The port copies this.
"""

from typing import NamedTuple

import torch
from torch import nn

from ..config import GlioConfig
from ..lidar import features, neighbors


class ScanFeatures(NamedTuple):
    surf: torch.Tensor          # (S_out, 3) voxel-filtered less-flat points
    surf_valid: torch.Tensor    # (S_out,)
    edge: torch.Tensor          # (E_out, 3) sharp + less-sharp edge points
    edge_valid: torch.Tensor    # (E_out,)
    flat: torch.Tensor          # (F_out, 3) flat picks (for odometry)
    flat_valid: torch.Tensor    # (F_out,)


def _compact(points, mask, n_out):
    """The first ``n_out`` points of the mask in index order, then the rest:
    a stable sort of the mask, descending (the JAX package's
    ``argsort(-score, stable=True)[:n_out]``)."""
    _, idx = torch.sort(mask.to(torch.float32), descending=True, stable=True)
    idx = idx[:n_out]
    return points[idx], mask[idx]


class Preprocessor(nn.Module):
    """``make_preprocessor``'s ``process`` on ``device``: (points (R, P, 3),
    valid (R, P)) → ``ScanFeatures``. Inputs are moved to ``device``; the
    features run there and never move to another device."""

    def __init__(self, cfg: GlioConfig, device, surf_out: int = 2048,
                 edge_out: int = 512, flat_out: int = 512):
        super().__init__()
        lo = cfg.lidar_odometry
        self.deskew = lo.if_to_deskew
        self.params = features.FeatureParams(edge_threshold=lo.edge_threshold,
                                             surf_threshold=lo.surf_threshold)
        self.surf_out, self.edge_out, self.flat_out = surf_out, edge_out, flat_out
        self.device = torch.device(device)

    def forward(self, points, valid, rel_time=None, q_scan=None) -> ScanFeatures:
        """rel_time (R, P) / q_scan (4,) turn on gyro deskew when the
        config's ``if_to_deskew`` is set (the UrbanNav config leaves it off,
        config_urban_hk.yaml:21)."""
        points = torch.as_tensor(points, device=self.device)
        valid = torch.as_tensor(valid, device=self.device)
        if rel_time is not None and q_scan is not None and self.deskew:
            ident = torch.tensor([1.0, 0, 0, 0], dtype=points.dtype, device=self.device)
            points = features.deskew(points, torch.as_tensor(rel_time, device=self.device),
                                     torch.as_tensor(q_scan, device=self.device), ident)
        out = features.extract_features(points, valid, self.params)
        R, P = valid.shape
        flat_pts = points.reshape(R * P, 3)
        surf, surf_v = neighbors.voxel_downsample(flat_pts, out["less_flat"].reshape(R * P),
                                                  0.4, self.surf_out)   # Preprocessing voxel 0.4
        edge, edge_v = _compact(flat_pts, out["less_sharp"].reshape(R * P), self.edge_out)
        flat, flat_v = _compact(flat_pts, out["flat"].reshape(R * P), self.flat_out)
        return ScanFeatures(surf, surf_v, edge, edge_v, flat, flat_v)


def make_preprocessor(cfg: GlioConfig, device, surf_out: int = 2048,
                      edge_out: int = 512, flat_out: int = 512) -> Preprocessor:
    """Counterpart of ``glio_tpu.models.preprocessing.make_preprocessor``."""
    return Preprocessor(cfg, device, surf_out, edge_out, flat_out)
