"""EWA projection of 3D Gaussians to 2D density maps, and their
far-to-near over-compositing (the port's counterpart of
``versecrafter_tpu.geometry.splat``), on tensors with a leading frame
dimension.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from versecrafter_tpu_torch.geometry.rasterize import dot3, mat3_apply

# matplotlib's tab20 colours, indexed as the reference's get_object_color
TAB20 = np.array([
    (0.1216, 0.4667, 0.7059), (0.6824, 0.7804, 0.9098),
    (1.0000, 0.4980, 0.0549), (1.0000, 0.7333, 0.4706),
    (0.1725, 0.6275, 0.1725), (0.5961, 0.8745, 0.5412),
    (0.8392, 0.1529, 0.1569), (1.0000, 0.5961, 0.5882),
    (0.5804, 0.4039, 0.7412), (0.7725, 0.6902, 0.8353),
    (0.5490, 0.3373, 0.2941), (0.7686, 0.6118, 0.5804),
    (0.8902, 0.4667, 0.7608), (0.9686, 0.7137, 0.8235),
    (0.4980, 0.4980, 0.4980), (0.7804, 0.7804, 0.7804),
    (0.7373, 0.7412, 0.1333), (0.8588, 0.8588, 0.5529),
    (0.0902, 0.7451, 0.8118), (0.6196, 0.8549, 0.8980),
], np.float32)


def object_color(color_idx: int) -> np.ndarray:
    return TAB20[color_idx % 20]


def gaussian_density_maps(means: torch.Tensor, covs: torch.Tensor, present: torch.Tensor,
                          K: torch.Tensor, w2c: torch.Tensor, height: int, width: int):
    """means [F, k, 3] + covs [F, k, 3, 3] (world) -> (density [F, k, H, W]
    max-normalised per object, camera depth [F, k], valid [F, k]).
    Gaussians behind or near the camera (z <= 0.5) or with a huge projected
    covariance (det > 1e11) are dropped. The 2x2 determinant and inverse
    are closed forms."""
    dev = means.device
    R, t = w2c[:, None, :3, :3], w2c[:, None, :3, 3]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    mc = mat3_apply(R, means) + t                                    # [F, k, 3]
    rc = torch.stack([mat3_apply(covs.transpose(-1, -2), R[..., i, :]) for i in range(3)], -2)
    cc = torch.stack([mat3_apply(rc, R[..., m, :]) for m in range(3)], -1)
    xx, yy, zz = mc[..., 0], mc[..., 1], mc[..., 2]
    zero = torch.zeros_like(zz)
    zc = torch.clamp_min(zz, 1e-6)
    z2 = torch.clamp_min(zz * zz, 1e-9)
    # the perspective Jacobian [2, 3] and J cc J^T, entries summed j = 0..2
    J = torch.stack([torch.stack([fx / zc, zero, -fx * xx / z2], -1),
                     torch.stack([zero, fy / zc, -fy * yy / z2], -1)], -2)  # [F, k, 2, 3]
    jc = torch.stack([mat3_apply(cc.transpose(-1, -2), J[..., i, :]) for i in range(2)], -2)
    c2 = torch.stack([torch.stack([dot3(jc[..., i, :], J[..., m, :]) for m in range(2)], -1)
                      for i in range(2)], -2)
    c00 = c2[..., 0, 0] + 1e-6
    c01, c10 = c2[..., 0, 1], c2[..., 1, 0]
    c11 = c2[..., 1, 1] + 1e-6
    det = c00 * c11 - c01 * c10
    valid = present & (zz > 0.5) & (det <= 1e11)
    inv00, inv01, inv11 = c11 / det, -c01 / det, c00 / det
    mu = fx * xx / zz + cx
    mv = fy * yy / zz + cy

    def px(v):  # [F, k] -> [F, k, 1, 1]
        return v[..., None, None]
    du = torch.arange(width, dtype=torch.float32, device=dev) - px(mu)
    dv = torch.arange(height, dtype=torch.float32, device=dev)[:, None] - px(mv)
    mahal = du ** 2 * px(inv00) + 2 * du * dv * px(inv01) + dv ** 2 * px(inv11)
    coeff = 1.0 / (2 * math.pi * torch.sqrt(torch.clamp_min(det, 1e-12)))
    dens = px(coeff) * torch.exp(-0.5 * mahal)
    dens = torch.where(px(valid), dens, 0.0)
    dens = dens / px(torch.clamp_min(dens.amax(dim=(-2, -1)), 1e-8))
    return dens, zz, valid


def composite_gaussian_projections(means, covs, colors, present, K, w2c,
                                   height: int, width: int, threshold: float = 0.003):
    """Densities -> thresholded alphas -> over-compositing far to near
    (stable order of descending depth). colors [k, 3] float 0..1. Returns
    (rgb [F, H, W, 3] 0..1, alpha [F, H, W])."""
    dens, depth_z, valid = gaussian_density_maps(means, covs, present, K, w2c, height, width)
    thr = torch.tensor(threshold, dtype=torch.float32, device=dens.device)
    alphas = torch.clamp(torch.where(dens > thr, (dens - thr) / (1.0 - thr + 1e-8), 0.0),
                         0.0, 1.0)
    alphas = torch.where(valid[..., None, None], alphas, 0.0)

    order = torch.argsort(-torch.where(valid, depth_z, -math.inf), dim=1, stable=True)
    alphas = torch.gather(alphas, 1, order[..., None, None].expand_as(alphas))
    cols = colors[order]                                             # [F, k, 3]
    nf = means.shape[0]
    rgb = torch.zeros(nf, height, width, 3, device=dens.device)
    acc = torch.zeros(nf, height, width, device=dens.device)
    for j in range(alphas.shape[1]):
        a = alphas[:, j]
        rgb = cols[:, j, None, None] * a[..., None] + rgb * (1 - a[..., None])
        acc = a + acc * (1 - a)
    return torch.clamp(rgb, 0, 1), torch.clamp(acc, 0, 1)
