"""Rasterizers of the control maps (the port's counterpart of
``versecrafter_tpu.geometry.rasterize``), on tensors that carry a batch of
frames as their leading dimension.

- Pixel (j, i) samples the scene at screen position (i + 0.5, j + 0.5), as
  pytorch3d's rasterizer does: a point at u = fx*x/z + cx lies in pixel
  floor(u).
- Point splatting: a z-buffer at native pixels (one stable sort of
  (frame, pixel, depth bits) keys; the first entry of each pixel's run is
  the front-most point, the lowest point index among equal depths), then a
  depth-aware radius pass over a (2f+1)^2 window in the JAX package's
  (dy, dx) order, keeping the first of equal depths.
- Ellipsoids are ray-cast analytically per pixel with Phong shading.

The 3x3 products are written as explicit fp32 multiply-adds, not matmuls,
so no TF32 setting can reach them (the JAX package runs them under
default_matmul_precision("highest")).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

BIG = 1e9

# pytorch3d's PointLights and Materials defaults (ambient, diffuse,
# specular, shininess); the light sits at the world origin
AMBIENT, DIFFUSE, SPECULAR, SHININESS = 0.5, 0.3, 0.2, 64.0


def mat3_apply(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3] (broadcast) as three fp32 multiply-adds per
    output, summed in the order j = 0, 1, 2."""
    return torch.stack([M[..., i, 0] * v[..., 0] + M[..., i, 1] * v[..., 1]
                        + M[..., i, 2] * v[..., 2] for i in range(3)], -1)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension (3) of a * b, in the order 0, 1, 2."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm3(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot3(x, x))[..., None]


def project_points(points: torch.Tensor, K: torch.Tensor, w2c: torch.Tensor):
    """points [N, 3] (world), w2c [F, 4, 4] -> (u, v, z), each [F, N]:
    pixel coordinates and camera depth."""
    R, t = w2c[:, None, :3, :3], w2c[:, None, :3, 3]
    pc = mat3_apply(R, points[None]) + t
    z = pc[..., 2]
    u = K[0, 0] * pc[..., 0] / z + K[0, 2]
    v = K[1, 1] * pc[..., 1] / z + K[1, 2]
    return u, v, z


def zbuffer_winners(pix: torch.Tensor, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """For candidate splats at flat pixel indices pix [M] (frame-major, in
    point-index order within a frame) with positive depths z [M]: (the
    pixel of each front-most splat, its position in the candidates). One
    stable sort of pix << 32 | float bits of z (positive floats order as
    their bits): among equal depths the lowest point index wins."""
    zbits = torch.clamp_min(z, 1e-9).view(torch.int32).long()
    sk, order = torch.sort((pix << 32) | zbits, stable=True)
    spix = sk >> 32
    first = torch.ones_like(spix, dtype=torch.bool)
    first[1:] = spix[1:] != spix[:-1]
    return spix[first], order[first]


def splat_points(points: torch.Tensor, colors: torch.Tensor, K: torch.Tensor,
                 w2c: torch.Tensor, height: int, width: int,
                 radius_px: float = 1.2, footprint: int = 1):
    """Render a point cloud into F frames.

    points [N, 3] (world), colors [N, 3] float 0..255, w2c [F, 4, 4].
    Returns (rgb [F, H, W, 3] float 0..255, depth [F, H, W] (0 where
    empty), mask [F, H, W] bool)."""
    nf = w2c.shape[0]
    hw = height * width
    u, v, z = project_points(points, K, w2c)
    valid = (z > 1e-6) & torch.isfinite(u) & torch.isfinite(v)
    uf, vf = torch.floor(u), torch.floor(v)
    inb = valid & (uf >= 0) & (uf < width) & (vf >= 0) & (vf < height)

    fi, ni = torch.nonzero(inb, as_tuple=True)
    pix = fi * hw + vf[fi, ni].long() * width + uf[fi, ni].long()
    win_pix, win = zbuffer_winners(pix, z[fi, ni])
    fw, nw = fi[win], ni[win]
    buf = torch.zeros(nf * hw, 6, dtype=torch.float32, device=points.device)
    buf[win_pix] = torch.cat([torch.stack([z[fw, nw], u[fw, nw], v[fw, nw]], -1),
                              colors[nw]], -1)

    # the radius pass: each pixel takes the front-most splat of its
    # neighbourhood whose (subpixel) centre lies within radius_px of the
    # pixel's sample point; zero padding leaves the outside unoccupied
    f = footprint
    buf = F.pad(buf.view(nf, height, width, 6).permute(0, 3, 1, 2), (f, f, f, f))
    xs = torch.arange(width, dtype=torch.float32, device=points.device) + 0.5
    ys = (torch.arange(height, dtype=torch.float32, device=points.device) + 0.5)[:, None]
    r = torch.tensor(radius_px, dtype=torch.float32)
    r2 = float(r * r)
    best_z = torch.full((nf, height, width), BIG, dtype=torch.float32, device=points.device)
    best_c = torch.zeros(nf, 3, height, width, dtype=torch.float32, device=points.device)
    for dy in range(-f, f + 1):
        for dx in range(-f, f + 1):
            nb = buf[:, :, f - dy:f - dy + height, f - dx:f - dx + width]  # splat at -(dy, dx)
            zs, us, vs = nb[:, 0], nb[:, 1], nb[:, 2]
            d2 = (us - xs) ** 2 + (vs - ys) ** 2
            ok = (zs > 0) & (d2 <= r2)
            closer = torch.where(ok, zs, BIG) < best_z
            best_z = torch.where(closer, zs, best_z)
            best_c = torch.where(closer[:, None], nb[:, 3:6], best_c)

    mask = best_z < BIG * 0.5
    depth = torch.where(mask, best_z, 0.0)
    rgb = torch.where(mask[..., None], best_c.permute(0, 2, 3, 1), 0.0)
    return rgb, depth, mask


def ellipsoid_cam_params(means, covs, w2c, scale_factor=2.5):
    """World-frame Gaussians (means [F, k, 3], covs [F, k, 3, 3]) ->
    camera-frame centres [F, k, 3] and quadric matrices A [F, k, 3, 3] of
    the ellipsoids (x - c)^T A (x - c) = 1 whose semi-axes are
    scale_factor * sqrt(eigenvalues)."""
    R, t = w2c[:, None, :3, :3], w2c[:, None, :3, 3]
    c_cam = mat3_apply(R, means) + t
    # R C R^T, each entry a sum of fp32 products in a fixed order
    rc = torch.stack([mat3_apply(covs.transpose(-1, -2), R[..., i, :]) for i in range(3)], -2)
    cov_cam = torch.stack([mat3_apply(rc, R[..., m, :]) for m in range(3)], -1)
    evals, evecs = torch.linalg.eigh(cov_cam)
    axes2 = (scale_factor ** 2) * torch.clamp_min(evals, 1e-8)
    scaled = evecs * (1.0 / axes2)[..., None, :]  # V diag(1 / axes2)
    A = torch.stack([mat3_apply(scaled, evecs[..., l, :]) for l in range(3)], -1)
    return c_cam, A


def raster_ellipsoids(means: torch.Tensor, covs: torch.Tensor, colors: torch.Tensor,
                      present: torch.Tensor, K: torch.Tensor, w2c: torch.Tensor,
                      height: int, width: int, scale_factor: float = 2.5):
    """Ray-cast k ellipsoids into F frames.

    means [F, k, 3], covs [F, k, 3, 3] (world), colors [k, 3] 0..1, present
    [F, k] bool. Returns (rgb [F, H, W, 3] float 0..255, depth [F, H, W],
    mask [F, H, W])."""
    dev = means.device
    c_cam, A = ellipsoid_cam_params(means, covs, w2c, scale_factor)
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5 - K[0, 2]) / K[0, 0]
    ys = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5 - K[1, 2]) / K[1, 1]
    dirs = torch.stack([xs[None].expand(height, width), ys[:, None].expand(height, width),
                        torch.ones(height, width, device=dev)], -1)  # [H, W, 3]

    # a t^2 + b t + cc = 0 along the ray t * dir from the camera, per
    # (frame, ellipsoid, pixel)
    Ab = A[:, :, None, None]                                        # [F, k, 1, 1, 3, 3]
    Ad = mat3_apply(Ab, dirs)                                       # [F, k, H, W, 3]
    a = dot3(dirs, Ad)
    Ac = mat3_apply(A, c_cam)                                       # [F, k, 3]
    b = -2.0 * dot3(dirs, Ac[:, :, None, None])
    cc = (dot3(c_cam, Ac) - 1.0)[:, :, None, None]
    del Ad
    disc = b * b - 4 * a * cc
    hit = present[:, :, None, None] & (disc > 0)
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = (-b - sq) / (2 * a)
    t1 = (-b + sq) / (2 * a)
    del a, b, sq, disc
    tt = torch.where(t0 > 1e-6, t0, t1)
    hit = hit & (tt > 1e-6)
    depths = torch.where(hit, dirs[..., 2] * tt, BIG)              # [F, k, H, W]

    kmin = torch.argmin(depths, dim=1, keepdim=True)                # [F, 1, H, W]
    depth = torch.gather(depths, 1, kmin)[:, 0]
    mask = depth < BIG * 0.5
    # the normal of the front-most ellipsoid only: A (p - c) at its hit
    tk = torch.gather(tt, 1, kmin)[:, 0]
    del depths, tt, t0, t1, hit
    kf = kmin[:, 0]
    fidx = torch.arange(means.shape[0], device=dev)[:, None, None]
    pk = dirs * tk[..., None]
    nrm = mat3_apply(A[fidx, kf], pk - c_cam[fidx, kf])
    nrm = nrm / torch.clamp_min(_norm3(nrm), 1e-12)
    base = colors[kf]                                               # [F, H, W, 3]
    # flip the normal toward the viewer
    p = dirs * depth[..., None]
    view = -p / torch.clamp_min(_norm3(p), 1e-12)
    nrm = torch.where(dot3(nrm, view)[..., None] < 0, -nrm, nrm)
    ldir = w2c[:, None, None, :3, 3] - p   # the light at the world origin
    ldir = ldir / torch.clamp_min(_norm3(ldir), 1e-12)
    ndl = torch.clamp_min(dot3(nrm, ldir), 0.0)
    refl = 2 * ndl[..., None] * nrm - ldir
    rdv = torch.clamp_min(dot3(refl, view), 0.0)
    spec = SPECULAR * torch.pow(rdv, SHININESS)
    shaded = base * (AMBIENT + DIFFUSE * ndl[..., None]) + spec[..., None]

    rgb = torch.where(mask[..., None], torch.clamp(shaded, 0, 1) * 255.0, 0.0)
    depth = torch.where(mask, depth, 0.0)
    return rgb, depth, mask


# -- compositing (the reference's semantics) --------------------------------

def composite_take(bg_depth, fg_depth, fg_mask):
    """Where the foreground wins: it exists and is closer (epsilon-tested)."""
    return fg_mask & ((bg_depth <= 0) | ((fg_depth > 0) & (fg_depth < bg_depth - 1e-6)))


def composite_by_depth(bg_rgb, bg_depth, fg_rgb, fg_depth, fg_mask):
    """The foreground over the background where composite_take holds."""
    take = composite_take(bg_depth, fg_depth, fg_mask)
    rgb = torch.where(take[..., None], fg_rgb, bg_rgb)
    depth = torch.where(take, fg_depth, bg_depth)
    return rgb, depth


def depth_to_grayscale(depth, min_depth, max_depth):
    """Disparity grayscale, closer is lighter: [..., H, W] float 0..255.
    min_depth / max_depth are fp32 scalars (0-dim tensors or floats);
    without a positive range the disparity is not normalised."""
    min_depth = torch.as_tensor(min_depth, dtype=torch.float32, device=depth.device)
    max_depth = torch.as_tensor(max_depth, dtype=torch.float32, device=depth.device)
    disp = torch.where(depth > 0, 1.0 / torch.clamp_min(depth, 1e-9), 0.0)
    min_disp = 1.0 / torch.clamp_min(max_depth, 1e-9)
    max_disp = 1.0 / torch.clamp_min(min_depth, 1e-9)
    norm = (disp - min_disp) / (max_disp - min_disp + 1e-8)
    disp = torch.where((max_depth > 0) & (min_depth > 0), norm, disp)
    return torch.clamp(disp, 0, 1) * 255.0


def merge_masks(bg_depth, fg_depth, bg_mask, fg_mask):
    """merged_mask: background holes are white, visible foreground is white."""
    take_fg = composite_take(bg_depth, fg_depth, fg_mask)
    return torch.where(take_fg, fg_mask, ~bg_mask)


def positive_quantiles(values: torch.Tensor) -> Tuple[float, float]:
    """The 0.1 % and 99 % linear-interpolation quantiles (numpy's and
    jnp.nanquantile's 'linear' method: position q * (n - 1), interpolated
    between its floor and ceil) of the positive entries of `values`, from
    one sort on their device; (0.0, 1.0) when none is positive.
    torch.quantile refuses inputs above 2^24 elements; this takes any
    count. The position and the interpolation are float64 on the host, as
    numpy.quantile computes them."""
    vals = values.reshape(-1)
    vals = vals[vals > 0]
    n = vals.numel()
    if n == 0:
        return 0.0, 1.0
    svals = torch.sort(vals.float()).values
    out = []
    for q in (0.001, 0.99):
        pos = q * (n - 1)
        lo = int(pos // 1)
        hi = min(lo + 1, n - 1)
        a, b = (float(x) for x in svals[[lo, hi]].cpu())
        w = pos - lo
        # numpy's _lerp: a + (b - a) * w, from the upper end when w >= 0.5
        out.append(b - (b - a) * (1 - w) if w >= 0.5 else a + (b - a) * w)
    return tuple(out)
