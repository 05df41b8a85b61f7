"""A seeded synthetic scene for the renderer's checks: what a user's
preprocess step would hand it (an RGB image, its depth map, pixel
intrinsics, object masks) and what the Blender add-on exports (a camera
trajectory, per-frame 3D Gaussians). numpy only.

The view: a ground plane 1.5 below the camera and a back wall 20 ahead,
with four fronto-parallel boxes, one per object mask. The camera moves
forward and sideways and yaws by 0.25 rad over the clip. Of the four
Gaussians, object 1 is absent for the middle third of the clip, object 2
passes behind the camera (camera depth <= 0.5 after about a third), and
object 3 leaves the image sideways; all four move and turn.
"""

from __future__ import annotations

import numpy as np

from versecrafter_tpu_torch.geometry.coords import CV2BLENDER, opencv_w2c_to_blender_c2w

N_OBJECTS = 4


def _rot(axis: int, a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    i, j = [k for k in range(3) if k != axis]
    r = np.eye(3)
    r[i, i], r[i, j], r[j, i], r[j, j] = c, -s, s, c
    return r


def synthetic_scene(height: int, width: int, frames: int, seed: int = 0) -> dict:
    """-> {"image" uint8 [H, W, 3], "depth" fp32 [H, W], "K" fp32 [3, 3] (pixels),
    "masks" bool [4, H, W], "c2w_blender" fp32 [T, 4, 4], "means" fp32
    [T, 4, 3], "covs" fp32 [T, 4, 3, 3], "present" bool [T, 4],
    "color_idx" [4]}; world coordinates are Blender's (Z up)."""
    rng = np.random.default_rng(seed)
    H, W, T = height, width, frames
    fx = fy = 0.8 * W
    K = np.array([[fx, 0, W / 2], [0, fy, H / 2], [0, 0, 1]], np.float32)
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    depth = np.full((H, W), 20.0)
    below = v > K[1, 2] + 1e-3
    depth[below] = np.minimum(20.0, 1.5 * fy / (v[below] - K[1, 2]))
    masks = np.zeros((N_OBJECTS, H, W), bool)
    for i in range(N_OBJECTS):  # boxes: [top, bottom) x [left, right) fractions
        t0, l0 = rng.uniform(0.25, 0.55), rng.uniform(0.05 + 0.22 * i, 0.12 + 0.22 * i)
        box = (slice(int(t0 * H), int((t0 + 0.25) * H)), slice(int(l0 * W), int((l0 + 0.12) * W)))
        masks[i][box] = True
        depth[box] = np.minimum(depth[box], rng.uniform(3.0, 8.0))
    depth *= 1 + 0.002 * rng.standard_normal((H, W))
    shade = 0.5 + 0.5 * np.sin(u / 7.0 + 2 * np.sin(v / 11.0))
    image = np.stack([shade, 1 - shade, np.full_like(shade, 0.5)], -1) * 200
    image += rng.uniform(0, 55, (H, W, 3))
    image[masks.any(0)] *= 0.5

    f = np.arange(T) / max(T - 1, 1)
    c2w = np.tile(np.eye(4), (T, 1, 1))
    for t in range(T):  # OpenCV camera axes in Blender world coordinates
        c2w[t, :3, :3] = CV2BLENDER @ _rot(1, 0.25 * f[t])
        c2w[t, :3, 3] = (0.8 * f[t], 1.5 * f[t], 0.0)
    c2w_blender = opencv_w2c_to_blender_c2w(np.linalg.inv(c2w))

    # Gaussians in Blender world coordinates (x right, y forward, z up)
    base = np.array([[-0.8, 5.0, 0.3], [0.6, 4.0, -0.4], [0.0, 3.0, 0.0], [0.3, 4.0, 0.5]])
    vel = np.array([[0.5, 0.3, 0.2], [-0.4, 0.5, 0.0], [0.0, -6.0, 0.0], [6.0, 0.0, 0.0]])
    scales = rng.uniform(0.15, 0.5, (N_OBJECTS, 3))
    axes = [_rot(2, rng.uniform(0, np.pi)) @ _rot(0, rng.uniform(0, np.pi))
            for _ in range(N_OBJECTS)]
    means = base[None] + f[:, None, None] * vel[None]
    covs = np.zeros((T, N_OBJECTS, 3, 3))
    for t in range(T):
        for k in range(N_OBJECTS):
            r = _rot(2, 0.6 * f[t] * (k + 1)) @ axes[k]
            covs[t, k] = r @ np.diag(scales[k] ** 2) @ r.T
    present = np.ones((T, N_OBJECTS), bool)
    present[(f >= 1 / 3) & (f < 2 / 3), 1] = False
    return {"image": np.clip(image, 0, 255).astype(np.uint8),
            "depth": depth.astype(np.float32), "K": K, "masks": masks,
            "c2w_blender": c2w_blender.astype(np.float32),
            "means": means.astype(np.float32), "covs": covs.astype(np.float32),
            "present": present, "color_idx": list(range(N_OBJECTS))}


def trajectory_json(scene: dict) -> dict:
    """The scene's Gaussians as custom_3D_gaussian_trajectory.json (the
    schema render.load_gaussian_trajectory reads); an absent object is left
    out of its frame."""
    T = len(scene["means"])
    return {
        "metadata": {"num_frames": T,
                     "obj_id_to_color_idx": {str(k): c for k, c in enumerate(scene["color_idx"])}},
        "frames": [{"frame_index": t, "objects": [
            {"object_id": k, "gaussian_3d": {"mean": scene["means"][t, k].tolist(),
                                             "covariance": scene["covs"][t, k].tolist()}}
            for k in range(len(scene["color_idx"])) if scene["present"][t, k]]}
            for t in range(T)]}
