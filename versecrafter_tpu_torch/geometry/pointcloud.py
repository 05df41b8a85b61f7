"""Depth unprojection and the background point cloud (the port's copy of
``versecrafter_tpu.geometry.pointcloud``).

Host arithmetic in numpy, in the JAX package's order, so the points are
bit-equal; the object masks are dilated by morphology.py (OpenCV's result
without OpenCV). Only the file reads of load_background_from_files need
OpenCV, imported at first use.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from versecrafter_tpu_torch.geometry.coords import CV2BLENDER, denormalize_intrinsics
from versecrafter_tpu_torch.geometry.morphology import dilate
from versecrafter_tpu_torch.utils.video import _cv2


def unproject_depth(depth: np.ndarray, K: np.ndarray,
                    w2c: Optional[np.ndarray] = None) -> np.ndarray:
    """[H, W] depth + pixel intrinsics -> [H*W, 3] points (OpenCV camera
    frame, or world with w2c): rays through integer pixel coordinates
    scaled by z-depth."""
    h, w = depth.shape
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    ones = np.ones_like(x)
    pix = np.stack([x, y, ones], 0).reshape(3, -1)
    pts_cam = (np.linalg.inv(K) @ pix) * depth.reshape(1, -1)
    if w2c is None:
        return pts_cam.T.astype(np.float32)
    c2w = np.linalg.inv(w2c)
    pts_h = np.concatenate([pts_cam, np.ones((1, pts_cam.shape[1]))], 0)
    return (c2w @ pts_h)[:3].T.astype(np.float32)


def build_background(
    image: np.ndarray,
    depth: np.ndarray,
    K: np.ndarray,
    object_masks: Optional[np.ndarray] = None,
    dilate_kernel: int = 10,
) -> Tuple[np.ndarray, np.ndarray]:
    """image [H, W, 3] uint8 + depth [H, W] + intrinsics (+ the combined
    object mask) -> (points [N, 3] in Blender world coordinates, colors
    [N, 3] uint8). The camera sits at the origin; object pixels (dilated by
    an elliptical dilate_kernel) and non-finite or extreme points are left
    out."""
    h, w = depth.shape
    K = denormalize_intrinsics(K, w, h)
    pts_cv = unproject_depth(depth.astype(np.float32), K)
    pts = pts_cv @ CV2BLENDER.T

    keep = np.ones(h * w, bool)
    if object_masks is not None:
        keep &= ~dilate(object_masks > 0, dilate_kernel).reshape(-1)

    keep &= np.isfinite(pts).all(1)
    keep &= (np.abs(pts) < 1e6).all(1)
    return pts[keep], image.reshape(-1, 3)[keep]


def load_background_from_files(png_path: str, npz_path: str, mask_dir: Optional[str],
                               dilate_kernel: int = 10):
    """The reference CLI's inputs (RGB png, MoGe depth npz with 'depth' and
    'intrinsic', a directory of per-object mask pngs) -> (points, colors,
    K in pixels, H, W)."""
    cv2 = _cv2()
    img = cv2.cvtColor(cv2.imread(png_path), cv2.COLOR_BGR2RGB)
    h, w = img.shape[:2]
    data = np.load(npz_path)
    depth = data["depth"].astype(np.float32)
    if depth.ndim == 3:
        depth = depth[0]
    K = denormalize_intrinsics(data["intrinsic"].astype(np.float32), w, h)

    combined = None
    if mask_dir is not None:
        combined = np.zeros((h, w), np.uint8)
        for f in sorted(Path(mask_dir).glob("*.png")):
            m = cv2.imread(str(f), cv2.IMREAD_GRAYSCALE)
            m = cv2.resize(m, (w, h), interpolation=cv2.INTER_NEAREST)
            combined |= (m > 127).astype(np.uint8)

    pts, cols = build_background(img, depth, K, combined, dilate_kernel)
    return pts, cols, K, h, w
