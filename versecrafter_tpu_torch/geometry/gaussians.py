"""3D Gaussian fit from depth and segmentation masks (the port's copy of
``versecrafter_tpu.geometry.gaussians``).

mask (eroded) -> world points -> sample mean and covariance with a 1e-6
ridge; process_single_image writes the gaussian_params.json schema that the
renderer and the Blender add-on read. numpy on the host; the erosion is
morphology.py's, and only the mask file reads need OpenCV.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from versecrafter_tpu_torch.geometry.coords import denormalize_intrinsics
from versecrafter_tpu_torch.geometry.morphology import erode
from versecrafter_tpu_torch.geometry.pointcloud import unproject_depth
from versecrafter_tpu_torch.utils.video import _cv2


def fit_gaussian(points: np.ndarray) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """[N, 3] -> (mean [3], cov [3, 3] with a 1e-6 ridge); (None, None)
    below 3 points."""
    if len(points) < 3:
        return None, None
    mean = points.mean(0)
    c = points - mean
    cov = (c.T @ c) / (len(points) - 1) + 1e-6 * np.eye(3)
    return mean.astype(np.float32), cov.astype(np.float32)


def load_mask_eroded(mask_path: str, erode_kernel: int = 5) -> Optional[np.ndarray]:
    """A mask png -> bool [H, W], eroded by an elliptical erode_kernel;
    None when the file does not read."""
    cv2 = _cv2()
    m = cv2.imread(mask_path, cv2.IMREAD_GRAYSCALE)
    if m is None:
        return None
    return erode(m > 127, erode_kernel)


def fit_objects_from_depth(
    depth: np.ndarray,
    intrinsic: np.ndarray,
    masks: Dict[int, Tuple[str, np.ndarray]],
    min_points: int = 10,
) -> Dict[int, dict]:
    """depth [H, W] + pixel intrinsics + {obj_id: (label, bool mask)} ->
    per-object Gaussian parameters (the reference's JSON schema); objects
    with fewer than min_points points are left out."""
    h, w = depth.shape
    K = denormalize_intrinsics(intrinsic, w, h)
    pts_all = unproject_depth(depth.astype(np.float32), K)  # camera == world
    out = {}
    for obj_id, (label, mask) in sorted(masks.items()):
        pts = pts_all[mask.reshape(-1)]
        if len(pts) < min_points:
            continue
        mean, cov = fit_gaussian(pts)
        if mean is None:
            continue
        eigvals = np.linalg.eigvalsh(cov)
        out[obj_id] = {
            "label": label,
            "mean": mean.tolist(),
            "cov": cov.tolist(),
            "num_points": int(len(pts)),
            "num_mask_pixels": int(mask.sum()),
            "eigvals": eigvals.tolist(),
            "trace": float(np.trace(cov)),
        }
    return out


def process_single_image(npz_path: str, masks_dir: str, output_dir: str,
                         input_image_path: Optional[str] = None) -> dict:
    """The reference fit CLI's file contract: a MoGe npz + mask_{id}_{label}.png
    files -> <output_dir>/gaussian_params.json (also returned).
    input_image_path is accepted for the reference's signature and unused."""
    data = np.load(npz_path)
    depth = data["depth"].astype(np.float32)
    if depth.ndim == 3:
        depth = depth[0]
    K = data["intrinsic"].astype(np.float32)
    if K.ndim == 3:
        K = K[0]
    h, w = depth.shape
    K = denormalize_intrinsics(K, w, h)

    masks = {}
    for f in sorted(Path(masks_dir).glob("mask_*.png")):
        parts = f.stem.split("_")
        obj_id = int(parts[1])
        label = "_".join(parts[2:]) or f"object_{obj_id}"
        m = load_mask_eroded(str(f))
        if m is not None:
            masks[obj_id] = (label, m)

    params = fit_objects_from_depth(depth, K, masks)
    obj_id_to_color_idx = {oid: i for i, oid in enumerate(sorted(params))}

    out = {
        "image_info": {"resolution": [int(w), int(h)],
                       "depth_shape": list(depth.shape[:2])},
        "camera_info": {"intrinsic": K.tolist(),
                        "extrinsic": np.eye(4, dtype=np.float32).tolist()},
        "gaussian_params": params,
        "num_objects": len(params),
        "obj_id_to_color_idx": obj_id_to_color_idx,
    }
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "gaussian_params.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out
