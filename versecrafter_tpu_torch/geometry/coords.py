"""Coordinate conventions (the port's copy of ``versecrafter_tpu.geometry.coords``).

- OpenCV camera: X right, Y down, Z forward; u = fx*X/Z + cx, v = fy*Y/Z + cy.
- Blender world (Z-up): X right, Y forward, Z up.
- Blender camera: looks down -Z with +Y up (hence the column flip when a
  Blender camera-to-world matrix becomes an OpenCV world-to-camera one).

Host-side trajectory math in numpy (float64 where the JAX package uses it),
so the port's matrices equal the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np

# Blender_X = CV_X, Blender_Y = CV_Z, Blender_Z = -CV_Y
CV2BLENDER = np.array([
    [1, 0, 0],
    [0, 0, 1],
    [0, -1, 0],
], dtype=np.float32)

BLENDER2CV = CV2BLENDER.T


def denormalize_intrinsics(K: np.ndarray, width: int, height: int) -> np.ndarray:
    """Intrinsics as MoGe writes them (normalized when fx or fy < 10) ->
    pixels."""
    K = np.array(K, np.float32)
    if abs(K[0, 0]) < 10 or abs(K[1, 1]) < 10:
        K = K.copy()
        K[0, 0] *= width
        K[1, 1] *= height
        K[0, 2] *= width
        K[1, 2] *= height
    return K


def blender_c2w_to_opencv_w2c(c2w_blender: np.ndarray) -> np.ndarray:
    """[T, 4, 4] Blender camera-to-world -> OpenCV world-to-camera: negate
    rotation columns 1:3 (the camera axes in OpenCV convention), then
    invert, in float64."""
    c2w = np.array(c2w_blender, np.float64).copy()
    c2w[..., :3, 1:3] *= -1
    return np.linalg.inv(c2w).astype(np.float32)


def opencv_w2c_to_blender_c2w(w2c: np.ndarray) -> np.ndarray:
    """Inverse of blender_c2w_to_opencv_w2c."""
    c2w = np.linalg.inv(np.array(w2c, np.float64))
    c2w[..., :3, 1:3] *= -1
    return c2w.astype(np.float32)
