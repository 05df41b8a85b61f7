"""Binary morphology with OpenCV's elliptical structuring element, in numpy.

The GPU machine has no OpenCV, so the background carve (pointcloud.py) and
the mask erosion (gaussians.py) use these instead of cv2.dilate / cv2.erode.
On a binary uint8 mask both give OpenCV's result bit for bit, borders
included: OpenCV's default border for morphology ignores the pixels
outside the image (-inf for dilate, +inf for erode).
"""

from __future__ import annotations

import numpy as np


def ellipse_kernel(k: int) -> np.ndarray:
    """cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k)) as a [k, k]
    uint8 array: row i spans c - dx .. c + dx with r = c = k // 2 and
    dx = round(c * sqrt((r^2 - (i - r)^2) / r^2)) (round half to even)."""
    r = c = k // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    out = np.zeros((k, k), np.uint8)
    for i in range(k):
        dy = i - r
        if abs(dy) > r:
            continue
        dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
        out[i, max(c - dx, 0):min(c + dx + 1, k)] = 1
    return out


def _morph(mask: np.ndarray, kernel: np.ndarray, dilate: bool) -> np.ndarray:
    """OR (dilate) or AND (erode) of the mask shifted by every element of
    the kernel: out[y, x] over src[y + i - ay, x + j - ax], the anchor
    (ay, ax) at the kernel's centre (k // 2), pixels outside the image
    left out."""
    src = np.asarray(mask) > 0
    h, w = src.shape
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    pad = np.full((h + kh - 1, w + kw - 1), not dilate, bool)
    pad[ay:ay + h, ax:ax + w] = src
    out = np.full((h, w), not dilate, bool)
    for i, j in zip(*np.nonzero(kernel)):
        win = pad[i:i + h, j:j + w]
        out = (out | win) if dilate else (out & win)
    return out


def dilate(mask: np.ndarray, k: int) -> np.ndarray:
    """cv2.dilate(mask, ellipse_kernel(k), iterations=1) > 0 of a binary
    mask, as bool."""
    return _morph(mask, ellipse_kernel(k), dilate=True)


def erode(mask: np.ndarray, k: int) -> np.ndarray:
    """cv2.erode(mask, ellipse_kernel(k), iterations=1) > 0 of a binary
    mask, as bool."""
    return _morph(mask, ellipse_kernel(k), dilate=False)
