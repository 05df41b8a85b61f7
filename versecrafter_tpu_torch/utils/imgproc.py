"""The image operations the port's call sites took from OpenCV, in numpy,
equal to OpenCV's on uint8 images.

- `resize`: INTER_LINEAR (`resize_linear`, which models/clip uses too), INTER_NEAREST
  (floor(x * src / dst)), and INTER_AREA: for an exact 2x reduction
  OpenCV's fast path ((a + b + c + d + 2) >> 2), otherwise its float32
  area-weight tables (cv::computeResizeAreaTab) summed in its order, then
  rounded half to even. Where INTER_AREA does not reduce both axes it is
  OpenCV's linear resize with its area-mode fractions.
- `colormap_turbo`: cv2.COLORMAP_TURBO as a 256-entry RGB table.
- `rectangle`: an axis-aligned rectangle of thickness 2 (OpenCV's 3-pixel
  bands without their four outer corner pixels).
- `put_text`: FONT_HERSHEY_SIMPLEX at scale 0.5, thickness 1, from glyph
  coverage maps captured from cv2.putText and blended over the image;
  glyphs sit at whole-pixel advances, so a string can differ from OpenCV's
  inside its text box (and nowhere else).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from versecrafter_tpu_torch.utils import _media_tables

INTER_NEAREST, INTER_LINEAR, INTER_AREA = "nearest", "linear", "area"

TURBO = np.frombuffer(_media_tables.TURBO, np.uint8).reshape(256, 3)


# ---------------------------------------------------------------------------
# OpenCV's linear resize in numpy
# ---------------------------------------------------------------------------

def _coords(dst: int, src: int, fixed_point: bool):
    """(first source index, fraction as float32) of each output pixel of a
    half-pixel-centred linear resize. The fixed-point path forms the
    coordinate in float32 as OpenCV's generic resize does; the float path
    keeps it in float64 and rounds only the fraction."""
    if fixed_point:
        scale = 1.0 / (np.float64(dst) / np.float64(src))
        f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
        s = np.floor(f).astype(np.int64)
        return s, (f - s.astype(np.float32)).astype(np.float32)
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (np.float64(src) / dst) - 0.5
    s = np.floor(f).astype(np.int64)
    return s, (f - s).astype(np.float32)


def _clamp(s, f, n):
    """Indices outside [0, n - 2] take the edge pixel with weight 1."""
    f = np.where((s < 0) | (s >= n - 1), np.float32(0), f).astype(np.float32)
    return np.clip(s, 0, n - 1), f


def _fma32(a, b, c):
    """fp32 a * b + c with one rounding (the float64 product is exact)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _area_up_coords(dst: int, src: int):
    """cv2.INTER_AREA's coordinates where it does not reduce both axes: a
    linear resize whose fraction is ((d + 1) - (s + 1) * dst / src) mod 1,
    s = floor(d * src / dst)."""
    inv = np.float64(dst) / np.float64(src)
    scale = 1.0 / inv
    d = np.arange(dst, dtype=np.float64)
    s = np.floor(d * scale).astype(np.int64)
    f = ((d + 1) - (s + 1) * inv).astype(np.float32).astype(np.float64)
    f = np.where(f <= 0, 0.0, f - np.floor(f)).astype(np.float32)
    return s, f


def _linear_u8(x: np.ndarray, cx, cy) -> np.ndarray:
    """OpenCV's fixed-point linear resize of uint8 [H, W, C] at the source
    coordinates cx / cy (index, float32 fraction) of the output columns /
    rows."""
    H, W = x.shape[:2]
    sx, fx = _clamp(*cx, W)
    sy, fy = cy
    x1 = np.minimum(sx + 1, W - 1)
    y0, y1 = np.clip(sy, 0, H - 1), np.clip(sy + 1, 0, H - 1)

    def weights(f):
        return (np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64),
                np.rint(f * np.float32(2048)).astype(np.int64))

    a0, a1 = weights(fx)
    b0, b1 = weights(fy)
    xs = x.astype(np.int64)
    d = xs[:, sx] * a0[None, :, None] + xs[:, x1] * a1[None, :, None]
    t = ((((d[y0] >> 4) * b0[:, None, None]) >> 16)
         + (((d[y1] >> 4) * b1[:, None, None]) >> 16))
    return np.clip((np.clip(t, -32768, 32767) + 2) >> 2, 0, 255).astype(np.uint8)


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, size) with the default INTER_LINEAR, for a uint8 or
    float32 [H, W] / [H, W, C] image and size = (width, height).

    uint8 is OpenCV's fixed-point path: 11-bit weights from the float32
    fractions, the horizontal pass in exact integers, the vertical one as
    its SIMD form computes it ((S >> 4) * beta >> 16 per row, a saturating
    add, then (t + 2) >> 2, saturated to 0..255). Rows outside the image
    repeat the edge row with their weights kept. float32 is the IPP path
    OpenCV takes there: each pass a + f * (b - a) as one fused multiply-add,
    edges clamped. Both are bit-exact to OpenCV's at 480x832 -> 224x224 and
    at an upscale (tests/test_torch_clip.py); the float path can differ by
    one ulp on some strong upscales of very narrow images."""
    w_out, h_out = int(size[0]), int(size[1])
    img = np.asarray(img)
    H, W = img.shape[:2]
    x = img.reshape(H, W, -1)
    if img.dtype == np.uint8:
        out = _linear_u8(x, _coords(w_out, W, True), _coords(h_out, H, True))
    elif img.dtype == np.float32:
        sx, fx = _clamp(*_coords(w_out, W, False), W)
        sy, fy = _clamp(*_coords(h_out, H, False), H)
        x1, y1 = np.minimum(sx + 1, W - 1), np.minimum(sy + 1, H - 1)
        a, b = x[:, sx], x[:, x1]
        d = _fma32(fx[None, :, None], b - a, a)
        c, e = d[sy], d[y1]
        out = _fma32(fy[:, None, None], e - c, c)
    else:
        raise TypeError(f"resize_linear takes uint8 or float32, got {img.dtype}")
    return out.reshape((h_out, w_out) + img.shape[2:])


# ---------------------------------------------------------------------------
# INTER_AREA, INTER_NEAREST and the rest
# ---------------------------------------------------------------------------

def _area_tab(ssize: int, dsize: int):
    """cv::computeResizeAreaTab as [dsize, slots] source indices and float32
    weights (unused slots weigh 0)."""
    scale = 1.0 / (dsize / ssize)
    rows = []
    for d in range(dsize):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, ssize - 1)
        s1 = min(s1, s2)
        ent = []
        if s1 - f1 > 1e-3:
            ent.append((s1 - 1, (s1 - f1) / cell))
        ent += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            ent.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(ent)
    slots = max(len(e) for e in rows)
    idx = np.zeros((dsize, slots), np.int64)
    wt = np.zeros((dsize, slots), np.float32)
    for d, ent in enumerate(rows):
        for j, (s, a) in enumerate(ent):
            idx[d, j], wt[d, j] = s, np.float32(a)
    return idx, wt


def _resize_area(x: np.ndarray, w: int, h: int) -> np.ndarray:
    H, W, _ = x.shape
    if W == 2 * w and H == 2 * h:
        s = x.astype(np.int32)
        s = s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    xf = x.astype(np.float32)
    xi, xw = _area_tab(W, w)
    buf = np.zeros((H, w, x.shape[2]), np.float32)
    for j in range(xi.shape[1]):
        buf = buf + xf[:, xi[:, j]] * xw[None, :, j, None]
    yi, yw = _area_tab(H, h)
    out = np.zeros((h, w, x.shape[2]), np.float32)
    for j in range(yi.shape[1]):
        out = out + yw[:, j, None, None] * buf[yi[:, j]]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize(img: np.ndarray, size: Tuple[int, int], interpolation: str = INTER_LINEAR
           ) -> np.ndarray:
    """cv2.resize(img, size, interpolation=...) for a uint8 [H, W] or
    [H, W, C] image; size = (width, height)."""
    w, h = int(size[0]), int(size[1])
    img = np.asarray(img)
    H, W = img.shape[:2]
    if (w, h) == (W, H):  # OpenCV copies at the same size, whatever the mode
        return img.copy()
    if interpolation == INTER_NEAREST:
        xs = np.minimum(np.floor(np.arange(w) * (W / w)).astype(np.int64), W - 1)
        ys = np.minimum(np.floor(np.arange(h) * (H / h)).astype(np.int64), H - 1)
        return np.ascontiguousarray(img[ys][:, xs])
    if interpolation == INTER_AREA:
        if img.dtype != np.uint8:
            raise TypeError(f"INTER_AREA takes uint8, got {img.dtype}")
        x = img.reshape(H, W, -1)
        out = (_resize_area(x, w, h) if w <= W and h <= H
               else _linear_u8(x, _area_up_coords(w, W), _area_up_coords(h, H)))
        return out.reshape((h, w) + img.shape[2:])
    if interpolation not in (INTER_LINEAR, INTER_AREA):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    return resize_linear(img, (w, h))


def colormap_turbo(gray: np.ndarray) -> np.ndarray:
    """uint8 [H, W] -> [H, W, 3] RGB through cv2.COLORMAP_TURBO."""
    return TURBO[np.asarray(gray, np.uint8)]


def rectangle(img: np.ndarray, p0, p1, color) -> None:
    """cv2.rectangle(img, p0, p1, color, 2) in place on [H, W] or [H, W, C]."""
    (x0, y0), (x1, y1) = (tuple(map(int, p0)), tuple(map(int, p1)))
    x0, x1 = min(x0, x1), max(x0, x1)
    y0, y1 = min(y0, y1), max(y0, y1)
    H, W = img.shape[:2]
    yy, xx = np.ogrid[:H, :W]
    in_x = (xx >= x0 - 1) & (xx <= x1 + 1)
    in_y = (yy >= y0 - 1) & (yy <= y1 + 1)
    band = (((np.abs(yy - y0) <= 1) | (np.abs(yy - y1) <= 1)) & in_x) | \
           (((np.abs(xx - x0) <= 1) | (np.abs(xx - x1) <= 1)) & in_y)
    corner = (((xx == x0 - 1) | (xx == x1 + 1)) & ((yy == y0 - 1) | (yy == y1 + 1)))
    img[band & ~corner] = color


def put_text(img: np.ndarray, text: str, org, color) -> None:
    """cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.5, color, 1) in
    place; org is the left end of the baseline."""
    H, W = img.shape[:2]
    x = float(org[0])
    for ch in text:
        adv, px = _media_tables.GLYPHS.get(ch, _media_tables.GLYPHS["?"])
        if px:
            p = np.asarray(px, np.int64)
            xs = p[:, 0] + int(round(x))
            ys = p[:, 1] + int(org[1])
            keep = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
            if not keep.any():  # the glyph lies outside the image
                x += adv
                continue
            xs, ys, a = xs[keep], ys[keep], p[keep, 2:3].astype(np.float32) / 255.0
            under = img[ys, xs].astype(np.float32).reshape(len(ys), -1)
            blend = under + (np.asarray(color, np.float32).reshape(1, -1) - under) * a
            img[ys, xs] = np.rint(blend).astype(img.dtype).reshape(img[ys, xs].shape)
        x += adv
