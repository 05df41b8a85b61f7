"""Video and image IO with OpenCV.

The port's own copy of ``versecrafter_tpu.utils.video``, with the same
OpenCV calls, so that on the same file both give the same arrays bit for
bit: mp4 -> [1, 3, T, H, W] float32 in [0, 1] resampled to a target fps and
frame count, images with an aspect-preserving resize and centre crop, and
mp4 / png writing. Arrays are numpy; the pipeline moves them to the device.

OpenCV (`cv2`) is imported when a function is first called, so the package
imports on a machine without it (the GPU machine has none); there every
function here raises ImportError. Nothing decodes or encodes in its place.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "mp4 and image IO needs OpenCV (the cv2 module), which is not "
            "installed here; the port decodes and encodes nothing without it"
        ) from e
    return cv2


def _resize_center_crop(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Resize so the image covers (H, W), then centre-crop to it."""
    cv2 = _cv2()
    th, tw = size
    h, w = img.shape[:2]
    scale = max(th / h, tw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    img = cv2.resize(img, (nw, nh),
                     interpolation=cv2.INTER_AREA if scale < 1 else cv2.INTER_LINEAR)
    top = (nh - th) // 2
    left = (nw - tw) // 2
    return img[top:top + th, left:left + tw]


def load_video(
    path: str,
    num_frames: Optional[int] = None,
    size: Optional[Tuple[int, int]] = None,
    fps: Optional[int] = None,
) -> np.ndarray:
    """mp4 -> [1, 3, T, H, W] float32 in [0, 1], RGB.

    With `fps`, frames are resampled from the source fps (every
    src_fps / fps-th frame); the clip is then cut or padded with its last
    frame to `num_frames`."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    src_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    frames: List[np.ndarray] = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")

    if fps is not None and abs(src_fps - fps) > 1e-3:
        idx = np.arange(0, len(frames), src_fps / fps).astype(int)
        idx = idx[idx < len(frames)]
        frames = [frames[i] for i in idx]

    if num_frames is not None:
        if len(frames) >= num_frames:
            frames = frames[:num_frames]
        else:
            frames = frames + [frames[-1]] * (num_frames - len(frames))

    if size is not None:
        frames = [_resize_center_crop(f, size) for f in frames]

    arr = np.stack(frames).astype(np.float32) / 255.0  # [T, H, W, 3]
    return arr.transpose(3, 0, 1, 2)[None]  # [1, 3, T, H, W]


def load_image(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """image -> [1, 3, 1, H, W] float32 in [0, 1], RGB."""
    cv2 = _cv2()
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if size is not None:
        img = _resize_center_crop(img, size)
    arr = img.astype(np.float32) / 255.0
    return arr.transpose(2, 0, 1)[None, :, None]


def save_video(video: np.ndarray, path: str, fps: int = 16) -> None:
    """[T, H, W, 3] uint8 or float in [0, 1] (or [1, 3, T, H, W] float) ->
    mp4 (OpenCV's mp4v writer, avc1 if mp4v does not open)."""
    cv2 = _cv2()
    if video.ndim == 5:
        video = video[0].transpose(1, 2, 3, 0)
    t, h, w, _ = video.shape
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    frames = (video if video.dtype == np.uint8
              else (np.clip(video, 0, 1) * 255).astype(np.uint8))
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"avc1"), fps, (w, h))
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()


def save_image(img: np.ndarray, path: str) -> None:
    """[H, W, 3] float in [0, 1] -> png."""
    cv2 = _cv2()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cv2.imwrite(path, cv2.cvtColor((np.clip(img, 0, 1) * 255).astype(np.uint8),
                                   cv2.COLOR_RGB2BGR))
