"""Video and image IO, with the port's own codecs (no OpenCV).

The port's copy of ``versecrafter_tpu.utils.video``, with the same functions
and contract: mp4 -> [1, 3, T, H, W] float32 in [0, 1] resampled to a target
fps and frame count, images with an aspect-preserving resize and centre
crop, and mp4 / png writing. Arrays are numpy; the pipeline moves them to
the device.

Files are read and written by utils/mp4.py (ISO base media), utils/mpeg4.py
(MPEG-4 Part 2, the `mp4v` that OpenCV writes), utils/jpeg.py and
utils/png.py, and resized by utils/imgproc.py. On the files OpenCV writes
(and on baseline JPEG and PNG generally) they give the arrays the JAX
package's OpenCV calls give, bit for bit; JPEGs may be baseline or
progressive, grey, YCbCr or Adobe CMYK. mp4s other than `mp4v` (H.264,
HEVC, ...) raise ValueError naming the format.
`save_video` writes I-VOPs at a fixed quantiser, so its files are larger
than OpenCV's and at least as close to the frames (tests/test_torch_media.py);
like OpenCV's writer it drops an odd last row or column.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from versecrafter_tpu_torch.utils import imgproc, jpeg, mp4, mpeg4, png


def read_image(path: str, gray: bool = False) -> np.ndarray:
    """cv2.imread(path, IMREAD_COLOR) in RGB order as uint8 [H, W, 3], or
    IMREAD_GRAYSCALE as [H, W], for a PNG or JPEG file."""
    with open(path, "rb") as f:
        buf = f.read()
    if png.is_png(buf):
        return png.decode(buf, "gray" if gray else "color")
    if jpeg.is_jpeg(buf):
        return jpeg.decode(buf, gray=gray)
    raise ValueError(f"{path}: not a PNG or JPEG file")


def write_png(path: str, img: np.ndarray) -> None:
    """uint8 [H, W] or [H, W, 3] RGB -> png (cv2.imwrite's bytes)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(png.encode(np.ascontiguousarray(img, np.uint8)))


def read_frames(path: str, fps: Optional[float] = None,
                num_frames: Optional[int] = None) -> Tuple[np.ndarray, float]:
    """The frames of an mp4 as uint8 [T, H, W, 3] RGB, and its fps as
    cv2.CAP_PROP_FPS reports it. Where load_video keeps the first
    `num_frames` at the source rate (no `fps`, or the source's), only those
    are decoded."""
    with open(path, "rb") as f:
        buf = f.read()
    track = mp4.parse(buf)
    src_fps = track.fps or 30.0
    same_rate = fps is None or abs(src_fps - fps) <= 1e-3
    keep = num_frames if same_rate and num_frames is not None else None
    return mpeg4.decode(buf, track, max_frames=keep), track.fps


def _resize_center_crop(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Resize so the image covers (H, W), then centre-crop to it."""
    th, tw = size
    h, w = img.shape[:2]
    scale = max(th / h, tw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    img = imgproc.resize(img, (nw, nh),
                         imgproc.INTER_AREA if scale < 1 else imgproc.INTER_LINEAR)
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
    decoded, src_fps = read_frames(path, fps, num_frames)
    src_fps = src_fps or 30.0
    frames: List[np.ndarray] = list(decoded)
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
    img = read_image(path)
    if size is not None:
        img = _resize_center_crop(img, size)
    arr = img.astype(np.float32) / 255.0
    return arr.transpose(2, 0, 1)[None, :, None]


def save_video(video: np.ndarray, path: str, fps: int = 16) -> None:
    """[T, H, W, 3] uint8 or float in [0, 1] (or [1, 3, T, H, W] float) ->
    mp4 (MPEG-4 Part 2 I-VOPs, `mp4v`)."""
    if video.ndim == 5:
        video = video[0].transpose(1, 2, 3, 0)
    t, h, w, _ = video.shape
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    frames = (video if video.dtype == np.uint8
              else (np.clip(video, 0, 1) * 255).astype(np.uint8))
    frames = frames[:, :h & ~1, :w & ~1]
    dsi, samples = mpeg4.encode(frames, fps)
    mp4.write(path, samples, dsi, w & ~1, h & ~1, fps)


def save_image(img: np.ndarray, path: str) -> None:
    """[H, W, 3] float in [0, 1] -> png."""
    write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
