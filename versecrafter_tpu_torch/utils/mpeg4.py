"""MPEG-4 Part 2 Simple Profile video through csrc/host/mpeg4.cpp.

`decode` turns an mp4 track's samples into RGB frames exactly as OpenCV's
FFmpeg backend does (FFmpeg's decoder, then swscale's yuv420p -> bgr24);
`encode` writes I-VOPs at a fixed quantiser. Both run in C++ on one host
thread; the library builds at first use (kernels/_build.build_host).
"""

from __future__ import annotations

import ctypes
from fractions import Fraction
from typing import List, Optional, Tuple

import numpy as np

from versecrafter_tpu_torch.kernels import _build
from versecrafter_tpu_torch.utils import mp4

# The encoder's quantiser: the largest at which the port's PSNR is at least
# that of OpenCV's mp4v writer on the same frames, on every clip of
# scripts/mpeg4_qp_sweep.py (tests/test_torch_media.py measures both).
QP = 4

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def _lib():
    lib = _build.load_host("mpeg4")
    if not getattr(lib, "_typed", False):
        lib.m4v_last_error.restype = ctypes.c_char_p
        lib.m4v_probe.argtypes = [_P, _I64, _P, _I64, ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)]
        lib.m4v_decode.argtypes = [_P, _I64, _P, _P, _P, _I64, _P, _I64, ctypes.c_int,
                                   ctypes.c_int]
        lib.m4v_decode.restype = _I64
        lib.m4v_encode.argtypes = [_P, _I64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, _P, ctypes.POINTER(_I64), _P,
                                   _I64, _P]
        lib.m4v_encode.restype = _I64
        lib._typed = True
    return lib


def _error(lib) -> str:
    return lib.m4v_last_error().decode()


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P)


def decode(buf: bytes, track: mp4.Track, max_frames: Optional[int] = None) -> np.ndarray:
    """The frames of `track` (parsed from the file bytes `buf`), the first
    `max_frames` of them if given: uint8 [T, H, W, 3] RGB."""
    lib = _lib()
    data = np.frombuffer(buf, np.uint8)
    dsi = np.frombuffer(track.dsi, np.uint8) if track.dsi else np.zeros(1, np.uint8)
    n = len(track.sizes)
    keep = n if max_frames is None else min(n, max(int(max_frames), 1))
    if n == 0:
        raise ValueError("mp4: the video track has no samples")
    offs = np.ascontiguousarray(track.offsets, np.int64)
    sizes = np.ascontiguousarray(track.sizes, np.int64)
    if (offs + sizes > len(data)).any():
        raise ValueError("mp4: a sample lies beyond the end of the file")
    w, h = ctypes.c_int(), ctypes.c_int()
    first = data[offs[0]:offs[0] + sizes[0]]
    if lib.m4v_probe(_ptr(dsi), len(track.dsi), _ptr(first), len(first), ctypes.byref(w),
                     ctypes.byref(h)) != 0:
        raise ValueError(_error(lib))
    W, H = w.value, h.value
    out = np.empty((keep, H, W, 3), np.uint8)
    got = lib.m4v_decode(_ptr(dsi), len(track.dsi), _ptr(data), _ptr(offs), _ptr(sizes), n,
                         _ptr(out), keep, W, H)
    if got < 0:
        raise ValueError(_error(lib))
    return out[:got]


def encode(frames: np.ndarray, fps: float) -> Tuple[bytes, List[bytes]]:
    """uint8 [T, H, W, 3] RGB -> (decoder-specific information, samples):
    one I-VOP per frame at quantiser QP."""
    lib = _lib()
    frames = np.ascontiguousarray(frames, np.uint8)
    t, h, w, c = frames.shape
    if c != 3:
        raise ValueError(f"encode takes [T, H, W, 3] RGB frames, got {frames.shape}")
    rate = Fraction(fps).limit_denominator(1001)  # VOP times tick at res / incr
    res, incr = rate.numerator, rate.denominator
    cap = t * (h * w * 6 + 4096) + 4096
    out = np.empty(cap, np.uint8)
    sizes = np.zeros(max(t, 1), np.int64)
    dsi = np.zeros(64, np.uint8)
    dsi_len = _I64()
    total = lib.m4v_encode(_ptr(frames), t, w, h, QP, res, incr, _ptr(dsi),
                           ctypes.byref(dsi_len), _ptr(out), cap, _ptr(sizes))
    if total < 0:
        raise ValueError(_error(lib))
    bounds = np.concatenate([[0], np.cumsum(sizes[:t])])
    samples = [out[bounds[i]:bounds[i + 1]].tobytes() for i in range(t)]
    return dsi[:dsi_len.value].tobytes(), samples
