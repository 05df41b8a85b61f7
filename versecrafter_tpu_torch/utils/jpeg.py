"""Baseline, extended sequential and progressive JPEG decoding through
csrc/host/jpeg.cpp.

`decode` gives the samples that OpenCV's imread gives (libjpeg-turbo's
defaults; Adobe CMYK converted as IMREAD_COLOR / IMREAD_GRAYSCALE convert
it), then applies the EXIF orientation as imread does. Lossless,
hierarchical, arithmetic-coded, 12-bit and YCCK files, and progressive
files that libjpeg-turbo would block-smooth (coefficients left unrefined,
as a truncated file leaves them) raise ValueError naming the kind.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from versecrafter_tpu_torch.kernels import _build

_P = ctypes.c_void_p


def _lib():
    lib = _build.load_host("jpeg")
    if not getattr(lib, "_typed", False):
        lib.jpg_last_error.restype = ctypes.c_char_p
        lib.jpg_info.argtypes = [_P, ctypes.c_int64] + [ctypes.POINTER(ctypes.c_int)] * 3
        lib.jpg_decode.argtypes = [_P, ctypes.c_int64, _P, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int]
        lib._typed = True
    return lib


def is_jpeg(buf: bytes) -> bool:
    return buf[:2] == b"\xff\xd8"


def exif_orientation(buf: bytes) -> int:
    """The EXIF Orientation tag (0x0112) of IFD0 in the APP1 segment, or 1."""
    pos = 2
    while pos + 4 <= len(buf) and buf[pos] == 0xFF:
        marker = buf[pos + 1]
        if marker in (0xD9, 0xDA):
            break
        length = struct.unpack_from(">H", buf, pos + 2)[0]
        seg = buf[pos + 4:pos + 2 + length]
        if marker == 0xE1 and seg[:6] == b"Exif\0\0":
            tiff = seg[6:]
            end = {b"II": "<", b"MM": ">"}.get(tiff[:2])
            if end is None or len(tiff) < 8:
                return 1
            ifd = struct.unpack_from(end + "I", tiff, 4)[0]
            if ifd + 2 > len(tiff):
                return 1
            count = struct.unpack_from(end + "H", tiff, ifd)[0]
            for i in range(count):
                off = ifd + 2 + 12 * i
                if off + 12 > len(tiff):
                    break
                tag, typ = struct.unpack_from(end + "HH", tiff, off)
                if tag == 0x0112 and typ == 3:
                    value = struct.unpack_from(end + "H", tiff, off + 8)[0]
                    return value if 1 <= value <= 8 else 1
            return 1
        pos += 2 + length
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """Rotate / flip [H, W, ...] to the visual orientation, as OpenCV's
    ExifTransform does for the eight values."""
    if orientation in (5, 6, 7, 8):
        img = np.swapaxes(img, 0, 1)
    if orientation in (2, 6):
        img = img[:, ::-1]
    elif orientation in (3, 7):
        img = img[::-1, ::-1]
    elif orientation in (4, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def decode(buf: bytes, gray: bool = False) -> np.ndarray:
    """uint8 [H, W, 3] RGB, or [H, W] with `gray`, in the EXIF orientation."""
    lib = _lib()
    data = np.frombuffer(buf, np.uint8)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.jpg_info(data.ctypes.data_as(_P), len(data), ctypes.byref(w), ctypes.byref(h),
                    ctypes.byref(c)) != 0:
        raise ValueError(lib.jpg_last_error().decode())
    out = np.empty((h.value, w.value) if gray else (h.value, w.value, 3), np.uint8)
    if lib.jpg_decode(data.ctypes.data_as(_P), len(data), out.ctypes.data_as(_P), w.value,
                      h.value, int(gray)) != 0:
        raise ValueError(lib.jpg_last_error().decode())
    return apply_orientation(out, exif_orientation(buf))
