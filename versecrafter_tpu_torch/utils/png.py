"""PNG reading and writing with zlib and numpy (scanline filters in
csrc/host/png.cpp).

`decode` reads bit depths 1/2/4/8/16; grey, grey + alpha, RGB, RGBA and
palette (with tRNS) images; Adam7 interlacing. It returns what OpenCV's
imread returns, in RGB order: `mode="color"` 8-bit RGB (16-bit samples keep
their high byte, alpha is dropped, grey is replicated), `mode="gray"` 8-bit
grey (colour through libpng's rgb_to_gray with OpenCV's weights). `encode`
writes 8-bit grey or RGB the way OpenCV's imwrite does by default (Sub
filter on every row, zlib level 1 with the RLE strategy, 8 KiB IDAT
chunks), so with the same zlib both write the same bytes.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from versecrafter_tpu_torch.kernels import _build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_P = ctypes.c_void_p


def is_png(buf: bytes) -> bool:
    return buf[:8] == SIGNATURE


def _lib():
    lib = _build.load_host("png")
    if not getattr(lib, "_typed", False):
        lib.png_last_error.restype = ctypes.c_char_p
        lib.png_unfilter.argtypes = [_P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
        lib._typed = True
    return lib


def _chunks(buf: bytes):
    pos = 8
    while pos + 8 <= len(buf):
        n, typ = struct.unpack_from(">I4s", buf, pos)
        if pos + 12 + n > len(buf):
            raise ValueError(f"PNG: chunk {typ!r} runs past the end of the file")
        yield typ, buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if typ == b"IEND":
            break


def samples(buf: bytes):
    """(uint16 [H, W, C] samples as stored, colour type, bit depth,
    palette [N, 3] or None, tRNS bytes or None)."""
    if not is_png(buf):
        raise ValueError("not a PNG file")
    ihdr = palette = trns = None
    idat = []
    for typ, data in _chunks(buf):
        if typ == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data)
        elif typ == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif typ == b"tRNS":
            trns = data
        elif typ == b"IDAT":
            idat.append(data)
    if ihdr is None:
        raise ValueError("PNG: no IHDR chunk")
    width, height, depth, ctype, comp, filt, interlace = ihdr
    if ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16) or comp or filt:
        raise ValueError(f"PNG: unsupported colour type {ctype} / bit depth {depth}")
    if ctype == 3 and palette is None:
        raise ValueError("PNG: palette image without a PLTE chunk")
    chans = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    out = np.zeros((height, width, chans), np.uint16)
    lib = _lib()
    if lib.png_unfilter(raw, len(raw), width, height, depth, chans, int(interlace),
                        out.ctypes.data_as(_P)):
        raise ValueError(lib.png_last_error().decode())
    return out, ctype, depth, palette, trns


def _to8(s: np.ndarray, depth: int) -> np.ndarray:
    if depth == 16:
        return (s >> 8).astype(np.uint8)
    if depth < 8:
        return (s * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return s.astype(np.uint8)


def _rgb_to_gray(rgb: np.ndarray, depth: int) -> np.ndarray:
    """libpng's png_do_rgb_to_gray with the weights OpenCV sets (0.299,
    0.587; in 1/32768: 9797, 19234, 3737): truncated for 8-bit samples,
    rounded at 16 bits and then cut to the high byte."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    if depth == 16:
        return ((9797 * r + 19234 * g + 3737 * b + 16384) >> 23).astype(np.uint8)
    return ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)


def decode(buf: bytes, mode: str = "color") -> np.ndarray:
    """uint8 [H, W, 3] RGB (`color`) or [H, W] (`gray`)."""
    s, ctype, depth, palette, _ = samples(buf)
    if ctype in (0, 4):
        g = _to8(s[..., 0], depth)
        return g if mode == "gray" else np.repeat(g[..., None], 3, axis=2)
    if ctype == 3:
        rgb, depth = palette[np.minimum(s[..., 0], len(palette) - 1)], 8
    else:
        rgb = s[..., :3]
    if mode == "gray":
        return _rgb_to_gray(rgb, depth)
    return np.ascontiguousarray(_to8(rgb, depth))


def _chunk(typ: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + typ + data
            + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))


def _optimize_cmf(z: bytearray, data_size: int) -> None:
    """libpng's optimize_cmf: the smallest zlib window that covers the data,
    written into the stream's header."""
    cmf = z[0]
    if data_size > 16384 or (cmf & 0x0F) != 8 or (cmf & 0xF0) > 0x70:
        return
    cinfo = cmf >> 4
    half = 1 << (cinfo + 7)
    if data_size > half:
        return
    while True:
        half >>= 1
        cinfo -= 1
        if not (cinfo > 0 and data_size <= half):
            break
    cmf = (cmf & 0x0F) | (cinfo << 4)
    z[0] = cmf
    flg = z[1] & 0xE0
    flg += 0x1F - ((cmf << 8) + flg) % 0x1F
    z[1] = flg


def encode(img: np.ndarray) -> bytes:
    """uint8 [H, W] grey or [H, W, 3] RGB -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"PNG encode takes uint8 [H, W] or [H, W, 3], got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    chans = 1 if img.ndim == 2 else 3
    rows = img.reshape(h, w * chans)
    sub = rows.copy()
    sub[:, chans:] = rows[:, chans:] - rows[:, :-chans]  # Sub filter (wraps mod 256)
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1).tobytes()
    c = zlib.compressobj(1, zlib.DEFLATED, 15, 8, zlib.Z_RLE)
    z = bytearray(c.compress(raw) + c.flush())
    _optimize_cmf(z, len(raw))
    out = [SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2 if chans == 3 else 0,
                                                  0, 0, 0))]
    for i in range(0, len(z), 8192):
        out.append(_chunk(b"IDAT", bytes(z[i:i + 8192])))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)
