"""ISO base media (mp4) demuxer and muxer for one MPEG-4 Part 2 video track.

`read` walks ftyp / moov / trak / mdia / mdhd / hdlr / minf / stbl (stsd,
stts, stsc, stsz, stco or co64, stss) and returns the video track's
decoder-specific information (the `esds` headers), its samples and its
frame rate as FFmpeg reports it (time scale x samples / duration, or time
scale / delta when every delta is equal). A sample entry other than `mp4v`
raises ValueError naming it. `write` lays out ftyp, mdat and moov for
samples that are all sync samples.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, List, Optional

import numpy as np

@dataclass
class Track:
    codec: str            # the sample entry's four-character code
    width: int
    height: int
    fps: float
    dsi: bytes            # decoder-specific information (esds)
    offsets: np.ndarray   # int64 [n] sample offsets into the file
    sizes: np.ndarray     # int64 [n] sample sizes
    sync: Optional[np.ndarray]  # 1-based sync sample numbers, None if all


def _boxes(buf: bytes, start: int, end: int):
    off = start
    while off + 8 <= end:
        size, typ = struct.unpack_from(">I4s", buf, off)
        hdr = 8
        if size == 1:
            size = struct.unpack_from(">Q", buf, off + 8)[0]
            hdr = 16
        elif size == 0:
            size = end - off
        if size < hdr or off + size > end:
            raise ValueError(f"mp4: box {typ!r} overruns its parent")
        yield typ, off + hdr, off + size
        off += size


def _children(buf, start, end) -> Dict[bytes, List[tuple]]:
    out: Dict[bytes, List[tuple]] = {}
    for typ, s, e in _boxes(buf, start, end):
        out.setdefault(typ, []).append((s, e))
    return out


def _descriptor(buf: bytes, off: int):
    tag = buf[off]
    off += 1
    length = 0
    for _ in range(4):
        b = buf[off]
        off += 1
        length = (length << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, off, off + length


def _esds_dsi(buf: bytes, start: int, end: int) -> bytes:
    off = start + 4  # version, flags
    tag, s, e = _descriptor(buf, off)
    if tag != 3:
        raise ValueError("mp4: esds has no ES descriptor")
    flags = buf[s + 2]
    p = s + 3
    if flags & 0x80:
        p += 2
    if flags & 0x40:
        p += 1 + buf[p]
    if flags & 0x20:
        p += 2
    while p < e:
        tag, ds, de = _descriptor(buf, p)
        if tag == 4:  # DecoderConfigDescriptor
            q = ds + 13
            while q < de:
                t2, s2, e2 = _descriptor(buf, q)
                if t2 == 5:
                    return bytes(buf[s2:e2])
                q = e2
            return b""
        p = de
    return b""


def _full(buf, start):
    return buf[start], start + 4  # version, payload start


def read(path: str) -> Track:
    """The first video track of an mp4 file."""
    with open(path, "rb") as f:
        buf = f.read()
    return parse(buf)


def parse(buf: bytes) -> Track:
    top = _children(buf, 0, len(buf))
    if b"moov" not in top:
        raise ValueError("mp4: no moov box (not an ISO base media file)")
    s, e = top[b"moov"][0]
    for ts, te in _children(buf, s, e).get(b"trak", []):
        trak = _children(buf, ts, te)
        if b"mdia" not in trak:
            continue
        mdia = _children(buf, *trak[b"mdia"][0])
        hs, _ = mdia[b"hdlr"][0]
        if buf[hs + 8:hs + 12] != b"vide":
            continue
        ms, _ = mdia[b"mdhd"][0]
        version, p = _full(buf, ms)
        if version == 1:
            timescale, duration = struct.unpack_from(">IQ", buf, p + 16)
        else:
            timescale, duration = struct.unpack_from(">II", buf, p + 8)
        minf = _children(buf, *mdia[b"minf"][0])
        stbl = _children(buf, *minf[b"stbl"][0])
        return _track(buf, stbl, timescale, duration)
    raise ValueError("mp4: no video track")


def _track(buf, stbl, timescale, duration) -> Track:
    ss, se = stbl[b"stsd"][0]
    _, p = _full(buf, ss)
    count = struct.unpack_from(">I", buf, p)[0]
    if count < 1:
        raise ValueError("mp4: empty sample description")
    entry_size, codec = struct.unpack_from(">I4s", buf, p + 4)
    codec_s = codec.decode("latin-1")
    if codec != b"mp4v":
        raise ValueError(f"mp4: video codec {codec_s!r} is not supported (only 'mp4v', "
                         "MPEG-4 Part 2, decodes here)")
    es = p + 4 + 8
    width, height = struct.unpack_from(">HH", buf, es + 24)
    dsi = b""
    for typ, bs, be in _boxes(buf, es + 78, p + 4 + entry_size):
        if typ == b"esds":
            dsi = _esds_dsi(buf, bs, be)

    # sample sizes
    if b"stsz" in stbl:
        zs, _ = stbl[b"stsz"][0]
        _, q = _full(buf, zs)
        fixed, n = struct.unpack_from(">II", buf, q)
        sizes = (np.full(n, fixed, np.int64) if fixed else
                 np.frombuffer(buf, ">u4", n, q + 8).astype(np.int64))
    else:
        raise ValueError("mp4: no stsz box")
    # chunk offsets
    if b"stco" in stbl:
        cs, _ = stbl[b"stco"][0]
        _, q = _full(buf, cs)
        nc = struct.unpack_from(">I", buf, q)[0]
        chunks = np.frombuffer(buf, ">u4", nc, q + 4).astype(np.int64)
    elif b"co64" in stbl:
        cs, _ = stbl[b"co64"][0]
        _, q = _full(buf, cs)
        nc = struct.unpack_from(">I", buf, q)[0]
        chunks = np.frombuffer(buf, ">u8", nc, q + 4).astype(np.int64)
    else:
        raise ValueError("mp4: no stco / co64 box")
    # samples per chunk
    cs, _ = stbl[b"stsc"][0]
    _, q = _full(buf, cs)
    ne = struct.unpack_from(">I", buf, q)[0]
    runs = np.frombuffer(buf, ">u4", 3 * ne, q + 4).reshape(ne, 3).astype(np.int64)
    per_chunk = np.zeros(len(chunks), np.int64)
    for i, (first, spc, _) in enumerate(runs):
        last = runs[i + 1][0] - 1 if i + 1 < ne else len(chunks)
        per_chunk[first - 1:last] = spc
    offsets = np.empty(len(sizes), np.int64)
    k = 0
    for c, off in enumerate(chunks):
        for _ in range(per_chunk[c]):
            if k >= len(sizes):
                break
            offsets[k] = off
            off += sizes[k]
            k += 1
    if k != len(sizes):
        raise ValueError("mp4: the chunk table covers fewer samples than stsz lists")
    # timing
    ts, _ = stbl[b"stts"][0]
    _, q = _full(buf, ts)
    nt = struct.unpack_from(">I", buf, q)[0]
    stts = np.frombuffer(buf, ">u4", 2 * nt, q + 4).reshape(nt, 2).astype(np.int64)
    total = int((stts[:, 0] * stts[:, 1]).sum())
    n = int(stts[:, 0].sum())
    deltas = set(int(d) for c, d in stts if c)
    if len(deltas) == 1 and next(iter(deltas)):
        fps = timescale / next(iter(deltas))
    elif total:
        fps = timescale * n / total
    else:
        fps = 0.0
    sync = None
    if b"stss" in stbl:
        ys, _ = stbl[b"stss"][0]
        _, q = _full(buf, ys)
        ns = struct.unpack_from(">I", buf, q)[0]
        sync = np.frombuffer(buf, ">u4", ns, q + 4).astype(np.int64)
    return Track(codec_s, width, height, float(fps), dsi, offsets, sizes, sync)


# ---------------------------------------------------------------- writing

def _box(typ: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I4s", 8 + len(body), typ) + body


def _full_box(typ: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return _box(typ, struct.pack(">I", (version << 24) | flags), *payload)


def _desc(tag: int, body: bytes) -> bytes:
    n = len(body)
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F]) + body


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def timescale_for(fps: float):
    """(time scale, sample delta) that state `fps` exactly where it is a
    ratio of small integers."""
    fr = Fraction(fps).limit_denominator(1001)
    scale, delta = fr.numerator, fr.denominator
    while scale < 10000:
        scale *= 2
        delta *= 2
    return scale, delta


def write(path: str, samples: List[bytes], dsi: bytes, width: int, height: int,
          fps: float) -> None:
    """An mp4 of MPEG-4 Part 2 samples (each a sync sample) at `fps`."""
    scale, delta = timescale_for(fps)
    n = len(samples)
    duration = n * delta
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isomiso2mp41")
    mdat_payload = b"".join(samples)
    mdat = struct.pack(">I4s", 8 + len(mdat_payload), b"mdat")
    first = len(ftyp) + len(mdat)  # the first sample's offset
    movie_ms = int(round(duration * 1000 / scale))
    mvhd = _full_box(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, movie_ms),
                     struct.pack(">IH", 0x10000, 0x100), b"\0" * 10, _MATRIX, b"\0" * 24,
                     struct.pack(">I", 2))
    tkhd = _full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie_ms), b"\0" * 8,
                     struct.pack(">HHHH", 0, 0, 0, 0), _MATRIX,
                     struct.pack(">II", width << 16, height << 16))
    mdhd = _full_box(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, scale, duration),
                     struct.pack(">HH", 0x55C4, 0))
    hdlr = _full_box(b"hdlr", 0, 0, struct.pack(">I", 0), b"vide", b"\0" * 12,
                     b"VideoHandler\0")
    bitrate = int(len(mdat_payload) * 8 * scale / max(duration, 1))
    es = _desc(3, struct.pack(">HB", 1, 0)
               + _desc(4, struct.pack(">BB", 0x20, 0x11)
                       + struct.pack(">I", max(len(s) for s in samples) if samples else 0)[1:]
                       + struct.pack(">II", bitrate, bitrate) + _desc(5, dsi))
               + _desc(6, b"\x02"))
    esds = _full_box(b"esds", 0, 0, es)
    mp4v = _box(b"mp4v", b"\0" * 6, struct.pack(">H", 1), b"\0" * 16,
                struct.pack(">HHIIIH", width, height, 0x480000, 0x480000, 0, 1),
                b"\0" * 32, struct.pack(">Hh", 0x18, -1), esds)
    stsd = _full_box(b"stsd", 0, 0, struct.pack(">I", 1), mp4v)
    stts = _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, delta))
    stsc = _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
    stsz = _full_box(b"stsz", 0, 0, struct.pack(">II", 0, n),
                     np.asarray([len(s) for s in samples], ">u4").tobytes())
    stco = (_full_box(b"stco", 0, 0, struct.pack(">II", 1, first))
            if first + len(mdat_payload) < 2**32
            else _full_box(b"co64", 0, 0, struct.pack(">IQ", 1, first)))
    stbl = _box(b"stbl", stsd, stts, stsc, stsz, stco)
    vmhd = _full_box(b"vmhd", 0, 1, b"\0" * 8)
    dinf = _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                   _full_box(b"url ", 0, 1)))
    minf = _box(b"minf", vmhd, dinf, stbl)
    moov = _box(b"moov", mvhd, _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf)))
    with open(path, "wb") as f:
        f.write(ftyp)
        f.write(mdat)
        f.write(mdat_payload)
        f.write(moov)
