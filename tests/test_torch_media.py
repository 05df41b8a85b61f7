"""The port's own media codecs against OpenCV (through the JAX package where
it has the call), on files written here by OpenCV and PIL at small sizes:
PNG, baseline, progressive and CMYK JPEG and MPEG-4 Part 2 mp4 decoded bit
for bit; the port's
mp4 and PNG writers read back by OpenCV exactly as by the port, the mp4 at
a PSNR no lower than OpenCV's writer; resize, the TURBO map, and the
segmenter's files (CPU)."""

import io
import json
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from versecrafter_tpu.perception import segmenter as jseg
from versecrafter_tpu.utils import video as jvideo
from versecrafter_tpu_torch.perception import segmenter as tseg
from versecrafter_tpu_torch.utils import imgproc, jpeg, mp4, mpeg4, png
from versecrafter_tpu_torch.utils import video as tvideo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEDIA = os.path.join(REPO, "tests", "data", "media")


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 100 * np.sin(xx / 5 + yy / 7), 128 + 100 * np.cos(xx / 3),
                  128 + 60 * np.sin(yy / 4)], -1) + rng.normal(0, 20, (h, w, 3))
    return np.clip(a, 0, 255).astype(np.uint8)


def _clip(t, h, w, seed):
    rng = np.random.default_rng(seed)
    tt = np.arange(t, dtype=np.float32)[:, None, None, None]
    yy = np.linspace(0, 1, h, dtype=np.float32)[None, :, None, None]
    xx = np.linspace(0, 1, w, dtype=np.float32)[None, None, :, None]
    ph = rng.random((1, 1, 1, 3)).astype(np.float32)
    v = 0.5 + 0.5 * np.sin(2 * np.pi * (2 * xx + 0.5 * yy + 0.07 * tt + ph))
    return (np.clip(v + 0.15 * rng.random(v.shape, dtype=np.float32), 0, 1) * 255).astype(np.uint8)


def _cv_read(buf, flag):
    return cv2.imdecode(np.frombuffer(buf, np.uint8), flag)


# ---------------------------------------------------------------- PNG

def _build_png(samples, ctype, depth, interlace, palette=None, trns=None):
    """A PNG whose rows cycle through the five filter types."""
    chans = samples.shape[2]
    bpp = max(1, depth * chans // 8)

    def pack(row):
        v = row.reshape(-1).astype(np.int64)
        if depth == 16:
            return v.astype(">u2").tobytes()
        if depth == 8:
            return v.astype(np.uint8).tobytes()
        bits = np.unpackbits(v.astype(np.uint8)[:, None], axis=1)[:, 8 - depth:].reshape(-1)
        return np.packbits(bits).tobytes()

    def filt(rows):
        out, prev = b"", bytes(len(rows[0])) if rows else b""
        for j, r in enumerate(rows):
            f, enc = j % 5, bytearray()
            for i in range(len(r)):
                a = r[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = [0, a, b, (a + b) // 2, 0][f]
                if f == 4:
                    q = a + b - c
                    pa, pb, pc = abs(q - a), abs(q - b), abs(q - c)
                    p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                enc.append((r[i] - p) & 255)
            out += bytes([f]) + bytes(enc)
            prev = r
        return out

    if interlace:
        raw = b""
        for x0, y0, dx, dy in [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                               (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += filt([pack(r) for r in sub])
    else:
        raw = filt([pack(r) for r in samples])

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(t + d))

    h, w = samples.shape[:2]
    out = png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                     interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


PNG_CASES = [(c, d, il) for il in (0, 1) for c, ds in [(0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                                                        (3, (1, 2, 4, 8)), (4, (8, 16)),
                                                        (6, (8, 16))] for d in ds]


@pytest.mark.parametrize("ctype,depth,interlace", PNG_CASES)
def test_png_decodes_like_opencv(ctype, depth, interlace):
    rng = np.random.default_rng(ctype * 100 + depth * 2 + interlace)
    chans = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    s = rng.integers(0, 1 << depth, (13, 17, chans))
    pal = rng.integers(0, 256, (1 << depth, 3)).astype(np.uint8) if ctype == 3 else None
    trns = bytes([7, 200]) if ctype == 3 else None
    buf = _build_png(s, ctype, depth, interlace, pal, trns)
    np.testing.assert_array_equal(png.decode(buf, "color"),
                                  _cv_read(buf, cv2.IMREAD_COLOR)[..., ::-1])
    np.testing.assert_array_equal(png.decode(buf, "gray"), _cv_read(buf, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("shape", [(10, 12, 3), (30, 50), (480, 832, 3)])
def test_png_writes_opencv_bytes(tmp_path, shape):
    img = (np.random.default_rng(1).integers(0, 256, shape) // 16 * 16).astype(np.uint8)
    ok, enc = cv2.imencode(".png", img[..., ::-1] if img.ndim == 3 else img)
    mine = png.encode(img)
    assert mine == enc.tobytes()
    np.testing.assert_array_equal(png.decode(mine, "color" if img.ndim == 3 else "gray"), img)


# ---------------------------------------------------------------- JPEG

def _pil_jpeg(img, **kw):
    """A JPEG of a uint8 array, or of a PIL image in its own mode (CMYK)."""
    b = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(b, "JPEG", **kw)
    return b.getvalue()


JPEG_CASES = [(f"pil-{name}-q{q}", q, kw) for q in (50, 95) for name, kw in
              [("444", {"subsampling": 0}), ("422", {"subsampling": 1}),
               ("420", {"subsampling": 2}), ("grey", {"grey": True}),
               ("rst", {"restart": 3})]]


@pytest.mark.parametrize("name,q,kw", JPEG_CASES)
def test_jpeg_decodes_like_jax(tmp_path, name, q, kw):
    img = _image(37, 53, q)
    if kw.get("grey"):
        buf = _pil_jpeg(img[..., 0], quality=q)
    elif kw.get("restart"):
        ok, enc = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, q,
                                                         cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
        buf = enc.tobytes()
        assert b"\xff\xdd" in buf
    else:
        buf = _pil_jpeg(img, quality=q, **kw)
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(buf)
    np.testing.assert_array_equal(tvideo.load_image(path), jvideo.load_image(path))
    np.testing.assert_array_equal(tvideo.load_image(path, size=(16, 24)),
                                  jvideo.load_image(path, size=(16, 24)))
    np.testing.assert_array_equal(tvideo.read_image(path, gray=True),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientation(tmp_path, orientation):
    exif = Image.Exif()
    exif[0x0112] = orientation
    buf = _pil_jpeg(_image(20, 30, orientation), quality=90, exif=exif.tobytes())
    path = str(tmp_path / "o.jpg")
    with open(path, "wb") as f:
        f.write(buf)
    want = jvideo.load_image(path)
    assert want.shape[-2:] == ((30, 20) if orientation >= 5 else (20, 30))
    np.testing.assert_array_equal(tvideo.load_image(path), want)
    np.testing.assert_array_equal(tvideo.read_image(path, gray=True),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


PROGRESSIVE_CASES = [(f"{name}-{h}x{w}", h, w, kw) for h, w in ((1, 1), (9, 300), (37, 53))
                     for name, kw in [("444", {"subsampling": 0}), ("422", {"subsampling": 1}),
                                      ("420", {"subsampling": 2}),
                                      ("420-rst", {"subsampling": 2, "restart_marker_blocks": 3}),
                                      ("grey", {"grey": True}), ("cmyk", {"cmyk": True}),
                                      ("cmyk-baseline", {"cmyk": True, "baseline": True})]]


@pytest.mark.parametrize("name,h,w,kw", PROGRESSIVE_CASES)
def test_progressive_jpeg_decodes_like_opencv(name, h, w, kw):
    """PIL's progressive files (ten scans: spectral selection, successive
    approximation, EOB runs) at odd sizes, with restart markers, grey and
    Adobe CMYK (progressive and baseline): colour and grey equal to
    cv2.imdecode's."""
    kw = dict(kw)
    img = Image.fromarray(_image(h, w, h * w))
    if kw.pop("grey", False):
        img = img.convert("L")
    if kw.pop("cmyk", False):
        img = img.convert("CMYK")
    buf = _pil_jpeg(img, quality=85, progressive=not kw.pop("baseline", False),
                    **kw)
    assert (b"\xff\xc2" in buf) == ("baseline" not in name)
    if "rst" in name:
        assert b"\xff\xdd" in buf
    np.testing.assert_array_equal(jpeg.decode(buf), _cv_read(buf, cv2.IMREAD_COLOR)[..., ::-1])
    np.testing.assert_array_equal(jpeg.decode(buf, gray=True),
                                  _cv_read(buf, cv2.IMREAD_GRAYSCALE))


def test_progressive_opencv_writer_and_fixtures():
    """OpenCV's own progressive writer (with restarts, 4:4:4) and the
    committed progressive fixtures, through read_image as imread reads a
    path."""
    img = _image(45, 71, 3)
    for params in ([cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
                   [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, cv2.IMWRITE_JPEG_QUALITY, 97]):
        buf = cv2.imencode(".jpg", img, params)[1].tobytes()
        np.testing.assert_array_equal(jpeg.decode(buf), _cv_read(buf, cv2.IMREAD_COLOR)[..., ::-1])
    for name in ("prog420_rst.jpg", "prog444.jpg", "prog_grey.jpg", "prog_cmyk.jpg"):
        path = os.path.join(MEDIA, name)
        np.testing.assert_array_equal(tvideo.read_image(path), cv2.imread(path)[..., ::-1])
        np.testing.assert_array_equal(tvideo.read_image(path, gray=True),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_unsupported_images_are_named(tmp_path):
    """A progressive file cut inside a scan, one cut between scans (its
    coefficients left unrefined: libjpeg-turbo would block-smooth it), a
    YCCK header, and lossless and arithmetic-coded frames raise ValueError
    naming them; so does a file that is neither PNG nor JPEG."""
    buf = _pil_jpeg(_image(61, 83, 0), quality=90, progressive=True)
    with pytest.raises(ValueError, match="truncated progressive JPEG"):
        jpeg.decode(buf[: int(len(buf) * 0.9)])
    scans = [i for i in range(len(buf) - 1) if buf[i:i + 2] == b"\xff\xda"]
    with pytest.raises(ValueError, match="unrefined.*block smoothing"):
        jpeg.decode(buf[:scans[-1]] + b"\xff\xd9")
    cmyk = bytearray(_pil_jpeg(Image.fromarray(_image(16, 16, 1)).convert("CMYK"), quality=90))
    adobe = cmyk.find(b"Adobe")
    assert adobe > 0 and cmyk[adobe + 11] == 0
    cmyk[adobe + 11] = 2  # the transform flag: YCCK
    with pytest.raises(ValueError, match="YCCK"):
        jpeg.decode(bytes(cmyk))
    base = _pil_jpeg(_image(16, 16, 0), quality=90)
    for sof, kind in ((0xC3, "lossless"), (0xC9, "arithmetic")):
        with pytest.raises(ValueError, match=kind):
            jpeg.decode(base.replace(b"\xff\xc0", bytes([0xFF, sof]), 1))
    path = str(tmp_path / "x.gif")
    Image.fromarray(_image(8, 8, 0)).save(path, "GIF")
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        tvideo.read_image(path)


# ---------------------------------------------------------------- mp4

@pytest.mark.parametrize("t,h,w,fps", [(30, 36, 20, 24), (40, 48, 64, 10), (16, 480, 832, 16),
                                       (13, 20, 36, 16)])
def test_mp4_decodes_like_jax(tmp_path, t, h, w, fps):
    """OpenCV's mp4v writer (GOP 12: I- and P-VOPs) at several sizes and
    rates; the source fps drives load_video's resampling."""
    path = str(tmp_path / "c.mp4")
    jvideo.save_video(_clip(t, h, w, t), path, fps=fps)
    assert mp4.read(path).fps == cv2.VideoCapture(path).get(cv2.CAP_PROP_FPS)
    np.testing.assert_array_equal(tvideo.load_video(path), jvideo.load_video(path))
    kw = {"num_frames": 9, "size": (16, 16), "fps": 8}
    np.testing.assert_array_equal(tvideo.load_video(path, **kw), jvideo.load_video(path, **kw))


def test_mp4_other_codecs_are_named(tmp_path):
    path = str(tmp_path / "c.mp4")
    jvideo.save_video(_clip(3, 16, 16, 0), path, fps=16)
    buf = open(path, "rb").read()
    assert buf.count(b"mp4v") == 1
    with open(path, "wb") as f:
        f.write(buf.replace(b"mp4v", b"avc1"))
    with pytest.raises(ValueError, match="'avc1'"):
        tvideo.load_video(path)


def _psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b) ** 2))


@pytest.mark.parametrize("t,h,w,fps", [(14, 48, 80, 16), (5, 37, 53, 24)])
def test_mp4_writer_round_trip(tmp_path, t, h, w, fps):
    """OpenCV decodes the port's file to what the port decodes; the PSNR
    against the frames is at least that of OpenCV's writer's file."""
    frames = _clip(t, h, w, 7)
    mine, theirs = str(tmp_path / "port.mp4"), str(tmp_path / "cv.mp4")
    tvideo.save_video(frames, mine, fps=fps)
    jvideo.save_video(frames, theirs, fps=fps)
    got = tvideo.load_video(mine)
    np.testing.assert_array_equal(jvideo.load_video(mine), got)
    ref = jvideo.load_video(theirs)
    assert got.shape == ref.shape == (1, 3, t, h & ~1, w & ~1)
    src = frames[:, :h & ~1, :w & ~1].transpose(3, 0, 1, 2)[None].astype(np.float64)
    assert _psnr(got * 255, src) >= _psnr(ref * 255, src)


_THREADED_ENCODE = """
import sys, threading
import numpy as np
from versecrafter_tpu_torch.utils import mpeg4

frames = np.random.default_rng(1).integers(0, 256, (3, 48, 64, 3)).astype(np.uint8)
start, out = threading.Barrier(6), [None] * 6

def run(i):
    start.wait()
    out[i] = mpeg4.encode(frames, 16)

threads = [threading.Thread(target=run, args=(i,)) for i in range(6)]
for t in threads:
    t.start()
for t in threads:
    t.join()
sys.exit(0 if all(o == mpeg4.encode(frames, 16) for o in out) else 1)
"""


def test_mp4_encoders_in_threads_agree():
    """Six encoders start together in a fresh process (as
    geometry/render.write_control_maps runs them, the GIL released), so
    their first transforms meet the encoder's one-time tables: each writes
    the bytes of one encoder run alone afterwards."""
    import subprocess
    import sys

    mpeg4._lib()  # built here, so the child only loads it
    r = subprocess.run([sys.executable, "-c", _THREADED_ENCODE], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


# ---------------------------------------------------------------- imgproc

@pytest.mark.parametrize("src,dst", [((100, 150), (37, 53)), ((64, 64), (32, 32)),
                                     ((480, 832), (240, 416)), ((60, 90), (20, 30)),
                                     ((37, 53), (80, 100))])
def test_resize_matches_opencv(src, dst):
    img = np.random.default_rng(src[0]).integers(0, 256, src + (3,)).astype(np.uint8)
    for name, flag in [(imgproc.INTER_AREA, cv2.INTER_AREA),
                       (imgproc.INTER_LINEAR, cv2.INTER_LINEAR),
                       (imgproc.INTER_NEAREST, cv2.INTER_NEAREST)]:
        np.testing.assert_array_equal(imgproc.resize(img, dst[::-1], name),
                                      cv2.resize(img, dst[::-1], interpolation=flag))


def test_turbo_and_drawing_match_opencv():
    g = np.random.default_rng(0).integers(0, 256, (30, 40)).astype(np.uint8)
    np.testing.assert_array_equal(imgproc.colormap_turbo(g),
                                  cv2.applyColorMap(g, cv2.COLORMAP_TURBO)[..., ::-1])
    for box in [(3, 4, 15, 12), (-5, 3, 50, 20), (10, 10, 11, 11)]:
        a = np.full((30, 40, 3), 9, np.uint8)
        b = a.copy()
        cv2.rectangle(a, box[:2], box[2:], (255, 60, 60), 2)
        imgproc.rectangle(b, box[:2], box[2:], (255, 60, 60))
        np.testing.assert_array_equal(a, b)
    for org in [(5, 20), (-40, 20), (30, 2), (35, 200)]:  # inside, and past each edge
        a = np.full((30, 40, 3), 9, np.uint8)
        b = a.copy()
        cv2.putText(a, "1:car", org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 60, 60), 1)
        imgproc.put_text(b, "1:car", org, (255, 60, 60))
        np.testing.assert_array_equal(a, b)


def test_segmenter_files_match_jax(tmp_path):
    """save_results: masks and combined bit-equal (as files), the
    visualization equal outside the label boxes."""
    img = _image(96, 128, 5)
    rng = np.random.default_rng(2)
    dets = []
    for i, (label, box) in enumerate([("car", (10, 20, 60, 70)), ("person", (70, 5, 120, 90))]):
        m = np.zeros((96, 128), bool)
        m[box[1]:box[3], box[0]:box[2]] = rng.random((box[3] - box[1], box[2] - box[0])) > 0.3
        dets.append((label, 0.5 + i / 10, box, m))
    jp = jseg.ImageSegmenter().save_results(img, [jseg.Detection(*d) for d in dets],
                                            str(tmp_path / "jax"), stem="in")
    tp = tseg.ImageSegmenter().save_results(img, [tseg.Detection(*d) for d in dets],
                                            str(tmp_path / "port"), stem="in")
    assert sorted(jp) == sorted(tp)
    for k in jp:
        if k != "visualization":
            assert open(jp[k], "rb").read() == open(tp[k], "rb").read(), k
    want = cv2.imread(jp["visualization"])[..., ::-1]
    got = tvideo.read_image(tp["visualization"])
    outside = np.ones(want.shape[:2], bool)
    for i, (label, _, (x0, y0, _, _), _) in enumerate(dets, start=1):
        (tw, th), base = cv2.getTextSize(f"{i}:{label}", cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        yb = max(y0 - 4, 10)
        outside[max(yb - th - 1, 0):yb + base + 1, max(x0 - 1, 0):x0 + tw + 2] = False
    np.testing.assert_array_equal(got[outside], want[outside])


# ---------------------------------------------------------------- fixtures

def test_fixture_digests():
    """The committed fixtures decode, in the port, to the arrays whose
    SHA-256 the JAX package's load_video / load_image gave when they were
    made (scripts/make_torch_media_fixtures.py), and still give; the saliency
    record's detections are the JAX package's after cv2.setRNGSeed(0) and
    the port's in a fresh thread, with OpenCV blocked in the port."""
    import hashlib
    import sys
    import threading

    from versecrafter_tpu_torch.geometry.synthetic import bump_depth

    with open(os.path.join(MEDIA, "digests.json")) as f:
        digests = json.load(f)
    record = digests.pop("saliency")
    assert len(digests) == 10
    for name, want in digests.items():
        path = os.path.join(MEDIA, name)
        load = tvideo.load_video if name.endswith(".mp4") else tvideo.load_image
        jload = jvideo.load_video if name.endswith(".mp4") else jvideo.load_image
        got = load(path)
        assert hashlib.sha256(got.tobytes()).hexdigest() == want, name
        np.testing.assert_array_equal(got, jload(path))

    img = tvideo.read_image(os.path.join(MEDIA, record["image"]))
    depth = bump_depth(*img.shape[:2], record["depth_seed"])
    cv2.setRNGSeed(0)
    jdets = jseg.ImageSegmenter().segment_image(img, record["text_prompt"], depth=depth)
    out = {}

    def port():
        saved = sys.modules.get("cv2")
        sys.modules["cv2"] = None
        try:
            out["dets"] = tseg.ImageSegmenter().segment_image(img, record["text_prompt"],
                                                             depth=depth)
        finally:
            sys.modules["cv2"] = saved
    t = threading.Thread(target=port)
    t.start()
    t.join()

    def rows(dets):
        return [[d.label, d.score, [int(v) for v in d.box],
                 hashlib.sha256(d.mask.tobytes()).hexdigest()] for d in dets]
    assert len(record["detections"]) >= 3
    assert rows(jdets) == rows(out["dets"]) == record["detections"]


def test_host_codecs_build_or_raise(tmp_path, monkeypatch):
    """csrc/host sources build with the host compiler into the build
    directory under their source hash; without a compiler they raise,
    nothing stands in."""
    import re
    import shutil

    from versecrafter_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    path = _build.build_host("png")
    assert re.fullmatch(r"host-png-[0-9a-f]{16}\.so", os.path.basename(path))
    assert os.path.dirname(path) == str(tmp_path) and os.listdir(tmp_path) == [
        os.path.basename(path)]
    os.unlink(path)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match=r"c\+\+"):
        _build.build_host("png")
