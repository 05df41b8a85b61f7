"""Port parity for mp4 / image IO and the request contract: the port's
utils/video.py and serve/model_server.load_request_inputs against the JAX
package's on files the test writes, array for array and exactly. The port
reads and writes with its own codecs; OpenCV here is the reference (CPU)."""

import json
import os
import sys

import numpy as np
import pytest

from versecrafter_tpu.serve import model_server as jserve
from versecrafter_tpu.utils import profiling as jprof
from versecrafter_tpu.utils import video as jvideo
from versecrafter_tpu_torch.serve import model_server as tserve
from versecrafter_tpu_torch.utils import profiling as tprof
from versecrafter_tpu_torch.utils import video as tvideo


def _clip(t, h, w, seed):
    """Smooth moving gradients (compress well, so the decoded frames are
    close to these but not equal: both packages must decode the same)."""
    rng = np.random.default_rng(seed)
    tt = np.arange(t, dtype=np.float32)[:, None, None, None]
    yy = np.linspace(0, 1, h, dtype=np.float32)[None, :, None, None]
    xx = np.linspace(0, 1, w, dtype=np.float32)[None, None, :, None]
    ph = rng.random((1, 1, 1, 3)).astype(np.float32)
    return 0.5 + 0.5 * np.sin(2 * np.pi * (xx + 0.5 * yy + 0.1 * tt + ph))


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    paths = {}
    for name, (t, h, w, fps) in {"fps10": (10, 24, 40, 10), "fps24": (30, 36, 20, 24),
                                 "fps16": (7, 32, 32, 16)}.items():
        paths[name] = str(d / f"{name}.mp4")
        jvideo.save_video(_clip(t, h, w, len(paths)), paths[name], fps=fps)
    img = _clip(1, 30, 50, 9)[0]
    paths["png"] = str(d / "img.png")
    jvideo.save_image(img, paths["png"])
    paths["maps"] = str(d / "maps")
    _maps(paths["maps"], ["background_RGB.mp4"])
    return paths


@pytest.mark.parametrize("name,kw", [
    ("fps16", {}),                                            # as stored
    ("fps16", {"num_frames": 12, "size": (16, 24)}),          # edge padding, crop
    ("fps10", {"num_frames": 9, "size": (48, 64), "fps": 5}),  # 10 -> 5 fps, upscale
    ("fps24", {"num_frames": 9, "size": (16, 16), "fps": 16}),  # 24 -> 16 fps, area
    ("fps24", {"num_frames": 4, "fps": 24}),                  # truncation
])
def test_load_video_matches_jax(clips, name, kw):
    ref = jvideo.load_video(clips[name], **kw)
    got = tvideo.load_video(clips[name], **kw)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("size", [None, (20, 20), (64, 48)])
def test_load_image_matches_jax(clips, size):
    ref = jvideo.load_image(clips["png"], size=size)
    got = tvideo.load_image(clips["png"], size=size)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _psnr(a, b):
    return 10 * np.log10(1.0 / np.mean((a.astype(np.float64) - b) ** 2))


def test_saved_files_decode_the_same(tmp_path):
    """The port writes mp4 with its own encoder: OpenCV (through the JAX
    package) decodes the port's file to exactly what the port decodes (at an
    odd size too: test_torch_media.py::test_mp4_writer_round_trip, 37x53),
    no further from the frames than the JAX package's own file; png bytes
    are OpenCV's."""
    frames = (_clip(6, 16, 24, 3) * 255).astype(np.uint8)
    tvideo.save_video(frames, str(tmp_path / "t.mp4"), fps=8)
    jvideo.save_video(frames, str(tmp_path / "j.mp4"), fps=8)
    got = jvideo.load_video(str(tmp_path / "t.mp4"))
    np.testing.assert_array_equal(got, tvideo.load_video(str(tmp_path / "t.mp4")))
    src = frames.transpose(3, 0, 1, 2)[None].astype(np.float64) / 255.0
    assert _psnr(got, src) >= _psnr(jvideo.load_video(str(tmp_path / "j.mp4")), src)
    img = _clip(1, 10, 12, 4)[0]
    tvideo.save_image(img, str(tmp_path / "t.png"))
    jvideo.save_image(img, str(tmp_path / "j.png"))
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def _maps(d, names, t=9, h=24, w=40):
    os.makedirs(d, exist_ok=True)
    for i, name in enumerate(names):
        jvideo.save_video(_clip(t, h, w, 20 + i), os.path.join(d, name), fps=16)


@pytest.mark.parametrize("missing", [(), ("background_RGB.mp4",),
                                     ("background_depth.mp4", "3D_gaussian_depth.mp4")])
@pytest.mark.parametrize("with_mask_and_image", [True, False])
def test_load_request_inputs_matches_jax(clips, tmp_path, capsys, missing,
                                         with_mask_and_image):
    names = [n for n in tserve.CONTROL_NAMES if n not in missing]
    _maps(str(tmp_path), names + (["merged_mask.mp4"] if with_mask_and_image else []))
    params = {"rendering_maps_path": str(tmp_path), "height": 16, "width": 32,
              "num_frames": 12, "fps": 16}
    if with_mask_and_image:
        params["input_image_path"] = clips["png"]
    ref_c, ref_m = jserve.load_request_inputs(params)
    capsys.readouterr()
    got_c, got_m = tserve.load_request_inputs(params)
    warned = capsys.readouterr().out.splitlines()
    assert len(got_c) == len(ref_c) == 4
    for g, r in zip(got_c, ref_c):
        assert g.shape == r.shape == (1, 3, 12, 16, 32)
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got_m, ref_m)
    assert got_m.shape == (1, 1, 12, 16, 32)
    for i, name in enumerate(tserve.CONTROL_NAMES):  # a missing stream: zeros in its slot
        assert (np.abs(got_c[i][:, :, 1:]).max() == 0.0) == (name in missing)
    if with_mask_and_image:
        assert np.abs(got_m[:, :, 0]).max() == 0.0 and got_m[:, :, 1:].max() > 0
        img = tvideo.load_image(clips["png"], size=(16, 32))
        np.testing.assert_array_equal(got_c[0][:, :, 0], img[:, :, 0])
    else:
        assert (got_m == 1.0).all()
    assert warned == [f"warning: control video not found, zero-filled: "
                      f"{os.path.join(str(tmp_path), n)}" for n in tserve.CONTROL_NAMES
                      if n in missing]


def test_no_fill_warning_when_nothing_loads(tmp_path, capsys):
    """With every control stream missing nothing is zero-filled: the port
    raises without warning of a fill (the JAX package warns first)."""
    _maps(str(tmp_path), ["merged_mask.mp4"])
    with pytest.raises(FileNotFoundError, match="no control maps"):
        tserve.load_request_inputs({"rendering_maps_path": str(tmp_path), "height": 16,
                                    "width": 16, "num_frames": 4})
    assert capsys.readouterr().out == ""


@pytest.fixture
def no_cv2(monkeypatch):
    """The GPU machine's installation: no OpenCV (`import cv2` raises)."""
    monkeypatch.setitem(sys.modules, "cv2", None)


def _write_zero_clip(p, mod):
    path = os.path.join(os.path.dirname(p["png"]), f"{mod.__name__.split('.')[0]}.mp4")
    mod.save_video(np.zeros((2, 8, 8, 3), np.uint8), path)
    return path


def _write_zero_png(p, mod):
    path = os.path.join(os.path.dirname(p["png"]), f"{mod.__name__.split('.')[0]}.png")
    mod.save_image(np.zeros((8, 8, 3)), path)
    return path


@pytest.mark.parametrize("call", [
    lambda p, m: m.load_video(p["fps16"]),
    lambda p, m: m.load_image(p["png"]),
    lambda p, m: jvideo.load_video(_write_zero_clip(p, m)) if m is tvideo else m.load_video(
        _write_zero_clip(p, m)),
    lambda p, m: open(_write_zero_png(p, m), "rb").read(),
    lambda p, m: (tserve if m is tvideo else jserve).load_request_inputs(
        {"rendering_maps_path": p["maps"], "height": 16, "width": 16, "num_frames": 4}),
])
def test_io_without_opencv_matches(clips, no_cv2, call):
    """The GPU machine's installation has no OpenCV: with `import cv2`
    blocked, the port's reads and writes give the JAX package's arrays and
    files (the JAX package imported OpenCV before the block)."""
    ref = call(clips, jvideo)
    got = call(clips, tvideo)
    for g, r in zip(got if isinstance(got, tuple) else [got],
                    ref if isinstance(ref, tuple) else [ref]):
        if isinstance(g, list):
            for a, b in zip(g, r):
                np.testing.assert_array_equal(a, b)
        elif isinstance(g, bytes):
            assert g == r
        else:
            np.testing.assert_array_equal(g, r)


def test_step_timer_matches_jax(monkeypatch, tmp_path):
    times = iter([1.0, 1.25, 1.75, 2.0, 2.5, 1.0, 1.25, 1.75, 2.0, 2.5])
    monkeypatch.setattr(tprof.time, "perf_counter", lambda: next(times))
    got, ref = tprof.StepTimer(), jprof.StepTimer()
    for timer in (got, ref):
        for i in range(5):
            timer.tick(i, 5)
    assert got.summary() == ref.summary()
    assert got.summary()["steps"] == 4 and got.summary()["max_ms"] == 500.0
    got.dump(str(tmp_path / "steps.json"))
    assert json.loads((tmp_path / "steps.json").read_text())["steps_ms"] == got.steps_ms


def test_device_trace_writes_a_trace(tmp_path):
    import torch

    with tprof.device_trace(str(tmp_path / "trace")):
        torch.ones(8) @ torch.ones(8)
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
