"""The mp4 writer's quantiser against OpenCV's mp4v writer: for each clip and
each quantiser, the PSNR of the port's decoded file against the source
frames and its size, beside OpenCV's writer's PSNR and size on the same
frames. utils/mpeg4.QP is the largest quantiser whose PSNR is at least
OpenCV's on every clip.

The clips are those the tests write (tests/test_torch_media.py,
tests/test_torch_video_io.py), the fixtures' scene at 480x832, and a
textured 480x832 clip that moves a pixel a frame (a render of a textured
mesh). Needs OpenCV (the reference writer); PSNR and sizes do not depend on
the machine.

Run from the repository root: python scripts/mpeg4_qp_sweep.py [--qps 1 2 3 4]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def media_clip(t, h, w, seed):
    rng = np.random.default_rng(seed)
    tt = np.arange(t, dtype=np.float32)[:, None, None, None]
    yy = np.linspace(0, 1, h, dtype=np.float32)[None, :, None, None]
    xx = np.linspace(0, 1, w, dtype=np.float32)[None, None, :, None]
    ph = rng.random((1, 1, 1, 3)).astype(np.float32)
    v = 0.5 + 0.5 * np.sin(2 * np.pi * (2 * xx + 0.5 * yy + 0.07 * tt + ph))
    return (np.clip(v + 0.15 * rng.random(v.shape, dtype=np.float32), 0, 1) * 255).astype(np.uint8)


def video_io_clip(t, h, w, seed):
    rng = np.random.default_rng(seed)
    tt = np.arange(t, dtype=np.float32)[:, None, None, None]
    yy = np.linspace(0, 1, h, dtype=np.float32)[None, :, None, None]
    xx = np.linspace(0, 1, w, dtype=np.float32)[None, None, :, None]
    ph = rng.random((1, 1, 1, 3)).astype(np.float32)
    v = 0.5 + 0.5 * np.sin(2 * np.pi * (xx + 0.5 * yy + 0.1 * tt + ph))
    return (v * 255).astype(np.uint8)


def textured(t, h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w + t]
    a = np.stack([128 + 100 * np.sin(xx / 5 + yy / 7), 128 + 100 * np.cos(xx / 3),
                  128 + 60 * np.sin(yy / 4)], -1) + rng.normal(0, 20, (h, w + t, 3))
    a = np.clip(a, 0, 255).astype(np.uint8)
    return np.stack([a[:, i:i + w] for i in range(t)])


def psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b) ** 2))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--qps", type=int, nargs="+", default=list(range(1, 9)))
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_media_fixtures import scene
    from versecrafter_tpu.utils import video as jvideo
    from versecrafter_tpu_torch.utils import mpeg4
    from versecrafter_tpu_torch.utils import video as tvideo

    clips = [("media 48x80x14 @16", media_clip(14, 48, 80, 7), 16),
             ("media 37x53x5 @24", media_clip(5, 37, 53, 7), 24),
             ("video_io 16x24x6 @8", video_io_clip(6, 16, 24, 3), 8),
             ("scene 480x832x24 @16", scene(480, 832, 24, 0), 16),
             ("textured 480x832x16 @16", textured(16, 480, 832, 5), 16)]
    clear = {q: True for q in args.qps}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "c.mp4")
        for name, frames, fps in clips:
            t, h, w, _ = frames.shape
            src = frames[:, :h & ~1, :w & ~1].astype(np.float64)

            def read(p):
                return (jvideo.load_video(p)[0].transpose(1, 2, 3, 0) * 255).round()

            jvideo.save_video(frames, path, fps=fps)
            ref_db, ref_bytes = psnr(read(path), src), os.path.getsize(path)
            print(f"{name}: OpenCV mp4v {ref_db:.2f} dB, {ref_bytes} bytes")
            for q in args.qps:
                mpeg4.QP = q
                tvideo.save_video(frames, path, fps=fps)
                db, size = psnr(read(path), src), os.path.getsize(path)
                clear[q] &= db >= ref_db
                print(f"  qp {q}: {db:.2f} dB ({db - ref_db:+.2f}), {size} bytes "
                      f"({size / ref_bytes:.2f}x)")
    ok = [q for q in args.qps if clear[q]]
    print("largest qp at or above OpenCV's PSNR on every clip:", max(ok) if ok else None)


if __name__ == "__main__":
    main()
