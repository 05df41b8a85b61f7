"""Write the media fixtures under tests/data/media/ with OpenCV and PIL, and
digests.json: the SHA-256 of the float32 array that the JAX package's
load_video / load_image gives for each file (tests/test_torch_media.py and
chip_smoke.py's phase 17 hold the port's decodes to them).

- clip.mp4: 480x832, 24 frames at 16 fps, OpenCV's mp4v writer (two GOPs);
- yuv420.jpg: PIL, quality 90, 4:2:0;
- yuv444_rst.jpg: OpenCV, quality 85, 4:4:4, a restart interval of 4 MCUs;
- exif6.jpg: PIL, quality 90, 4:2:0, EXIF orientation 6 (rotate 90);
- rgb.png: OpenCV's PNG writer, 8-bit RGB;
- palette.png: PIL, 8-bit palette with a transparent entry.

Run from the repository root: python scripts/make_torch_media_fixtures.py
"""

import hashlib
import json
import os
import sys

import cv2
import numpy as np
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "media")


def scene(h, w, t, seed):
    """Smooth moving colour fields with soft edges (what renders look like)."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    xx = np.linspace(0, 1, w, dtype=np.float32)[None, :, None]
    ph = rng.random((1, 1, 3)).astype(np.float32)
    frames = []
    for i in range(t):
        v = 0.5 + 0.35 * np.sin(2 * np.pi * (1.5 * xx + 0.7 * yy + 0.03 * i + ph))
        disc = ((xx - 0.3 - 0.01 * i) ** 2 + (yy - 0.5) ** 2) < 0.04
        v = np.where(disc, np.float32([0.9, 0.2, 0.1]), v)
        frames.append((np.clip(v, 0, 1) * 255).astype(np.uint8))
    return np.stack(frames)


def main():
    sys.path.insert(0, REPO)
    from versecrafter_tpu.utils import video as jvideo

    os.makedirs(OUT, exist_ok=True)
    jvideo.save_video(scene(480, 832, 24, 0), os.path.join(OUT, "clip.mp4"), fps=16)
    img = scene(240, 416, 1, 1)[0]
    Image.fromarray(img).save(os.path.join(OUT, "yuv420.jpg"), quality=90, subsampling=2)
    ok, enc = cv2.imencode(".jpg", img[..., ::-1], [
        cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_RST_INTERVAL, 4,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
    with open(os.path.join(OUT, "yuv444_rst.jpg"), "wb") as f:
        f.write(enc.tobytes())
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(scene(120, 200, 1, 2)[0]).save(os.path.join(OUT, "exif6.jpg"), quality=90,
                                                   exif=exif.tobytes())
    cv2.imwrite(os.path.join(OUT, "rgb.png"), scene(240, 416, 1, 3)[0][..., ::-1])
    Image.fromarray(scene(96, 160, 1, 4)[0]).quantize(64).save(
        os.path.join(OUT, "palette.png"), transparency=5)
    digests = {}
    for name in sorted(os.listdir(OUT)):
        if name == "digests.json":
            continue
        path = os.path.join(OUT, name)
        arr = jvideo.load_video(path) if name.endswith(".mp4") else jvideo.load_image(path)
        digests[name] = hashlib.sha256(arr.tobytes()).hexdigest()
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"{len(digests)} fixtures, {total} bytes")


if __name__ == "__main__":
    main()
