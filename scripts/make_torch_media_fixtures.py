"""Write the media fixtures under tests/data/media/ with OpenCV and PIL, and
digests.json: the SHA-256 of the float32 array that the JAX package's
load_video / load_image gives for each file (tests/test_torch_media.py and
chip_smoke.py's phase 17 hold the port's decodes to them).

- clip.mp4: 480x832, 24 frames at 16 fps, OpenCV's mp4v writer (two GOPs);
- yuv420.jpg: PIL, quality 90, 4:2:0;
- yuv444_rst.jpg: OpenCV, quality 85, 4:4:4, a restart interval of 4 MCUs;
- exif6.jpg: PIL, quality 90, 4:2:0, EXIF orientation 6 (rotate 90);
- rgb.png: OpenCV's PNG writer, 8-bit RGB;
- palette.png: PIL, 8-bit palette with a transparent entry;
- prog420_rst.jpg: PIL, progressive (ten scans with successive
  approximation), 4:2:0, restart markers, 480x832: four bright objects on a
  dark ground;
- prog444.jpg, prog_grey.jpg, prog_cmyk.jpg: PIL, progressive 4:4:4, grey,
  and Adobe CMYK.

digests.json's "saliency" entry holds what the JAX package's saliency
segmenter finds in prog420_rst.jpg (as its load path reads it) with
geometry/synthetic.bump_depth(480, 832, SALIENCY_SEED) and the prompt
SALIENCY_PROMPT, after cv2.setRNGSeed(0) (a fresh thread's state): each
detection's label, score, box and the SHA-256 of its bool mask.

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
SALIENCY_SEED = 4
SALIENCY_PROMPT = "car. person. dog. tree. bus. cat."


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


def objects(h, w, seed):
    """Four bright objects of distinct colours on a dark ground, with soft
    edges and a little noise: colour separates them from the ground far more
    than any depth map's normalised spread, so the saliency segmenter finds
    them whatever depth comes with the image (phase 12's default request
    takes a random-weight MoGe's)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.float32([20, 24, 30]) + 25 * (yy / h)[..., None] + np.zeros((1, 1, 3), np.float32)
    for cy, cx, ry, rx, col in [(0.62, 0.2, 0.2, 0.1, (250, 250, 250)),
                                (0.45, 0.5, 0.25, 0.08, (250, 230, 30)),
                                (0.7, 0.8, 0.15, 0.12, (30, 230, 240)),
                                (0.25, 0.75, 0.12, 0.1, (240, 40, 220))]:
        r = ((yy - cy * h) / (ry * h)) ** 2 + ((xx - cx * w) / (rx * w)) ** 2
        a = np.clip((1.1 - r) * 5, 0, 1)[..., None]
        img = img * (1 - a) + np.float32(col) * a
    img = img + rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def saliency_record(jvideo, path):
    """The JAX package's saliency detections on the image at `path`."""
    from versecrafter_tpu.perception.segmenter import ImageSegmenter
    from versecrafter_tpu_torch.geometry.synthetic import bump_depth

    img = (jvideo.load_image(path)[0, :, 0].transpose(1, 2, 0) * 255).round().astype(np.uint8)
    depth = bump_depth(img.shape[0], img.shape[1], SALIENCY_SEED)
    cv2.setRNGSeed(0)
    dets = ImageSegmenter(backend="saliency").segment_image(img, SALIENCY_PROMPT, depth=depth)
    return {"image": os.path.basename(path), "depth_seed": SALIENCY_SEED,
            "text_prompt": SALIENCY_PROMPT,
            "detections": [[d.label, d.score, [int(v) for v in d.box],
                            hashlib.sha256(d.mask.tobytes()).hexdigest()] for d in dets]}


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
    Image.fromarray(objects(480, 832, 5)).save(
        os.path.join(OUT, "prog420_rst.jpg"), quality=90, subsampling=2, progressive=True,
        restart_marker_blocks=12)
    Image.fromarray(scene(75, 133, 1, 6)[0]).save(os.path.join(OUT, "prog444.jpg"), quality=90,
                                                  subsampling=0, progressive=True)
    Image.fromarray(scene(61, 97, 1, 7)[0][..., 1]).save(os.path.join(OUT, "prog_grey.jpg"),
                                                         quality=90, progressive=True)
    Image.fromarray(scene(53, 87, 1, 8)[0]).convert("CMYK").save(
        os.path.join(OUT, "prog_cmyk.jpg"), quality=90, progressive=True)
    digests = {}
    for name in sorted(os.listdir(OUT)):
        if name == "digests.json":
            continue
        path = os.path.join(OUT, name)
        arr = jvideo.load_video(path) if name.endswith(".mp4") else jvideo.load_image(path)
        digests[name] = hashlib.sha256(arr.tobytes()).hexdigest()
    digests["saliency"] = saliency_record(jvideo, os.path.join(OUT, "prog420_rst.jpg"))
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"{len(digests) - 1} fixtures, {total} bytes, "
          f"{len(digests['saliency']['detections'])} saliency detections")


if __name__ == "__main__":
    main()
