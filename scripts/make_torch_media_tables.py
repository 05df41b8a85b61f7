"""Capture the two drawing tables that versecrafter_tpu_torch/utils/imgproc.py
keeps as data, from OpenCV, and write them to
versecrafter_tpu_torch/utils/_media_tables.py:

- TURBO: cv2.applyColorMap(0..255, COLORMAP_TURBO) as 256 RGB triples;
- GLYPHS: for each printable ASCII character, the pixels cv2.putText draws
  for it alone in FONT_HERSHEY_SIMPLEX at scale 0.5, thickness 1 (offsets
  from the text origin on the baseline, with the grey level drawn on black
  in white: OpenCV draws text anti-aliased), and its advance in pixels.

Run from the repository root: python scripts/make_torch_media_tables.py
"""

import os

import cv2
import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "versecrafter_tpu_torch", "utils", "_media_tables.py")
FONT, SCALE, THICK = cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1


def main():
    turbo = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                              cv2.COLORMAP_TURBO)[:, 0, ::-1]
    glyphs = {}
    for code in range(32, 127):
        ch = chr(code)
        canvas = np.zeros((48, 48), np.uint8)
        org = (16, 32)
        cv2.putText(canvas, ch, org, FONT, SCALE, 255, THICK)
        ys, xs = np.nonzero(canvas)
        (w20, _), _ = cv2.getTextSize(ch * 20, FONT, SCALE, THICK)
        (w40, _), _ = cv2.getTextSize(ch * 40, FONT, SCALE, THICK)
        glyphs[ch] = ((w40 - w20) / 20.0, [(int(x) - org[0], int(y) - org[1], int(canvas[y, x]))
                                            for y, x in zip(ys, xs)])
    with open(OUT, "w") as f:
        f.write('"""Drawing tables captured from OpenCV by '
                'scripts/make_torch_media_tables.py (do not edit)."""\n\n')
        f.write("# cv2.COLORMAP_TURBO, RGB, one triple per grey level\n")
        f.write("TURBO = bytes.fromhex(\n")
        hexs = turbo.astype(np.uint8).tobytes().hex()
        for i in range(0, len(hexs), 72):
            f.write(f'    "{hexs[i:i + 72]}"\n')
        f.write(")\n\n")
        f.write("# FONT_HERSHEY_SIMPLEX at scale 0.5, thickness 1: character -> (advance,\n"
                "# pixels as (dx, dy, coverage 0-255) from the origin on the baseline)\n")
        f.write("GLYPHS = {\n")
        for ch, (adv, px) in glyphs.items():
            f.write(f"    {ch!r}: ({adv!r}, {px!r}),\n")
        f.write("}\n")


if __name__ == "__main__":
    main()
