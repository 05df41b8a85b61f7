"""CLI: fit per-object 3D Gaussians (step 3 of the reference's pipeline).

    python -m versecrafter_tpu_torch.cli.fit_gaussian --npz_path <depth npz> \
        --masks_dir <dir of mask_{id}_{label}.png> --output_dir <dir>

The JAX package's flags; the fit is numpy on the host, so --device,
--input_image_path and --disable_visualization change nothing, as there.
Writes <output_dir>/gaussian_params.json. Reading the masks needs OpenCV.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Fit 3D Gaussians from depth NPZ + segmentation masks")
    p.add_argument("--npz_path", type=str, required=True)
    p.add_argument("--masks_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--device", type=str, default="cpu")
    p.add_argument("--input_image_path", type=str, default=None)
    p.add_argument("--disable_visualization", action="store_true")
    args = p.parse_args(argv)

    from versecrafter_tpu_torch.geometry.gaussians import process_single_image

    out = process_single_image(args.npz_path, args.masks_dir, args.output_dir,
                               input_image_path=args.input_image_path)
    print(f"fitted {out['num_objects']} objects -> {args.output_dir}/gaussian_params.json")
    return out


if __name__ == "__main__":
    main()
