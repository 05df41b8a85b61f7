"""CLI: render the 4D control maps (step 5 of the reference's pipeline).

    python -m versecrafter_tpu_torch.cli.render_maps --png_path <png> \
        --npz_path <depth npz> --mask_dir <masks> --trajectory_npz <npz> \
        --ellipsoid_json <json> --output_dir <dir> [--device cpu]

The JAX package's flags (the reference renderer's flag set); --device
defaults to cuda. As there, --video_path, --mask_video, --use_fp16,
--pin_memory, --ellipsoid_subdiv, --trajectory_radius,
--gaussian_mask_threshold and --sample_frames are accepted and change
nothing. It prints the render's time split as one JSON line, then
"saved <name>: <path>" for each of the six mp4s. Reading the png and masks
and writing the mp4s needs OpenCV (utils/video.py).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Render 4D control maps from pre-computed parameters (PyTorch)")
    p.add_argument("--png_path", type=str, required=False)
    p.add_argument("--video_path", type=str, required=False)
    p.add_argument("--npz_path", type=str, required=True)
    p.add_argument("--mask_dir", type=str, required=False)
    p.add_argument("--mask_video", type=str, required=False)
    p.add_argument("--trajectory_npz", type=str, required=True)
    p.add_argument("--ellipsoid_json", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="outputs/inference")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--point_size", type=float, default=0.005)
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("--render_batch_size", type=int, default=27)
    p.add_argument("--use_fp16", action="store_true")
    p.add_argument("--pin_memory", action="store_true")
    p.add_argument("--ellipsoid_subdiv", type=int, default=3)
    p.add_argument("--trajectory_radius", type=float, default=0.03)
    p.add_argument("--gaussian_mask_threshold", type=float, default=0.003)
    p.add_argument("--sample_frames", type=int, default=10)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from versecrafter_tpu_torch import resolve_device
    from versecrafter_tpu_torch.geometry.render import render_from_files

    paths = render_from_files(
        png_path=args.png_path,
        npz_path=args.npz_path,
        mask_dir=args.mask_dir,
        trajectory_npz=args.trajectory_npz,
        ellipsoid_json=args.ellipsoid_json,
        output_dir=args.output_dir,
        point_size=args.point_size,
        fps=args.fps,
        frame_batch=args.render_batch_size,
        device=resolve_device(args.device),
    )
    for name, path in paths.items():
        print(f"saved {name}: {path}")
    return paths


if __name__ == "__main__":
    main()
