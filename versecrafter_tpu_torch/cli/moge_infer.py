"""CLI: monocular depth + intrinsics (step 1 of the reference's pipeline).

    python -m versecrafter_tpu_torch.cli.moge_infer -i <image> -o <dir> [--device cpu]

The JAX package's flags (the reference MoGe CLI's); --device defaults to
cuda. The image is edge-padded to a multiple of the 14-pixel patch and the
outputs cropped back. Writes depth_intrinsics.npz (fp16 depth + normalized
intrinsics), depth_gray.png / depth_vis.png (--maps), mesh.glb (--glb) and
pointcloud.ply (--ply); all of them when no format flag is given. Without
--pretrained the model is the full ViT-L MoGe from seed 0 (random weights).
The image is read (PNG or baseline JPEG) and the PNGs written by the port's
codecs (utils/video.py).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="Monocular geometry inference (PyTorch)")
    p.add_argument("--input", "-i", dest="input_path", required=True)
    p.add_argument("--fov_x", dest="fov_x", type=float, default=None)
    p.add_argument("--output", "-o", dest="output_path", default="./output")
    p.add_argument("--pretrained", dest="pretrained", default=None,
                   help="a MoGe checkpoint npz (moge.save_checkpoint's, either "
                        "package); random init from seed 0 when absent")
    p.add_argument("--version", dest="model_version", default="v2")
    p.add_argument("--device", dest="device_name", default="cuda")
    p.add_argument("--fp16", dest="use_fp16", action="store_true")
    p.add_argument("--resize_to", type=int, default=None)
    p.add_argument("--resolution_level", type=int, default=9)
    p.add_argument("--num_tokens", type=int, default=None)
    p.add_argument("--threshold", type=float, default=0.04)
    p.add_argument("--maps", dest="save_maps", action="store_true")
    p.add_argument("--glb", dest="save_glb", action="store_true")
    p.add_argument("--ply", dest="save_ply", action="store_true")
    p.add_argument("--show", action="store_true")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from versecrafter_tpu_torch import resolve_device
    from versecrafter_tpu_torch.perception import moge
    from versecrafter_tpu_torch.utils import imgproc
    from versecrafter_tpu_torch.utils.video import read_image

    dev = resolve_device(args.device_name)
    try:
        img = read_image(args.input_path)
    except (OSError, ValueError) as e:
        raise FileNotFoundError(f"File {args.input_path} does not exist "
                                "or is not a readable image.") from e
    if args.resize_to:
        h, w = img.shape[:2]
        nh = min(args.resize_to, int(args.resize_to * h / w))
        nw = min(args.resize_to, int(args.resize_to * w / h))
        img = imgproc.resize(img, (nw, nh), imgproc.INTER_AREA)
    oh, ow = img.shape[:2]
    ph, pw = -img.shape[0] % 14, -img.shape[1] % 14
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")

    if args.pretrained:
        params = moge.load_checkpoint(args.pretrained, device=dev)
    else:
        params = moge.init_moge(torch.Generator(device=dev).manual_seed(0))
    out = moge.infer(params, img.astype(np.float32) / 255.0, fov_x=args.fov_x)
    for k in ("depth", "points", "mask"):
        out[k] = out[k][:oh, :ow]

    save_maps, save_glb, save_ply = args.save_maps, args.save_glb, args.save_ply
    if not (save_maps or save_glb or save_ply):
        save_maps = save_glb = save_ply = True
    if save_maps:
        print(f"saved {moge.save_outputs(out, args.output_path)}")
    if save_glb or save_ply:
        paths = moge.export_mesh(out, img[:oh, :ow], args.output_path,
                                 threshold=args.threshold, save_glb=save_glb,
                                 save_ply=save_ply)
        for k, path in paths.items():
            print(f"saved {k}: {path}")
    return out


if __name__ == "__main__":
    main()
