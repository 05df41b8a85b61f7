"""The reference's pipeline stages in one process: depth -> segment ->
gaussian -> render -> generate, each through the port's CLI of that stage,
in this process (the port's counterpart of ``versecrafter_tpu.cli.pipeline``).

    python -m versecrafter_tpu_torch.cli.pipeline --data <clip dir> --out <dir> \
        [--model <wan dir>] [--prompt ...] [--sample_size 480,832] [--device cpu]

The clip directory has the demo layout (0001.png, estimated_depth/,
object_mask/, camera_object_0/); render reads the clip's own depth and
masks, as the JAX CLI does. The JAX CLI's flags, plus --device
(default cuda) passed to every stage. Prints the stages' wall seconds as
one JSON line, {"stage_wall_s": ..., "total_wall_s": ...}. --staged
generates with staged weight residency and a W4A8 DiT (the generate CLI's
--staged --quantize_int8 --int8_compute --quantize_bits 4, TeaCache off).
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True,
                   help="clip dir (0001.png + estimated_depth/ + object_mask/ + "
                        "camera_object_0/)")
    p.add_argument("--out", default="outputs/demo")
    p.add_argument("--model", default=None, help="Wan2.1 model dir (empty = offline smoke)")
    p.add_argument("--prompt", default="people walk through the scene, cinematic")
    p.add_argument("--text_prompt", default="person. car.", help="segmentation phrases")
    p.add_argument("--segment_backend", default="saliency",
                   help="'neural' is Grounding DINO -> SAM 2.1; 'saliency' the "
                        "classical fallback (OpenCV's blur, k-means and connected "
                        "components, in the port's own code)")
    p.add_argument("--sam2_checkpoint", default=None)
    p.add_argument("--gdino_checkpoint", default=None)
    p.add_argument("--bert_vocab", default=None)
    p.add_argument("--neural_fresh_init", action="store_true",
                   help="neural segmenter with random full-width weights")
    p.add_argument("--gdino_bf16", action="store_true", help="bf16 detector")
    p.add_argument("--sample_size", default="480,832")
    p.add_argument("--num_inference_steps", type=int, default=30)
    p.add_argument("--video_length", type=int, default=None,
                   help="frames to generate (default: the generate CLI's)")
    p.add_argument("--fps", type=int, default=16)
    p.add_argument("--skip", default="",
                   help="comma-separated stages to skip (depth,segment,gaussian,render,generate)")
    p.add_argument("--smoke_scale", default="1.3b", choices=["1.3b", "tiny", "14b"],
                   help="offline-smoke model size when --model is absent (14b with "
                        "--staged)")
    p.add_argument("--staged", action="store_true",
                   help="generate with staged weight residency + W4A8 "
                        "(cli/inference.py --staged)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    skip = set(filter(None, args.skip.split(",")))
    out, data, dev = args.out, args.data, args.device
    os.makedirs(out, exist_ok=True)
    traj = os.path.join(data, "camera_object_0")
    times = {}

    def stage(name, fn):
        if name in skip:
            print(f"== {name}: skipped ==", flush=True)
            return
        print(f"== {name} ==", flush=True)
        t0 = time.perf_counter()
        fn()
        times[name] = round(time.perf_counter() - t0, 1)

    from versecrafter_tpu_torch.cli import (
        fit_gaussian, inference, moge_infer, render_maps, segment)

    depth_npz = os.path.join(out, "estimated_depth", "depth_intrinsics.npz")
    stage("depth", lambda: moge_infer.main([
        "-i", os.path.join(data, "0001.png"), "-o", os.path.join(out, "estimated_depth"),
        "--maps", "--device", dev]))

    seg_extra = []
    for flag in ("sam2_checkpoint", "gdino_checkpoint", "bert_vocab"):
        if getattr(args, flag):
            seg_extra += [f"--{flag}", getattr(args, flag)]
    if args.neural_fresh_init:
        seg_extra.append("--neural_fresh_init")
    if args.gdino_bf16:
        seg_extra.append("--gdino_bf16")
    stage("segment", lambda: segment.main([
        "-i", os.path.join(data, "0001.png"), "-t", args.text_prompt,
        "-o", os.path.join(out, "object_mask"), "--backend", args.segment_backend,
        "--depth_npz", depth_npz, "--device", dev] + seg_extra))

    stage("gaussian", lambda: fit_gaussian.main([
        "--npz_path", depth_npz, "--masks_dir", os.path.join(out, "object_mask", "masks"),
        "--output_dir", os.path.join(out, "fitted_3D_gaussian")]))

    stage("render", lambda: render_maps.main([
        "--png_path", os.path.join(data, "0001.png"),
        "--npz_path", os.path.join(data, "estimated_depth", "depth_intrinsics.npz"),
        "--mask_dir", os.path.join(data, "object_mask", "masks"),
        "--trajectory_npz", os.path.join(traj, "custom_camera_trajectory.npz"),
        "--ellipsoid_json", os.path.join(traj, "custom_3D_gaussian_trajectory.json"),
        "--output_dir", os.path.join(out, "rendering_4D_maps"),
        "--fps", str(args.fps), "--device", dev]))

    gen_args = [
        "--rendering_maps_path", os.path.join(out, "rendering_4D_maps"),
        "--prompt", args.prompt,
        "--input_image_path", os.path.join(data, "0001.png"),
        "--save_path", os.path.join(out, "generated"),
        "--sample_size", args.sample_size,
        "--num_inference_steps", str(args.num_inference_steps), "--device", dev]
    if args.video_length is not None:
        gen_args += ["--video_length", str(args.video_length)]
    if args.model:
        gen_args += ["--model_name", args.model]
    else:
        gen_args += ["--offline_smoke", "--smoke_scale", args.smoke_scale]
    if args.staged:
        gen_args += ["--staged", "--quantize_int8", "--int8_compute",
                     "--quantize_bits", "4", "--teacache_threshold", "0"]
    stage("generate", lambda: inference.main(gen_args))

    print(json.dumps({"stage_wall_s": times, "total_wall_s": round(sum(times.values()), 1)}),
          flush=True)
    return times


if __name__ == "__main__":
    main()
