"""CLI: controlled video generation from a control-map directory.

    python -m versecrafter_tpu_torch.cli.inference --model_name <model dir> \
        --rendering_maps_path <maps> --prompt "..." --input_image_path <png> \
        --save_path outputs/inference
    python -m versecrafter_tpu_torch.cli.inference --offline_smoke --smoke_scale tiny \
        --device cpu --rendering_maps_path <maps> --prompt x --input_image_path ""

The flags are the JAX package's cli/inference.py flags plus --device
(default cuda). --model_name is a reference-layout model directory
(core.convert.load_versecrafter); without it the model is the random-weight
pipeline of --smoke_scale. --offline_smoke defaults the size to 64x64x9 at
4 steps unless the size flags are given. It prints "denoise i / n" after
each step and the saved mp4's path as its last line (the API server's
subprocess tier reads both). Reading the maps and writing the mp4 need
OpenCV (utils/video.py). As in the JAX CLI, --lora_path (any state dict
core.convert.load_torch_state_dict reads) is merged at --lora_weight first,
then --quantize_int8 / --int8_compute store the DiT in --quantize_bits
(W8A8 / W4A8 with --int8_compute), then --int8_attention applies.

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
--staged and --fit_teacache (staged residency), --moe and
--transformer_high_path (Wan2.2 experts), mesh degrees > 1 and
--auto_parallel.
"""

from __future__ import annotations

import argparse
import json
import time

NEGATIVE_PROMPT = (
    "Bright tones, overexposed, static, blurred details, subtitles, style, "
    "works, paintings, images, static, overall gray, worst quality, low "
    "quality, JPEG compression residue, ugly, incomplete, extra fingers, "
    "poorly drawn hands, poorly drawn faces, deformed, disfigured, misshapen "
    "limbs, fused fingers, still picture, messy background, three legs, many "
    "people in the background, walking backwards"
)

SAMPLERS = {"Flow": "euler", "Flow_Unipc": "unipc", "Flow_DPM++": "dpm++"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Video generation inference (PyTorch)")
    p.add_argument("--transformer_path", type=str, default=None)
    p.add_argument("--model_name", type=str, default=None,
                   help="Base model dir (Wan2.1-T2V layout)")
    p.add_argument("--save_path", type=str, default="outputs/inference")
    p.add_argument("--rendering_maps_path", type=str, required=True)
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--input_image_path", type=str, required=True)
    p.add_argument("--num_inference_steps", type=int, default=None)
    p.add_argument("--sample_size", type=str, default=None)
    p.add_argument("--ulysses_degree", type=int, default=1)
    p.add_argument("--ring_degree", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--guidance_scale", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=2025)
    p.add_argument("--fps", type=int, default=16)
    p.add_argument("--video_length", type=int, default=None)
    p.add_argument("--sampler", type=str, default="Flow_Unipc", choices=list(SAMPLERS))
    p.add_argument("--shift", type=float, default=16.0)
    p.add_argument("--teacache_threshold", type=float, default=0.10)
    p.add_argument("--teacache_skip_start", type=int, default=5)
    p.add_argument("--teacache_coeffs", type=str, default=None,
                   help="JSON file with fitted rescale-polynomial coefficients "
                        "(and optionally a 'threshold', which takes precedence "
                        "over --teacache_threshold)")
    p.add_argument("--cfg_skip_ratio", type=float, default=0.0)
    p.add_argument("--enable_riflex", action="store_true")
    p.add_argument("--riflex_k", type=int, default=6)
    p.add_argument("--geoada_context_scale", type=float, default=1.0)
    p.add_argument("--geoada_in_dim", type=int, default=128)
    p.add_argument("--lora_path", type=str, default=None,
                   help="LoRA state dict (.safetensors, shard dir, .npz, .pth) "
                        "merged into the DiT")
    p.add_argument("--lora_weight", type=float, default=0.55)
    p.add_argument("--quantize_int8", action="store_true",
                   help="store the DiT's big kernels quantized (--quantize_bits)")
    p.add_argument("--int8_compute", action="store_true",
                   help="with --quantize_int8 (implied): run the block matmuls as "
                        "s8 x s8 -> s32 products (W8A8; W4A8 with 4 bits)")
    p.add_argument("--int8_attention", action="store_true",
                   help="int8 QK^T scoring inside the fused self-attention kernel")
    p.add_argument("--quantize_bits", type=int, default=8, choices=(8, 4),
                   help="with --quantize_int8: int8, or nibble-packed int4")
    p.add_argument("--auto_parallel", action="store_true", help="not ported yet")
    p.add_argument("--offline_smoke", action="store_true",
                   help="random-weight model, tiny shapes unless the size flags are given")
    p.add_argument("--smoke_scale", type=str, default="1.3b",
                   choices=["1.3b", "tiny", "14b"],
                   help="random-weight model size without --model_name (tiny: "
                        "head_dim 16, the CPU only)")
    p.add_argument("--staged", action="store_true", help="not ported yet")
    p.add_argument("--moe", action="store_true", help="not ported yet")
    p.add_argument("--moe_boundary", type=float, default=0.875)
    p.add_argument("--transformer_high_path", type=str, default=None,
                   help="not ported yet")
    p.add_argument("--cfg_parallel", type=str, default="auto", choices=("auto", "on", "off"),
                   help="off: the CFG pair as two batch-1 forwards; auto and on: "
                        "one batch-2 forward")
    p.add_argument("--fit_teacache", nargs="?", const="", default=None, metavar="OUT_JSON",
                   help="not ported yet (needs --staged)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def _check_ported(args):
    from versecrafter_tpu_torch.serve.model_server import (
        STAGED, check_ported_serving_flags)

    check_ported_serving_flags(args)
    if args.fit_teacache is not None:
        raise NotImplementedError(f"--fit_teacache (with --staged) is not ported yet {STAGED}")
    if args.moe or args.transformer_high_path:
        raise NotImplementedError("the Wan2.2 two-expert MoE is not ported yet "
                                  "(ROADMAP queue 1, item 8)")


def main(argv=None):
    args = parse_args(argv)
    _check_ported(args)

    from versecrafter_tpu_torch import resolve_device
    from versecrafter_tpu_torch.serve.model_server import (
        default_pipeline_factory, run_generate_request, save_generated_video)

    dev = resolve_device(args.device)
    # --offline_smoke defaults to tiny shapes, but explicit size flags win
    defaults = (64, 64, 9, 4) if args.offline_smoke else (720, 1280, 81, 50)
    h, w = ((int(x) for x in args.sample_size.split(","))
            if args.sample_size else defaults[:2])
    if args.video_length is None:
        args.video_length = defaults[2]
    if args.num_inference_steps is None:
        args.num_inference_steps = defaults[3]

    t_build = time.perf_counter()
    if args.model_name:
        from versecrafter_tpu_torch.core.convert import load_versecrafter
        pipe = load_versecrafter(args.model_name, transformer_path=args.transformer_path,
                                 geoada_in_dim=args.geoada_in_dim,
                                 scheduler=SAMPLERS[args.sampler], device=dev)
    else:
        pipe = default_pipeline_factory(scale=args.smoke_scale, device=dev)()
        pipe.scheduler_name = SAMPLERS[args.sampler]
    t_build = time.perf_counter() - t_build

    if args.teacache_coeffs:
        with open(args.teacache_coeffs) as f:
            fit = json.load(f)
        pipe.enable_teacache(float(fit.get("threshold", args.teacache_threshold)),
                             args.teacache_skip_start,
                             coefficients=tuple(fit["coefficients"]))
    elif args.teacache_threshold > 0:
        pipe.enable_teacache(args.teacache_threshold, args.teacache_skip_start)
    if args.cfg_skip_ratio > 0:
        pipe.enable_cfg_skip(args.cfg_skip_ratio)
    pipe.cfg_parallel = args.cfg_parallel != "off"
    if args.enable_riflex:
        lat_frames = (args.video_length - 1) // pipe.vae_cfg.temporal_compression_ratio + 1
        pipe.enable_riflex(k=args.riflex_k, L_test=lat_frames)
    if args.lora_path:
        from versecrafter_tpu_torch.core.convert import load_torch_state_dict
        pipe.merge_lora(load_torch_state_dict(args.lora_path), args.lora_weight)
    if args.quantize_int8 or args.int8_compute:
        pipe.quantize_weights(int8_compute=args.int8_compute, bits=args.quantize_bits)
    if args.int8_attention:
        pipe.enable_int8_attention()

    def progress(i, n):
        print(f"denoise {i} / {n}", flush=True)

    video = run_generate_request(pipe, {
        "rendering_maps_path": args.rendering_maps_path,
        "input_image_path": args.input_image_path,
        "prompt": args.prompt,
        "negative_prompt": NEGATIVE_PROMPT,
        "height": h, "width": w, "num_frames": args.video_length,
        "num_inference_steps": args.num_inference_steps,
        "guidance_scale": args.guidance_scale, "shift": args.shift,
        "seed": args.seed, "fps": args.fps,
        "geoada_context_scale": args.geoada_context_scale,
    }, progress)
    out = save_generated_video(video, {"save_path": args.save_path, "fps": args.fps})
    prof = dict(pipe.last_wall_profile, model_build=round(t_build, 2))
    print(json.dumps({"generate_wall_profile_s": prof}), flush=True)
    print(args.prompt)
    print(out, flush=True)
    return out


if __name__ == "__main__":
    main()
