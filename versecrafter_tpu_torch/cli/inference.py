"""CLI: controlled video generation from a control-map directory.

    python -m versecrafter_tpu_torch.cli.inference --model_name <model dir> \
        --rendering_maps_path <maps> --prompt "..." --input_image_path <png> \
        --save_path outputs/inference
    python -m versecrafter_tpu_torch.cli.inference --offline_smoke --smoke_scale tiny \
        --device cpu --rendering_maps_path <maps> --prompt x --input_image_path ""
    torchrun --standalone --nproc_per_node 8 -m versecrafter_tpu_torch.cli.inference \
        --model_name <model dir> --ulysses_degree 8 --rendering_maps_path <maps> ...

The flags are the JAX package's cli/inference.py flags plus --device
(default cuda). --model_name is a reference-layout model directory
(core.convert.load_versecrafter); without it the model is the random-weight
pipeline of --smoke_scale. --offline_smoke defaults the size to 64x64x9 at
4 steps unless the size flags are given. It prints "denoise i / n" after
each step and the saved mp4's path as its last line (the API server's
subprocess tier reads both). The maps are read and the mp4 written by the
port's codecs (utils/video.py). As in the JAX CLI, --lora_path (any state dict
core.convert.load_torch_state_dict reads) is merged at --lora_weight first,
then --quantize_int8 / --int8_compute store the DiT in --quantize_bits
(W8A8 / W4A8 with --int8_compute), then --int8_attention applies. Without
a LoRA the DiT is quantized as it loads, each expert of a
low_noise_model/ + high_noise_model/ directory before the next is read, so
a Wan2.2-A14B pair fits one 80 GB card resident in int8.

--staged runs the request with staged weight residency
(sampling/staged.py): umT5, the VAE and the DiT are resident one at a
time, the DiT in --quantize_bits when a quantize flag is given (bf16
otherwise); --cfg_parallel auto lets the card's memory model choose batched
or sequential CFG (printed as {"cfg_parallel", "tokens", "est_step_gb"}),
and the stage split is printed as {"staged_profile_s": ...}. With --staged,
--fit_teacache [OUT_JSON] first records a full trajectory, fits the
TeaCache coefficients (written to OUT_JSON when given), decodes and saves
the recorded run's video, and then generates with the fit.

--moe runs the Wan2.2 two-expert timestep-MoE as an expert swap: the
high-noise expert (from --transformer_high_path, a high_noise_model/ beside
low_noise_model/ under the transformer directory, or the low expert's
checkpoint; a fresh init from seed 1 without --model_name) takes the steps
with sigma >= --moe_boundary, the low one the rest, and only one is ever
resident: each is built where the schedule crosses to it, printing
{"expert_build": which, "s": seconds}; each expert takes the LoRA and
quantize flags as it is built. Under --staged the experts come from the
staged factories (the high one from seed 1 or its checkpoint).

--ulysses_degree x --ring_degree (the sp axis) x --tp, or --auto_parallel
(core.mesh.auto_mesh_spec of the world), shard the pipeline over a
torchrun world of exactly that many ranks (NCCL on the card, gloo with
--device cpu); every rank runs the request and rank 0 writes the video
and prints. The weight flags apply before the sharding, and every quantize
flag takes every mesh axis, --tp included: each tp rank holds its slice of
the int8 / int4 codes and scales, and a W8A8 / W4A8 row product sums its
s32 partials over tp (parallel/sharding.tp_linear). --staged runs on one
device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

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
    p.add_argument("--auto_parallel", action="store_true",
                   help="factorise the torchrun world into (sp, tp) (core.mesh."
                        "auto_mesh_spec)")
    p.add_argument("--offline_smoke", action="store_true",
                   help="random-weight model, tiny shapes unless the size flags are given")
    p.add_argument("--smoke_scale", type=str, default="1.3b",
                   choices=["1.3b", "tiny", "14b"],
                   help="random-weight model size without --model_name (tiny: "
                        "head_dim 16, the CPU only)")
    p.add_argument("--staged", action="store_true",
                   help="staged weight residency: umT5 -> encode -> free, VAE -> encode "
                        "-> free, DiT -> denoise -> free, VAE -> decode")
    p.add_argument("--moe", action="store_true",
                   help="Wan2.2 two-expert timestep MoE, one expert resident at a "
                        "time (swapped where sigma crosses --moe_boundary)")
    p.add_argument("--moe_boundary", type=float, default=0.875,
                   help="sigma >= boundary selects the high-noise expert")
    p.add_argument("--transformer_high_path", type=str, default=None,
                   help="high-noise expert checkpoint dir (Wan2.2)")
    p.add_argument("--cfg_parallel", type=str, default="auto", choices=("auto", "on", "off"),
                   help="off: the CFG pair as two batch-1 forwards; on: one batch-2 "
                        "forward; auto: with --staged, batched where the card's memory "
                        "model says the batch-2 step fits (sampling.staged."
                        "auto_cfg_parallel), batched without --staged")
    p.add_argument("--fit_teacache", nargs="?", const="", default=None, metavar="OUT_JSON",
                   help="with --staged: record a full trajectory, fit TeaCache "
                        "coefficients, then generate with them (the fit saved as "
                        "OUT_JSON when given)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def expert_swap(args, pipe, dev):
    """The --moe expert swap: which -> that expert's DiT, built on `dev`
    (from its checkpoint directory, or from seed 0 / 1 for the low / high
    expert), printing its build seconds."""
    import torch

    from versecrafter_tpu_torch.serve.model_server import build_dit

    if args.model_name:
        from versecrafter_tpu_torch.core.convert import expert_dirs, load_dit
        low_dir, high_dir = expert_dirs(args.model_name, args.transformer_path,
                                        args.transformer_high_path)
        dirs = {"low": low_dir, "high": high_dir or low_dir}

        def build(which):
            return load_dit(dirs[which], pipe.dit_cfg, torch.bfloat16, dev,
                            "" if which == "low" else " (high-noise)")
    else:
        def build(which):
            return build_dit(pipe.dit_cfg, 1 if which == "high" else 0, dev)

    def swap(which):
        t0 = time.perf_counter()
        pipe.dit_params = build(which)
        apply_weight_flags(args, pipe)
        print(json.dumps({"expert_build": which,
                          "s": round(time.perf_counter() - t0, 1)}), flush=True)
        return pipe.dit_params
    return swap


def apply_weight_flags(args, pipe, quantize=True):
    """--lora_path merged at --lora_weight, then (unless quantize=False: the
    DiT was quantized as it loaded) --quantize_int8 / --int8_compute in
    --quantize_bits, on the pipeline's resident DiT."""
    if args.lora_path:
        from versecrafter_tpu_torch.core.convert import load_torch_state_dict
        pipe.merge_lora(load_torch_state_dict(args.lora_path), args.lora_weight)
    if quantize and (args.quantize_int8 or args.int8_compute):
        pipe.quantize_weights(int8_compute=args.int8_compute, bits=args.quantize_bits)


def main(argv=None):
    args = parse_args(argv)
    from versecrafter_tpu_torch import resolve_device
    from versecrafter_tpu_torch.core.mesh import check_world, spec_from_degrees, world_size
    from versecrafter_tpu_torch.serve.model_server import (
        default_pipeline_factory, resolve_mesh, run_generate_request, save_generated_video)
    from versecrafter_tpu_torch.utils.cache import maybe_init_distributed

    dev = resolve_device(args.device)
    maybe_init_distributed(dev)
    spec = spec_from_degrees(args.ulysses_degree, args.ring_degree, args.tp)
    check_world(spec if spec.size > 1 else None, args.auto_parallel)  # before any build
    # --offline_smoke defaults to tiny shapes, but explicit size flags win
    defaults = (64, 64, 9, 4) if args.offline_smoke else (720, 1280, 81, 50)
    h, w = ((int(x) for x in args.sample_size.split(","))
            if args.sample_size else defaults[:2])
    if args.video_length is None:
        args.video_length = defaults[2]
    if args.num_inference_steps is None:
        args.num_inference_steps = defaults[3]
    if args.staged:
        if world_size() > 1:
            raise ValueError("--staged runs on one device")
        return _main_staged(args, h, w, dev)

    # without a LoRA to merge into the bf16 weights first, quantized as it loads
    load_quant = ((args.quantize_bits, args.int8_compute)
                  if (args.quantize_int8 or args.int8_compute)
                  and not (args.lora_path or args.moe) else None)
    t_build = time.perf_counter()
    if args.model_name:
        from versecrafter_tpu_torch.core.convert import load_versecrafter
        pipe = load_versecrafter(args.model_name, transformer_path=args.transformer_path,
                                 geoada_in_dim=args.geoada_in_dim,
                                 scheduler=SAMPLERS[args.sampler], device=dev,
                                 load_dit_params=not args.moe, quantize=load_quant)
    else:
        pipe = default_pipeline_factory(scale=args.smoke_scale, device=dev,
                                        with_dit=not args.moe, quantize=load_quant)()
        pipe.scheduler_name = SAMPLERS[args.sampler]
    if args.moe:  # a shell: the experts are built by the swap
        pipe.expert_swap = expert_swap(args, pipe, dev)
        pipe.moe_boundary = args.moe_boundary
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
    if not args.moe:
        apply_weight_flags(args, pipe, quantize=load_quant is None)
    if args.int8_attention:
        pipe.enable_int8_attention()
    # the weights as the flags left them, sharded over the world's mesh
    pipe.set_mesh(resolve_mesh(spec if spec.size > 1 else None, args.auto_parallel,
                               pipe.dit_cfg.num_heads, dev))
    lead = pipe.mesh is None or pipe.mesh.rank == 0

    def progress(i, n):
        if lead:
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
    if not lead:
        return None
    out = save_generated_video(video, {"save_path": args.save_path, "fps": args.fps})
    prof = dict(pipe.last_wall_profile, model_build=round(t_build, 2))
    print(json.dumps({"generate_wall_profile_s": prof}), flush=True)
    print(args.prompt)
    print(out, flush=True)
    return out


def _main_staged(args, h, w, dev):
    """--staged: the request with staged weight residency (the JAX CLI's
    _main_staged). The DiT is stored in --quantize_bits only when a quantize
    flag is given. As on the JAX staged path, --lora_path and
    --enable_riflex are not applied."""
    from versecrafter_tpu_torch.sampling import teacache as tc
    from versecrafter_tpu_torch.sampling.pipeline import VerseCrafterPipeline
    from versecrafter_tpu_torch.sampling.staged import (
        _free, auto_cfg_parallel, checkpoint_factories, estimate_denoise_gb,
        fresh_init_factories, generate_staged, request_tokens)
    from versecrafter_tpu_torch.serve.model_server import (
        load_request_inputs, save_generated_video)

    bits = args.quantize_bits if (args.quantize_int8 or args.int8_compute) else 0

    def factories_of(transformer_path, seed):
        if args.model_name:
            return checkpoint_factories(
                args.model_name, transformer_path=transformer_path,
                geoada_in_dim=args.geoada_in_dim, bits=bits,
                int8_compute=args.int8_compute, device=dev)
        return fresh_init_factories(scale=args.smoke_scale, bits=bits,
                                    int8_compute=args.int8_compute, seed=seed, device=dev)

    factories, dit_cfg, vae_cfg, t5_cfg = factories_of(args.transformer_path, 0)
    tokens = request_tokens(dit_cfg, vae_cfg, h, w, args.video_length)
    cfg_par = (auto_cfg_parallel(dit_cfg, bits, tokens) if args.cfg_parallel == "auto"
               else args.cfg_parallel == "on")
    print(json.dumps({"cfg_parallel": cfg_par, "tokens": tokens,
                      "est_step_gb": round(estimate_denoise_gb(
                          dit_cfg, bits, tokens, 2 if cfg_par else 1), 2)}), flush=True)

    pipe = VerseCrafterPipeline(
        dit_params=None, dit_cfg=dit_cfg, vae_params=None, vae_cfg=vae_cfg,
        t5_params=None, t5_cfg=t5_cfg, scheduler_name=SAMPLERS[args.sampler],
        cfg_parallel=cfg_par, device=dev)
    if args.teacache_coeffs:
        with open(args.teacache_coeffs) as f:
            fit = json.load(f)
        pipe.enable_teacache(float(fit.get("threshold", args.teacache_threshold)),
                             args.teacache_skip_start, coefficients=tuple(fit["coefficients"]))
    elif args.teacache_threshold > 0 and args.fit_teacache is None:
        pipe.enable_teacache(args.teacache_threshold, args.teacache_skip_start)
    if args.cfg_skip_ratio > 0:
        pipe.enable_cfg_skip(args.cfg_skip_ratio)
    if args.int8_attention:
        pipe.enable_int8_attention()
    if args.moe:  # the high expert: its own checkpoint, or seed 1
        high = factories_of(args.transformer_high_path or args.transformer_path, 1)[0].dit

        def expert_swap(which, low=factories.dit):
            t0 = time.perf_counter()
            params = (high if which == "high" else low)()
            print(json.dumps({"expert_build": which,
                              "s": round(time.perf_counter() - t0, 1)}), flush=True)
            return params

        pipe.expert_swap = expert_swap
        pipe.moe_boundary = args.moe_boundary

    controls, mask = load_request_inputs({
        "rendering_maps_path": args.rendering_maps_path,
        "input_image_path": args.input_image_path,
        "height": h, "width": w, "num_frames": args.video_length, "fps": args.fps})
    kw = dict(control_videos=controls, mask_video=mask, height=h, width=w,
              num_frames=args.video_length, num_inference_steps=args.num_inference_steps,
              guidance_scale=args.guidance_scale, shift=args.shift, seed=args.seed,
              progress=lambda i, n: print(f"denoise {i} / {n}", flush=True))

    if args.fit_teacache is not None and not args.teacache_coeffs:
        # record -> fit -> fire; the recorded run is a full ungated generation,
        # so its latents are decoded into the first video
        rel_e0, rel_res = generate_staged(pipe, factories, args.prompt, NEGATIVE_PROMPT,
                                          record_teacache=True, **kw)
        coeffs = tc.fit_teacache_coefficients(rel_e0, rel_res, degree=4)
        thresh = float(np.median(np.polyval(coeffs, rel_e0)) * 1.5)  # ~40 % skipped
        pipe.enable_teacache(max(thresh, 1e-6), args.teacache_skip_start,
                             coefficients=coeffs)
        fit = {"coefficients": [float(c) for c in coeffs], "threshold": thresh}
        print(json.dumps({"teacache_fit": fit, "record_profile_s": pipe.last_stage_profile}),
              flush=True)
        if args.fit_teacache:
            with open(args.fit_teacache, "w") as f:
                json.dump(fit, f)
        t0 = time.perf_counter()
        pipe.vae_params = factories.vae()
        rec_video = pipe.decode_latents(pipe.last_record_latents, "uint8")
        pipe.last_record_latents = None
        _free(pipe, "vae_params")
        out0 = save_generated_video(rec_video, {"save_path": args.save_path, "fps": args.fps})
        print(json.dumps({"record_video": out0,
                          "record_decode_s": round(time.perf_counter() - t0, 1)}), flush=True)

    video = generate_staged(pipe, factories, args.prompt, NEGATIVE_PROMPT,
                            geoada_context_scale=args.geoada_context_scale, **kw)
    out = save_generated_video(video, {"save_path": args.save_path, "fps": args.fps})
    print(json.dumps({"staged_profile_s": pipe.last_stage_profile}), flush=True)
    print(args.prompt)
    print(out, flush=True)
    return out


if __name__ == "__main__":
    main()
