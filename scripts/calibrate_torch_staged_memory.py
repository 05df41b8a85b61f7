#!/usr/bin/env python3
"""The measurements behind versecrafter_tpu_torch/sampling/staged.py's
memory model (CARD_MODEL), on one GPU:

    python3 scripts/calibrate_torch_staged_memory.py [--out outputs/staged_memory.json]

The 14B + GeoAdapter DiT from fresh_init_factories("14b") (random weights,
seed 0) alone on the card, as staged residency holds it in the denoise
stage: its resident bytes in bf16, W8A8 (quantized in place) and W4A8
(built block by block, with the build's peak), and the peak of one denoise
step (torch.cuda.max_memory_allocated over the step, the step's inputs
included) at 480x832x81 (32,760 tokens) and 720x1280x81 (75,600), CFG
batched (one batch-2 forward) and sequential (two batch-1 forwards), with
each step's seconds. Then umT5-xxl and the VAE beside the bf16 DiT (the
resident pipeline) and the 720x1280x81 steps again. A step that runs out
of memory is recorded as such, with the bytes allocated when it failed.
Each point is printed as a JSON line, and all of them beside the card's
name and power limit are written to --out.

    python3 scripts/calibrate_torch_staged_memory.py --profile

instead times the bf16 DiT's 720x1280x81 step, CFG batched and sequential,
and splits each by kernel under torch.profiler (chip_smoke.profile_step:
device time by kernel, the device's idle share).
"""

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIZES = {"480p": (480, 832, 81), "720p": (720, 1280, 81)}
GIB = float(1 << 30)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def step_inputs(pipe, size, dev):
    """Seeded latents, GeoAdapter context, a [2, 512, text_dim] context and
    the RoPE tables of a request of `size`."""
    from versecrafter_tpu_torch.kernels.rope import grid_cos_sin
    h, w, n = size
    f, hl, wl = (n - 1) // 4 + 1, h // 8, w // 8
    g = torch.Generator(device=dev).manual_seed(81)
    lat = torch.randn(1, 16, f, hl, wl, generator=g, device=dev).to(torch.bfloat16)
    geo = torch.randn(1, 128, f, hl, wl, generator=g, device=dev).to(torch.bfloat16)
    ctx = torch.randn(2, 512, pipe.dit_cfg.text_dim, generator=g, device=dev).to(torch.bfloat16)
    cos, sin = grid_cos_sin(pipe._angles, f, hl // 2, wl // 2, device=dev)
    return lat, geo, ctx, cos, sin


def measure(pipe, mode, size_name, batched, dev, points, extra=""):
    """One denoise step's peak and seconds at `size_name`, CFG batched or
    sequential; an out-of-memory step is recorded, not raised."""
    from versecrafter_tpu_torch.sampling.pipeline import Denoiser
    inputs = step_inputs(pipe, SIZES[size_name], dev)
    lat, geo, ctx, cos, sin = inputs
    tokens = cos.shape[0]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rec = {"mode": mode, "size": size_name, "tokens": tokens,
           "cfg": "batched" if batched else "sequential", "resident": extra or "dit",
           "allocated_before_gib": before / GIB}
    t0 = time.perf_counter()
    try:
        if batched:
            pred = pipe.denoise_step(lat, 999.0, ctx, geo, cos, sin, 5.0, 1.0, True)
        else:
            pipe.cfg_parallel = False
            den = Denoiser(pipe, 1, tokens, 5.0, torch.bfloat16, 1)
            pred = den.step(0, 999.0, lat, ctx, geo, cos, sin, 1.0)
        torch.cuda.synchronize()
        rec.update(ok=True, s=time.perf_counter() - t0,
                   finite=bool(torch.isfinite(pred).all()))
        del pred
    except torch.cuda.OutOfMemoryError as e:
        rec.update(ok=False, error=str(e).splitlines()[0][:300],
                   allocated_at_failure_gib=torch.cuda.memory_allocated() / GIB)
    finally:
        pipe.cfg_parallel = True
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / GIB
    rec["reserved_peak_gib"] = torch.cuda.max_memory_reserved() / GIB
    del inputs, lat, geo, ctx, cos, sin
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps(rec), flush=True)
    points.append(rec)


def profile_720p(pipe, dev, card):
    """The 720x1280x81 step, CFG batched and then sequential: one timed run
    each, then one under torch.profiler (kernel split, idle share)."""
    import chip_smoke
    from versecrafter_tpu_torch.sampling.pipeline import Denoiser
    lat, geo, ctx, cos, sin = step_inputs(pipe, SIZES["720p"], dev)

    def batched():
        return pipe.denoise_step(lat, 999.0, ctx, geo, cos, sin, 5.0, 1.0, True)

    def sequential():
        pipe.cfg_parallel = False
        try:
            den = Denoiser(pipe, 1, cos.shape[0], 5.0, torch.bfloat16, 1)
            return den.step(0, 999.0, lat, ctx, geo, cos, sin, 1.0)
        finally:
            pipe.cfg_parallel = True

    for name, step in (("batched", batched), ("sequential", sequential)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        print(f"[calibrate] 720x1280x81 {name} CFG step {ms:.1f} ms on {card}", flush=True)
        chip_smoke.profile_step(step, ms, card, top=15)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="outputs/staged_memory.json")
    ap.add_argument("--profile", action="store_true",
                    help="the 720p steps' kernel split instead of the memory points")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate_torch_staged_memory: no CUDA device", file=sys.stderr)
        return 2
    from versecrafter_tpu_torch.sampling.pipeline import VerseCrafterPipeline
    from versecrafter_tpu_torch.sampling.staged import fresh_init_factories
    from versecrafter_tpu_torch.utils import quantize as qz

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_line()
    print(f"[calibrate] {card} | torch {torch.__version__}", flush=True)
    t_all = time.perf_counter()
    factories, dit_cfg, vae_cfg, t5_cfg = fresh_init_factories("14b", bits=0, device=dev)
    points, trees = [], {}

    def shell(dit):
        return VerseCrafterPipeline(dit_params=dit, dit_cfg=dit_cfg, vae_params=None,
                                    vae_cfg=vae_cfg, t5_params=None, t5_cfg=t5_cfg,
                                    device=dev)

    t0 = time.perf_counter()
    pipe = shell(factories.dit())
    torch.cuda.synchronize()
    trees["bf16"] = {"bytes": qz.tree_bytes(pipe.dit_params), "build_s": time.perf_counter() - t0}
    print(json.dumps({"tree": "bf16", **trees["bf16"]}), flush=True)
    measure(pipe, "bf16", "480p", True, dev, [])  # a warm-up: kernel builds, cuBLAS
    if args.profile:
        return profile_720p(pipe, dev, card)
    for size in ("480p", "720p"):
        for batched in (True, False):
            measure(pipe, "bf16", size, batched, dev, points)

    # the resident pipeline: umT5-xxl and the VAE beside the DiT
    pipe.t5_params, pipe.vae_params = factories.t5(), factories.vae()
    torch.cuda.synchronize()
    trees["t5_vae"] = {"bytes": qz.tree_bytes(pipe.t5_params) + qz.tree_bytes(pipe.vae_params)}
    print(json.dumps({"tree": "t5_vae", **trees["t5_vae"]}), flush=True)
    for batched in (False, True):
        measure(pipe, "bf16", "720p", batched, dev, points, extra="dit+t5+vae")
    pipe.t5_params = pipe.vae_params = None

    # W8A8, quantized in place (dynamic activation scales)
    qz.quantize_dit(pipe.dit_params, 8, True)
    gc.collect()
    torch.cuda.empty_cache()
    trees["w8a8"] = {"bytes": qz.tree_bytes(pipe.dit_params)}
    print(json.dumps({"tree": "w8a8", **trees["w8a8"]}), flush=True)
    for size in ("480p", "720p"):
        for batched in (True, False):
            measure(pipe, "w8a8", size, batched, dev, points)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    # W4A8, built block by block
    factories4 = fresh_init_factories("14b", bits=4, device=dev)[0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = shell(factories4.dit())
    torch.cuda.synchronize()
    trees["w4a8"] = {"bytes": qz.tree_bytes(pipe.dit_params), "build_s": time.perf_counter() - t0,
                     "build_peak_bytes": torch.cuda.max_memory_allocated()}
    print(json.dumps({"tree": "w4a8", **trees["w4a8"]}), flush=True)
    for size in ("480p", "720p"):
        measure(pipe, "w4a8", size, True, dev, points)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    result = {"card": card, "torch": torch.__version__, "total_gib": torch.cuda.get_device_properties(0).total_memory / GIB,
              "trees": trees, "points": points, "seconds": time.perf_counter() - t_all}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"[calibrate] {len(points)} points in {result['seconds']:.1f} s -> {args.out}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
