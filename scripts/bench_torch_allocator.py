#!/usr/bin/env python3
"""The CUDA caching allocator's expandable segments against its default
segments, on the port's generate path on one GPU.

    python3 scripts/bench_torch_allocator.py [--no-pair]
    python3 scripts/bench_torch_allocator.py --child   # one run, the env as given

Runs fresh processes in the order default, expandable, expandable,
default (PYTORCH_CUDA_ALLOC_CONF "expandable_segments:False" / "True"; the
port's import keeps a setting it finds). Each process builds the 1.3B
pipeline (random weights from seed 0), serves one 480x832x81 request at 3
UniPC steps, CFG 5, times two CFG-2 denoise steps after a warm-up, and
then (unless --no-pair) builds the Wan2.2-A14B W8A8 expert pair through
default_pipeline_factory(scale="14b", moe=True, quantize=(8, True)) and
serves one 2-step request across the 0.875 boundary, reporting an
out-of-memory error instead of raising it. Each run prints one JSON line
(seconds, milliseconds, peak allocated and reserved GiB); the parent then
prints the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (480, 832, 81)


def synth_controls(n, h, w, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n, dtype=np.float32)[None, None, :, None, None]
    yy = np.linspace(0, 1, h, dtype=np.float32)[None, None, None, :, None]
    xx = np.linspace(0, 1, w, dtype=np.float32)[None, None, None, None, :]
    controls = [0.5 + 0.5 * np.sin(2 * np.pi * (xx + yy * (c + 1) + t
                                                + rng.random((1, 3, 1, 1, 1))))
                for c in range(4)]
    mask = np.broadcast_to(((xx > 0.3) & (xx < 0.7) & (yy > 0.25)).astype(np.float32),
                           (1, 1, n, h, w)).copy()
    return [c.astype(np.float32) for c in controls], mask


def child(pair: bool):
    import torch

    from versecrafter_tpu_torch.kernels.rope import grid_cos_sin
    from versecrafter_tpu_torch.serve.model_server import default_pipeline_factory

    gib = 2.0 ** 30
    h, w, n = SIZE
    out = {"PYTORCH_CUDA_ALLOC_CONF": os.environ.get("PYTORCH_CUDA_ALLOC_CONF")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = default_pipeline_factory(scale="1.3b", seed=0)()
    torch.cuda.synchronize()
    out["build_13b_s"] = time.perf_counter() - t0
    controls, mask = synth_controls(n, h, w, 16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe("a kite over a beach", negative_prompt="blurry", control_videos=controls,
         mask_video=mask, height=h, width=w, num_frames=n, num_inference_steps=3,
         guidance_scale=5.0, seed=16, output_type="uint8")
    out["request_13b_s"] = time.perf_counter() - t0
    out["request_13b_stages"] = {k: round(v, 3) for k, v in pipe.last_wall_profile.items()}
    out["request_13b_peak_gib"] = torch.cuda.max_memory_allocated() / gib
    out["request_13b_reserved_gib"] = torch.cuda.max_memory_reserved() / gib
    g = torch.Generator(device="cuda").manual_seed(81)
    lat = torch.randn(1, 16, 21, 60, 104, generator=g, device="cuda").to(torch.bfloat16)
    geo = torch.randn(1, 128, 21, 60, 104, generator=g, device="cuda").to(torch.bfloat16)
    ctx = pipe.encode_prompt("a red car drives left", "blurry").to(torch.bfloat16)
    cos, sin = grid_cos_sin(pipe._angles, 21, 30, 52, device="cuda")
    pipe.denoise_step(lat, 999.0, ctx, geo, cos, sin, 5.0, 1.0, True)
    steps = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.denoise_step(lat, 999.0, ctx, geo, cos, sin, 5.0, 1.0, True)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    out["step_13b_ms"] = steps
    del pipe, lat, geo, ctx
    torch.cuda.empty_cache()
    if pair:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipe = default_pipeline_factory(scale="14b", seed=0, moe=True, quantize=(8, True))()
        torch.cuda.synchronize()
        out["build_pair_s"] = time.perf_counter() - t0
        out["build_pair_peak_gib"] = torch.cuda.max_memory_allocated() / gib
        out["pair_resident_gib"] = torch.cuda.memory_allocated() / gib
        out["pair_reserved_gib"] = torch.cuda.memory_reserved() / gib
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            pipe("a harbour at dawn", negative_prompt="blurry", control_videos=controls,
                 mask_video=mask, height=h, width=w, num_frames=n, timesteps=[950.0, 500.0],
                 guidance_scale=5.0, seed=31, output_type="uint8")
            out["request_pair_s"] = time.perf_counter() - t0
        except torch.cuda.OutOfMemoryError:
            out["request_pair_s"] = "out of memory"
        out["request_pair_peak_gib"] = torch.cuda.max_memory_allocated() / gib
        out["request_pair_reserved_gib"] = torch.cuda.max_memory_reserved() / gib
    print(json.dumps(out), flush=True)


def main():
    p = argparse.ArgumentParser(description="expandable segments against default segments")
    p.add_argument("--child", action="store_true")
    p.add_argument("--no-pair", action="store_true")
    args = p.parse_args()
    if args.child:
        child(not args.no_pair)
        return 0
    rc = 0
    for setting in ("False", "True", "True", "False"):
        env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": f"expandable_segments:{setting}"}
        argv = [sys.executable, os.path.abspath(__file__), "--child"]
        if args.no_pair:
            argv.append("--no-pair")
        proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True)
        print(proc.stdout.strip().splitlines()[-1] if proc.returncode == 0 and proc.stdout
              else f"expandable_segments:{setting} failed: {proc.stderr[-2000:]}", flush=True)
        rc |= proc.returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return rc


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
