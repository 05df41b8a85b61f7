#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (versecrafter_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each timed, any failure fatal (exit code != 0, no result line):
  1. environment and the kernels' build (nvcc, one process per source, all
     started together), with ptxas's registers and spills of every wgmma
     kernel: the attention kernels of csrc/fused_attention.cu,
     csrc/flash_attention.cu and csrc/flash_attention_bwd.cu and the GEMM of
     csrc/matmul_stat.cu (a ptxas warning C7512, wgmma serialised, anywhere
     in these sources or a spill in one of these kernels fails);
  2. each kernel against its plain PyTorch version at the main paths'
     shapes (480x832x81 = 32,760 tokens; 480x832x33 = 14,040 tokens; the
     training path's self 32,760 and cross 32,760 x 512 head-major shapes)
     plus a ragged shape and a k_lens/window case, bar 2*2^-8*max|plain|
     (bf16), with kernel, plain, library-yardstick and bound times, and a
     bit-identical rerun of both fused flavors at 32,760 and of the plain
     forward's two flavors at every shape; the fused (bf16 and s8) and the
     backward kernels' and the linear_rstat GEMM's wgmma / TMA tile and
     fragment layouts on integer-valued tile pairs (exact); the three fused
     flavors, the plain
     forward and the backward pair at shapes that straddle their tiles and
     CTAs; twenty back-to-back launches of each forward flavor, bit-identical;
  3. the generate path end to end: a full-width Wan2.1-1.3B + GeoAdapter
     pipeline with umT5-xxl and the Wan VAE from random weights serves two
     generate requests (480x832x81, 3 UniPC steps, CFG 5; the VAE streams
     at that size) through the serving mapping; the launch counters must
     read 45 per step per fused flavor, and the DiT on the card must agree
     with the same DiT on the CPU at a small input; one 480x832x81 control
     video through the streaming and the full-sequence VAE (in fp32 on its
     first 33 frames the two within 2*2^-8*max; in bf16 at 81 frames the
     streaming path within 2*2^-8*max of the full path's own distance from
     the fp32 result; each path's time and peak memory); one 480x832x81
     request with TeaCache and cfg-skip (8 steps),
     whose skip schedule must equal the one recomputed here from the
     timesteps' e0 and whose launches must be 45 per evaluation that ran the
     blocks; the two generate requests' uint8 frames and denoised latents are
     kept as SHA-256 digests for phase 8;
  4. one timed batched-CFG denoise step at 480x832x81 (the two timed steps'
     predictions must be bit-identical), then the same step under
     torch.profiler: device time by kernel and the device's idle share;
     the same step as sequential CFG (two batch-1 forwards), held to
     correlation > 0.999 and twice the model's noise floor of the batched
     one; then the same pipeline built from the same seed in a fresh process
     (`chip_smoke.py --denoise-digest`) runs the same step, and the SHA-256
     of its prediction, of its text embedding, of its inputs and of the DiT
     weights must equal this process's (a mismatch fails the smoke at its
     end);
  5. the training path: GeoAdapter-only training of the full-width
     Wan2.1-1.3B + GeoAdapter at 480x832x81, batch 1: loss and gradients on
     the card against the CPU at 192 tokens, a warm-up and two timed steps
     (finite losses, every trainable leaf moved, every frozen leaf
     unchanged, launch counts as derived from the model), peak memory, and
     one step under torch.profiler;
  6. the generate path's two opt-in variants on a fresh full-width
     pipeline: one 480x832x81 request with `int8_attention` through the
     serving toggle (int8-scored self-attention) and one with
     wan_dit.PROJ_STAT_FUSION on (q/k statistics from the linear_rstat
     GEMM), each with its launch counts; then one timed CFG-2 denoise step
     per variant under torch.profiler, its prediction held against the
     default path's on the same inputs, and each variant's step time beside
     the default's;
  7. the flagship: the fused attention kernels at the Wan2.1-14B width (40
     heads, [2, 32,760, 5120], cross against 512 keys) against their plain
     versions, timed, reruns bit-identical; then Wan2.1-T2V-14B + GeoAdapter
     with umT5-xxl and the Wan VAE from random weights (build time, resident
     memory), its first GeoAdapter superstep on the card against the CPU at
     192 tokens, one 480x832x81 request with TeaCache and cfg-skip (4 steps;
     schedule, 60 launches per evaluation that ran the blocks, stage split,
     peak memory), one timed CFG-2 step under torch.profiler and the same
     step as sequential CFG held to it (twice the noise floor, in max error
     and in correlation), both steps' peaks printed beside the earlier
     measurements with and without the FFN hidden held through the
     residual (fault F1);
  8. the front door: phase 3's pipeline written by this script's own
     inverse mapping as a reference-layout model directory under a
     temporary directory (config.json, the DiT and the GeoAdapter as two
     safetensors shards, Wan2.1_VAE.pth, the full umT5-xxl .pth; ~16 GB, the
     free bytes checked first), loaded through the port's
     default_pipeline_factory(model_path=...) with the configs and the
     SHA-256 of every leaf held to the built pipeline's (seconds, host RSS,
     device memory printed), then phase 3's request 0 posted to a port
     ApiServer whose tier is a port ModelServer, over HTTP on 127.0.0.1:
     the mirrored progress must never fall and end at 100, its frames must
     equal phase 3's bit for bit, and it must launch each fused flavor 45 x
     3 times (phase 3's second request, once served back to back behind
     it, was cut to keep the run inside its time; the check that it
     waited in the queue at depth 1 moved to the CPU test
     tests/test_torch_serving.py::test_model_server_queues_a_second_request).
     The card has no cv2, so the model server takes phase 3's
     synthetic control arrays through its _generate / _save override
     points; the CPU tests hold the mp4 path;
  9. quantization and LoRA: the W8A8 and W4A8 products (int8_compute_dot)
     at the 14B FFN in-projection's shape, [65,520, 5120] x [5120, 13,824],
     timed whole and split (activation quantize, int4 unpack, _int_mm, fp32
     epilogue) beside torch.addmm in bf16, with their peak bytes, the first
     1,024 rows equal to the CPU's bit for bit; LoRA training through
     cli/train.py --lora_rank 16 (three 480x832x81 batch-1 steps of the
     1.3B + GeoAdapter: finite losses, the base tree's SHA-256 unchanged,
     an up factor moved, launches as attention_launches_per_step(cfg,
     lora=True) derives, the exported step_000003_lora.safetensors read
     back equal); then phase 3's pipeline (bf16 tree kept) in five modes in
     turn (int8, int4 with group scales, W8A8 dynamic, W8A8 static with
     scales from calibrate=True on one 480x832x81 forward, W4A8): resident
     DiT bytes, a warm-up, two timed CFG-2 steps and a profiled one (idle
     share), correlation and max error against phase 4's bf16 step (the
     rebuilt pipeline's bf16 step must equal it bit for bit; reported, no
     bar: random weights), and its first GeoAdapter superstep within
     5e-2 * max of the CPU in the same mode at 192 tokens; one 3-step
     480x832x81 request with {"int8_compute": true} through
     run_loaded_request (45 launches per step per fused flavor), after which
     {"quantize_bits": 4} must raise; the trained LoRA merged at 0.55 (two
     merged leaves equal to the CPU merge bit for bit), one CFG-2 step, and
     the unmerged leaves' distance from the base in bf16 ulps. Its 14B part
     runs at the end of phase 7, on the resident 14B pipeline: quantized in
     place to W8A8, resident bytes, a warm-up and two timed CFG-2 steps
     with their peak, the first GeoAdapter superstep against the CPU;
 10. the render -> generate workflow (the Blender add-on's postprocess): a
     seeded synthetic scene (geometry/synthetic.py: a 480x832 image and
     depth, four object masks carving the background through the port's
     dilate, an 81-frame camera trajectory that moves and yaws, four moving
     Gaussians, one absent for a third of the clip, one passing behind the
     camera, one leaving the image) rendered by geometry/render.py on the
     card at 96x160x9 and held to the same code on the CPU (merged_mask
     equal on 99.9 % of its pixels, the other streams within one code on all
     but 0.1 % of their values: the CPU tests' bars against the JAX
     package), then at 480x832x81 (frame_batch 27): device and wall
     seconds, frames per second, seconds by stage (CUDA events), peak
     memory, a bit-identical rerun, each stream's shape, the Gaussians
     drawn in every frame where one is present, in front and on screen; one
     27-frame batch under torch.profiler (device time by kernel, idle
     share); then the six streams as a generate request (the way
     load_request_inputs makes them from decoded frames) served on phase
     3's 1.3B pipeline through run_loaded_request at 480x832x81, 3 steps,
     CFG 5: 45 launches a step per fused flavor, its stage split beside the
     render's wall time.
Phase 2 also holds the int8 flavor of the self-attention kernel and the
linear_rstat GEMM to their plain versions (and the int8 flavor to the exact
bf16 kernel within the int8 envelope), the GEMM at the q/k projections'
shapes, a ragged M and the Wan2.1-14B width (K = N = 5120), with twenty
back-to-back launches at M = 65,520 bit-identical.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without CUDA it exits 2 and prints no result.
"""

import dataclasses
import gc
import hashlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# datasheet peaks of an H100 SXM (dense): bf16 and int8 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12
BF16_BAR = 2 * 2.0 ** -8
TPU_KERNELS = {
    "fused_rope_rms_attention": "versecrafter_tpu/kernels/flash_attention.py:800",
    "fused_rms_cross_attention": "versecrafter_tpu/kernels/flash_attention.py:800",
    "flash_attention": "versecrafter_tpu/kernels/flash_attention.py:363",
    "fa_backward_dq": "versecrafter_tpu/kernels/flash_attention_bwd.py:100",
    "fa_backward_dkv": "versecrafter_tpu/kernels/flash_attention_bwd.py:142",
    "fused_rope_rms_attention_int8": "versecrafter_tpu/kernels/flash_attention.py:800",
    "linear_rstat": "versecrafter_tpu/kernels/matmul_stat.py:76",
    "fused_rope_rms_attention_14b": "versecrafter_tpu/kernels/flash_attention.py:800",
    "fused_rms_cross_attention_14b": "versecrafter_tpu/kernels/flash_attention.py:800",
}
SOURCES = {
    "fused_rope_rms_attention": "versecrafter_tpu_torch/csrc/fused_attention.cu",
    "fused_rms_cross_attention": "versecrafter_tpu_torch/csrc/fused_attention.cu",
    "flash_attention": "versecrafter_tpu_torch/csrc/flash_attention.cu",
    "fa_backward_dq": "versecrafter_tpu_torch/csrc/flash_attention_bwd.cu",
    "fa_backward_dkv": "versecrafter_tpu_torch/csrc/flash_attention_bwd.cu",
    "fused_rope_rms_attention_int8": "versecrafter_tpu_torch/csrc/fused_attention.cu",
    "linear_rstat": "versecrafter_tpu_torch/csrc/matmul_stat.cu",
    "fused_rope_rms_attention_14b": "versecrafter_tpu_torch/csrc/fused_attention.cu",
    "fused_rms_cross_attention_14b": "versecrafter_tpu_torch/csrc/fused_attention.cu",
}
# (B, N, Sq, Skv, window, k_lens) that straddle the fused kernel's tiles
FUSED_EDGE_CASES = [(1, 2, 193, 321, (-1, -1), None), (2, 2, 129, 64, (-1, -1), (64, 0)),
                    (1, 2, 200, 40, (-1, -1), None), (2, 2, 700, 77, (-1, -1), (77, 5)),
                    (1, 1, 32760, 192, (-1, -1), None), (1, 2, 384, 384, (64, 32), None),
                    (2, 2, 333, 333, (100, 27), (333, 0)), (1, 2, 300, 300, (-1, 0), None)]
# TeaCache requests (phases 3 and 7). With these random weights the
# rescaled e0 distance of one step is ~4,500-29,000 under the 14B
# coefficients (fitted to trained weights, whose e0 moves far less), so the
# thresholds are of that size; each makes at least one step skip and at
# least one step after skip_start calculate (expected_tea_schedule checks)
TEA_13B = {"steps": 8, "threshold": 12000.0, "skip_start": 2, "cfg_skip_ratio": 0.25}
TEA_14B = {"steps": 4, "threshold": 20000.0, "skip_start": 2, "cfg_skip_ratio": 0.25}
TEA_MARGIN = 0.05
CFG_PARALLEL_14B = True  # batched CFG-2 fits beside the 14B weights on 80 GB
VAE_EXACT_FRAMES = 33  # the fp32 stream-vs-full check's length (full path fits)
TRAIN_STEPS = 3  # a warm-up step and two timed ones
TRAIN_GRID = (21, 30, 52)  # 480x832x81: latents 21x60x104, 32,760 tokens
STEPS = 3
FRAMES_E2E = 81
E2E_SIZE = (480, 832, FRAMES_E2E)  # height, width, frames of the served requests
# phase 3's two generate requests (prompt, seed); phase 8 serves the first
# again through the HTTP tiers
E2E_REQUESTS = (("a red car drives left along a coast road", 11),
                ("a dog runs across a snowy field", 12))
# phase 9: (label, bits, int8_compute, calibrated static scales) of each
# quantize mode; the W8A8 product at the 14B FFN in-projection's shape at
# 480x832x81 CFG-2 (rows, dim, ffn_dim), its rows checked against the CPU;
# the LoRA trained and merged
QUANT_MODES = (("int8", 8, False, False), ("int4", 4, False, False),
               ("W8A8 dynamic", 8, True, False), ("W8A8 static", 8, True, True),
               ("W4A8", 4, True, False))
FFN_14B = (65520, 5120, 13824)
# phase 10: the renderer's scene (height, width, frames; seed), the small
# size at which the card's render is held to the CPU's, and the bars (the
# CPU tests' bars against the JAX package)
RENDER_SIZE = (480, 832, 81)
RENDER_SMALL = (96, 160, 9)
RENDER_SEED = 21
MASK_AGREE = 0.999  # merged_mask: share of pixels equal
BEYOND_ONE_CODE = 1e-3  # other streams: share of values more than one code apart
# F1: the 14B CFG-2 step's peak in GiB as measured before the FFN hidden
# was held through the residual, while it was, and the repaired bar; the
# sequential step's extra peak, the same two ways
PEAK_14B = (62.49, 63.57, 62.6)
SEQ_EXTRA_14B = (5.04, 5.57)
PRODUCT_CHECK_ROWS = 1024
LORA_RANK = 16
LORA_WEIGHT = 0.55


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn over reps launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def attention_inputs(fa, B, S, Skv, N, seed, dev):
    """Random raw projections, norm scales and rope tables on the card."""
    from versecrafter_tpu_torch.kernels.rope import grid_cos_sin, rope_3d_angles
    D = N * fa.HEAD_DIM
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    q, k, v = rnd(B, S, D), rnd(B, Skv, D), rnd(B, Skv, D)
    # a q scale of ~2 gives scores of std ~4: peaked softmax rows, so the
    # outputs are O(1) and not the near-zero mean of 32k random values
    gq = 2.0 + 0.2 * rnd(D, dtype=torch.float32)
    gk = 1.0 + 0.1 * rnd(D, dtype=torch.float32)
    rows = max(S, Skv)
    w = 52 if rows % 52 == 0 else 13
    cos, sin = grid_cos_sin(rope_3d_angles(fa.HEAD_DIM), -(-rows // (30 * w)), 30, w,
                            device=dev)
    return q, k, v, gq, gk, cos[:rows], sin[:rows]


def correlation(a, b):
    a = a.double().flatten()
    b = b.double().flatten()
    a = a - a.mean()
    b = b - b.mean()
    return ((a * b).sum() / (a.square().sum() * b.square().sum()).sqrt()).item()


def compare(what, got, ref, corr_bar=None, err_bar=None):
    """Correlation and max abs error of got against ref, each held to its
    bar where one is given; returns the max abs error."""
    err = (got.float() - ref.float()).abs().max().item()
    mx = ref.float().abs().max().item()
    corr = correlation(got, ref)
    ok = (math.isfinite(err) and (corr_bar is None or corr > corr_bar)
          and (err_bar is None or err <= err_bar))
    log(f"    {what}: correlation {corr:.6f} (bar {corr_bar}), max_abs_err {err:.4g} = "
        f"{err / mx:.4g} of max|ref|={mx:.4g} (bar {err_bar}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: outside its bar")
    return err


def check_kernel(fa, name, B, S, Skv, N, dev, window=(-1, -1), k_lens=None,
                 timed=False, seed=0, rerun=False):
    """Kernel vs plain on the same inputs; returns the record's numbers. The
    int8 flavor is also held to the exact bf16 kernel (int8 envelope). With
    `rerun`, a second launch on the same inputs must be bit-identical; a
    batch element with k_len 0 must write zeros."""
    rope = name.startswith("fused_rope_rms_attention")
    int8 = name == "fused_rope_rms_attention_int8"
    q, k, v, gq, gk, cos, sin = attention_inputs(fa, B, S, Skv, N, seed, dev)
    rq, rk, gqv, gkv = fa._stats_and_scales(q, k, gq, gk, 1e-6, fa.HEAD_DIM ** -0.5)
    ci, si = fa.prepare_fused_rope_tables(cos, sin) if rope else (None, None)
    kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device=dev)
    args = (q, k, v, rq, rk, gqv, gkv, ci, si)
    kw = dict(num_heads=N, window_size=window, k_lens=kl, int8_score=int8)
    got = fa.fused_attention(*args, **kw)
    torch.cuda.synchronize()
    ref = fa.fused_attention_plain(*args, **kw)
    err = (got.float() - ref.float()).abs().max().item()
    mx = ref.float().abs().max().item()
    ok = math.isfinite(err) and err <= BF16_BAR * mx
    log(f"  {name} B={B} S={S} Skv={Skv} N={N} window={window} k_lens={k_lens}: "
        f"max_abs_err={err:.4g} bar={BF16_BAR * mx:.4g} (2*2^-8*max|plain|, "
        f"max|plain|={mx:.4g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    del ref
    for b_, n_ in enumerate(k_lens or ()):
        if n_ == 0 and got[b_].abs().max().item() != 0.0:
            raise AssertionError(f"{name}: a batch element with k_len 0 wrote non-zeros")
    if rerun:
        same = torch.equal(got, fa.fused_attention(*args, **kw))
        log(f"    rerun on the same inputs bit-identical: {same}")
        if not same:
            raise AssertionError(f"{name}: a rerun on the same inputs differs")
    if int8:  # tests/test_int8_attention.py's envelope: <= 3 %·max, corr > 0.999
        exact = fa.fused_attention(*args, **{**kw, "int8_score": False})
        compare("against the exact bf16 kernel", got, exact, corr_bar=0.999,
                err_bar=0.03 * exact.float().abs().max().item())
        del exact
    rec = {"max_abs_err": err}
    if timed:
        rec["ms"] = cuda_ms(lambda: fa.fused_attention(*args, **kw), 5)
        t0 = time.perf_counter()
        fa.fused_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        rec["plain_ms"] = (time.perf_counter() - t0) * 1e3
        # yardstick only: SDPA on the pre-transformed q~/k~ (exp2 domain,
        # so scale = ln 2 gives the same function); the port never calls it
        qt = fa._qk_transform(q, rq, gqv, ci, si, N).view(B, S, N, -1).transpose(1, 2)
        kt = fa._qk_transform(k, rk, gkv, ci, si, N).view(B, Skv, N, -1).transpose(1, 2)
        vt = v.view(B, Skv, N, -1).transpose(1, 2)
        rec["library_ms"] = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, scale=math.log(2.0)), 3)
        # QK^T and PV, 2*B*N*S*Skv*D operations each; QK^T at the int8
        # rate in the int8 flavor
        product = 2 * B * N * S * Skv * fa.HEAD_DIM
        flops = 2 * product
        nbytes = (q.numel() + k.numel() + v.numel() + got.numel()) * 2 \
            + (rq.numel() + rk.numel() + gqv.numel() + gkv.numel()) * 4 \
            + ((ci.numel() + si.numel()) * 2 if rope else 0)
        rec["bound_ms"], rec["bound_by"] = (bound(product, nbytes, int8_ops=product)
                                            if int8 else bound(flops, nbytes))
        log(f"    ms={rec['ms']:.3f} plain_ms={rec['plain_ms']:.1f} "
            f"library_ms={rec['library_ms']:.3f} (SDPA, the exact bf16 function) "
            f"bound_ms={rec['bound_ms']:.3f} "
            f"({rec['bound_by']}: {flops:.3e} operations, {nbytes / 1e9:.3f} GB) "
            f"-> {flops / rec['ms'] / 1e9:.1f} T operations/s")
    del q, k, v, got
    torch.cuda.empty_cache()
    return rec


def bound(flops, nbytes, int8_ops=0):
    """(bound ms, what bounds it): the larger of the operations over their
    tensor-core peak (bf16 flops, int8 operations) and the bytes over the
    memory rate."""
    t_ops = (flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def visible_pairs(Sq, Skv, window, k_lens, B):
    """(query, key) pairs each batch element's rows can see, summed over the
    batch: the work the kernels' tile skip leaves (masked elements of a
    partial tile are still computed, so this is the least work)."""
    i = torch.arange(Sq)[:, None]
    j = torch.arange(Skv)[None, :]
    ok = torch.ones(Sq, Skv, dtype=torch.bool)
    if window[0] >= 0:
        ok &= j >= i - window[0]
    if window[1] >= 0:
        ok &= j <= i + window[1]
    lens = k_lens if k_lens is not None else (Skv,) * B
    return sum(int(ok[:, :min(n, Skv)].sum()) for n in lens)


def agree(name, got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    mx = ref.float().abs().max().item()
    ok = math.isfinite(err) and err <= BF16_BAR * mx
    log(f"    {name}: max_abs_err={err:.4g} bar={BF16_BAR * mx:.4g} "
        f"(max|plain|={mx:.4g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def check_flash(fa, fab, B, N, Sq, Skv, dev, window=(-1, -1), k_lens=None,
                timed=False, seed=0):
    """The plain flash-attention forward (both flavors) and the dQ and dK/dV
    kernels against their plain versions on the same inputs; with `timed`,
    kernel, plain, SDPA and bound times. Returns the three kernels' records."""
    D = fa.HEAD_DIM
    g = torch.Generator(device=dev).manual_seed(seed)
    # a q scale of 2 gives peaked softmax rows (outputs O(1))
    q = (2.0 * torch.randn(B, N, Sq, D, generator=g, device=dev)).to(torch.bfloat16)
    k, v = (torch.randn(B, N, Skv, D, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    do = torch.randn(B, N, Sq, D, generator=g, device=dev).to(torch.bfloat16)
    kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device=dev)
    sm = D ** -0.5
    log(f"  flash B={B} N={N} Sq={Sq} Skv={Skv} window={window} k_lens={k_lens}")
    out, m, l = fa._fa_forward(q, k, v, kl, sm, window, True)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q, k, v, kl, sm, window, stats=True)
    rec_f = {"max_abs_err": agree("forward (stats)", out, ref[0])}
    seen = ref[2] > 0
    if not (torch.equal(l > 0, seen)
            and torch.allclose(m[seen], ref[1][seen], rtol=1e-4, atol=1e-4)
            and torch.allclose(l, ref[2], rtol=1e-3, atol=0)):
        raise AssertionError("flash attention m/l disagree with the plain version")
    inf = fa._fa_forward(q, k, v, kl, sm, window, False)
    rec_f["max_abs_err"] = max(rec_f["max_abs_err"], agree(
        "forward (inference)", inf, fa.flash_attention_plain(q, k, v, kl, sm, window)))
    same = (all(torch.equal(a, b) for a, b in zip(
        (out, m, l), fa._fa_forward(q, k, v, kl, sm, window, True)))
            and torch.equal(inf, fa._fa_forward(q, k, v, kl, sm, window, False)))
    log(f"    forward reruns (both flavors) bit-identical: {same}")
    if not same:
        raise AssertionError("flash attention: a rerun on the same inputs differs")
    for b_, n_ in enumerate(k_lens or ()):
        if n_ == 0 and (out[b_].abs().max().item() != 0.0 or (l[b_] != 0).any()
                        or (m[b_] != fa.NEG_INF).any()):
            raise AssertionError("flash attention: a batch element with k_len 0 "
                                 "wrote non-zeros")
    del ref, inf
    qs, L, delta = fab.backward_preamble(q, out, m, l, do, sm)
    dq, dk, dv = fab.fa_backward(q, k, v, out, m, l, do, kl, sm, window)
    torch.cuda.synchronize()
    pdq, pdk, pdv = fab.fa_backward_plain(qs, k, v, do, L, delta, kl, sm, window)
    rec_q = {"max_abs_err": agree("dQ", dq, pdq)}
    rec_kv = {"max_abs_err": max(agree("dK", dk, pdk), agree("dV", dv, pdv))}
    del pdq, pdk, pdv
    if timed:
        pairs = visible_pairs(Sq, Skv, window, k_lens, B) * N
        io = (q.numel() + k.numel() + v.numel()) * 2
        rec_f["ms"] = cuda_ms(lambda: fa._fa_forward(q, k, v, kl, sm, window, True), 5)
        ms_inf = cuda_ms(lambda: fa._fa_forward(q, k, v, kl, sm, window, False), 5)
        rec_f["plain_ms"] = host_ms(
            lambda: fa.flash_attention_plain(q, k, v, kl, sm, window, stats=True))
        rec_f["inference_plain_ms"] = host_ms(
            lambda: fa.flash_attention_plain(q, k, v, kl, sm, window, stats=False))
        rec_q["ms"] = cuda_ms(lambda: fab._launch(
            qs, k, v, do, L, delta, kl, sm, window, True, False), 10)
        rec_kv["ms"] = cuda_ms(lambda: fab._launch(
            qs, k, v, do, L, delta, kl, sm, window, False, True), 10)
        rec_q["plain_ms"] = host_ms(lambda: fab.fa_backward_plain(
            qs, k, v, do, L, delta, kl, sm, window, True, False))
        rec_kv["plain_ms"] = host_ms(lambda: fab.fa_backward_plain(
            qs, k, v, do, L, delta, kl, sm, window, False, True))
        # yardsticks only (the port never calls SDPA): forward, and the
        # backward timed alone as one figure for dQ and dK/dV together
        rec_f["library_ms"] = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=sm), 5)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        o_sdpa = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, scale=sm)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(o_sdpa, (qg, kg, vg), do,
                                                      retain_graph=True), 5)
        rec_q["library_ms"] = rec_kv["library_ms"] = lib_bwd
        del o_sdpa, qg, kg, vg
        stats_io = 2 * B * N * Sq * 4
        for rec, products, nbytes in (
                (rec_f, 2, io + out.numel() * 2 + stats_io),
                (rec_q, 3, io + do.numel() * 2 + stats_io + dq.numel() * 2),
                (rec_kv, 4, io + do.numel() * 2 + stats_io + (dk.numel() + dv.numel()) * 2)):
            rec["bound_ms"], rec["bound_by"] = bound(2 * products * pairs * D, nbytes)
        log(f"    forward stats {rec_f['ms']:.3f} ms, inference {ms_inf:.3f} ms, "
            f"plain {rec_f['plain_ms']:.1f} ms (inference flavor "
            f"{rec_f['inference_plain_ms']:.1f} ms), SDPA {rec_f['library_ms']:.3f} ms, "
            f"bound {rec_f['bound_ms']:.3f} ms ({rec_f['bound_by']})")
        log(f"    dQ {rec_q['ms']:.3f} ms (plain {rec_q['plain_ms']:.1f}, bound "
            f"{rec_q['bound_ms']:.3f}); dK/dV {rec_kv['ms']:.3f} ms (plain "
            f"{rec_kv['plain_ms']:.1f}, bound {rec_kv['bound_ms']:.3f}); SDPA backward "
            f"{lib_bwd:.3f} ms for both")
        rec_f["inference_ms"] = ms_inf
    del q, k, v, do, out, m, l, qs, L, delta, dq, dk, dv
    torch.cuda.empty_cache()
    return {"flash_attention": rec_f, "fa_backward_dq": rec_q, "fa_backward_dkv": rec_kv}


def check_wgmma_layout(fab, dev):
    """The backward kernels' product forms on integer-valued tiles (entries
    -1, 0, 1, so every sum is exact): A B^T from swizzled shared memory and
    with A from registers, and bf16(A B^T) B with B read transposed; and the
    linear_rstat GEMM's A[:, :64] [A | B | B], A K-major and B read
    transposed, both from shared memory (n256 over A and B as one tile, then
    n128). Matrix 0 of 2 has 50 rows: rows 50..63 of its tile must read as
    zeros."""
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-1, 2, (2, 50, 128), generator=g).float()
    b = torch.randint(-1, 2, (2, 50, 128), generator=g).float()
    for which in (0, 1):
        got = fab.wgmma_layout_check(a.to(dev).bfloat16(), b.to(dev).bfloat16(), which)
        torch.cuda.synchronize()
        at, bt = torch.zeros(64, 128), torch.zeros(64, 128)
        at[:50], bt[:50] = a[which], b[which]
        want = at @ bt.T
        for name, x, ref in zip(("A B^T (shared)", "A B^T (register A)", "bf16(A B^T) B",
                                 "A [A | B | B] (shared, B transposed)"),
                                got, (want, want, want @ bt,
                                      at[:, :64] @ torch.cat([at, bt, bt], 1))):
            if not torch.equal(x.cpu(), ref):
                raise AssertionError(f"wgmma layout check, matrix {which}: {name} is not exact")
    log("  wgmma / TMA layout check: five product forms exact on integer tiles, "
        "rows past the matrix read as zeros")


def check_fused_layout(fa, dev):
    """The fused kernel's product forms on integer-valued tiles read through
    the flat tensor map at head 1 of a [1, 100, 256] tensor: A Bᵀ
    (m64n128k16, A as register fragments from the 128-row swizzled tile, B
    K-major) and bf16(A Bᵀ) B (B read MN-major, as V) on entries -1, 0, 1
    (every sum exact in bf16); the int8 flavor's s8 A Bᵀ (m64n128k32, A
    fragments from 128-byte code rows, accumulators started from the fp32
    bias) on codes -127..127. Rows 100..127 of the tiles must read as
    zeros."""
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-1, 2, (1, 100, 256), generator=g).float()
    b = torch.randint(-1, 2, (1, 100, 256), generator=g).float()
    c_s, c_pv = fa.fused_layout_check(a.to(dev).bfloat16(), b.to(dev).bfloat16(), h=1)
    torch.cuda.synchronize()
    at, bt = torch.zeros(128, 128), torch.zeros(128, 128)
    at[:100], bt[:100] = a[0, :, 128:], b[0, :, 128:]
    want = at @ bt.T
    if not (torch.equal(c_s.cpu(), want) and torch.equal(c_pv.cpu(), want @ bt)):
        raise AssertionError("fused wgmma layout check: a product is not exact")
    a8 = torch.randint(-127, 128, (1, 100, 256), generator=g, dtype=torch.int8)
    b8 = torch.randint(-127, 128, (1, 100, 256), generator=g, dtype=torch.int8)
    (c8,) = fa.fused_layout_check(a8.to(dev), b8.to(dev), h=1)
    torch.cuda.synchronize()
    at8, bt8 = (torch.zeros(128, 128, dtype=torch.int64) for _ in range(2))
    at8[:100], bt8[:100] = a8[0, :, 128:].long(), b8[0, :, 128:].long()
    if not torch.equal(c8.cpu().double(), (at8 @ bt8.T).double()):
        raise AssertionError("fused s8 wgmma layout check: the product is not exact")
    log("  fused wgmma / TMA layout check: A Bᵀ and bf16(A Bᵀ) B (bf16) and the s8 A Bᵀ "
        "exact on integer 128-row tiles at head 1 of 2, rows past the tensor read as zeros")


def check_back_to_back(fa, dev, launches=20):
    """The forward attention kernels launched `launches` times without a
    host sync between them at 32,760 q rows x 192 keys (two key tiles an
    item, so the q tile turns over fast): every output must equal the first
    bit for bit and hold 2*2^-8*max|plain|. This caught a missing proxy
    fence before the in-place q tile went back to TMA."""
    g = torch.Generator(device=dev).manual_seed(3)
    sm = fa.HEAD_DIM ** -0.5
    q = (2.0 * torch.randn(1, 1, 32760, fa.HEAD_DIM, generator=g, device=dev)).bfloat16()
    k, v = (torch.randn(1, 1, 192, fa.HEAD_DIM, generator=g, device=dev).bfloat16()
            for _ in range(2))
    qf, kf, vf, gq, gk, cos, sin = attention_inputs(fa, 1, 32760, 192, 1, 3, dev)
    rq, rk, gqv, gkv = fa._stats_and_scales(qf, kf, gq, gk, 1e-6, sm)
    ci, si = fa.prepare_fused_rope_tables(cos, sin)
    fused = (qf, kf, vf, rq, rk, gqv, gkv)
    cases = [(f"flash_attention (stats={st})",
              lambda st=st: fa._fa_forward(q, k, v, None, sm, (-1, -1), st),
              lambda st=st: fa.flash_attention_plain(q, k, v, None, sm, (-1, -1), stats=st))
             for st in (True, False)]
    for name, tabs, int8 in (("fused_rope_rms_attention", (ci, si), False),
                             ("fused_rms_cross_attention", (None, None), False),
                             ("fused_rope_rms_attention_int8", (ci, si), True)):
        kw = dict(num_heads=1, int8_score=int8)
        cases.append((name, lambda tabs=tabs, kw=kw: fa.fused_attention(*fused, *tabs, **kw),
                      lambda tabs=tabs, kw=kw: fa.fused_attention_plain(*fused, *tabs, **kw)))
    for name, run, plain in cases:
        outs = [run() for _ in range(launches)]
        torch.cuda.synchronize()
        outs = [o[0] if isinstance(o, tuple) else o for o in outs]
        ref = plain()
        ref = ref[0] if isinstance(ref, tuple) else ref
        same = sum(torch.equal(o, outs[0]) for o in outs)
        err = (outs[0].float() - ref.float()).abs().max().item()
        mx = ref.float().abs().max().item()
        log(f"  {name} x{launches} back to back at 32,760 x 192: {same}/{launches} equal "
            f"the first, max_abs_err {err:.4g} (bar {BF16_BAR * mx:.4g})")
        if same != launches or not err <= BF16_BAR * mx:
            raise AssertionError(f"{name}: back-to-back launches disagree")


PTXAS_KERNELS = {  # mangled-name fragment -> (source, flavor)
    "fused_wgmma_kernelILb1ELb0E": ("fused_attention", "RoPE"),
    "fused_wgmma_kernelILb0ELb0E": ("fused_attention", "norm-only"),
    "fused_wgmma_kernelILb1ELb1E": ("fused_attention", "int8"),
    "flash_wgmma_kernelILb1E": ("flash_attention", "stats"),
    "flash_wgmma_kernelILb0E": ("flash_attention", "inference"),
    "dq_kernel": ("flash_attention_bwd", "dQ"),
    "dkv_kernel": ("flash_attention_bwd", "dK/dV"),
    "gemm_rstat_kernel": ("matmul_stat", "linear_rstat"),
}


def ptxas_check(_build, reports):
    """Registers and spills of the wgmma kernels from ptxas's reports of
    their sources; fails on warning C7512 (every wgmma serialised for lack
    of registers) anywhere in these sources, and on a spill in any of these
    kernels."""
    found = set()
    for src, report in reports.items():
        for name, res in _build.ptxas_kernels(report).items():
            for frag, (ksrc, flavor) in PTXAS_KERNELS.items():
                if frag in name and ksrc == src:
                    found.add(frag)
                    log(f"[build] ptxas {frag.split('I')[0]} ({src}.cu, {flavor}): "
                        f"{res.get('registers')} registers (240 a consumer thread after "
                        f"setmaxnreg), spill stores {res.get('spill_stores')} B, spill loads "
                        f"{res.get('spill_loads')} B")
                    if res.get("spill_stores") or res.get("spill_loads"):
                        raise AssertionError(f"ptxas spills in {src}.cu ({flavor})")
        warnings = [line for line in report.splitlines() if "C7512" in line]
        if warnings:
            raise AssertionError(f"ptxas serialised wgmma in {src}.cu: " + warnings[0])
    if found != set(PTXAS_KERNELS):
        raise AssertionError(f"ptxas report lacks {set(PTXAS_KERNELS) - found}")
    log(f"[build] ptxas: no C7512 and no spill in {', '.join(s_ + '.cu' for s_ in reports)}")


def check_rstat(ms, M, dev, bias=True, timed=False, seed=0, K=1536, N=1536, launches=0):
    """The linear_rstat GEMM against its plain version at x [M, K] bf16 and
    W [K, N]: y within 2*2^-8*max|y|, rs within 1e-4 relative; with
    `launches`, that many more launches queued with no host sync between
    them must equal the first bit for bit; with `timed`, kernel, plain,
    library-yardstick (addmm + statistic, and addmm alone) and bound
    times."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
    p = {"kernel": (torch.randn(K, N, generator=g, device=dev) * K ** -0.5).to(torch.bfloat16)}
    if bias:
        p["bias"] = (0.1 * torch.randn(N, generator=g, device=dev)).to(torch.bfloat16)
    y, rs = ms.linear_rstat(p, x, 1e-6)
    torch.cuda.synchronize()
    ry, rrs = ms.linear_rstat_plain(x, p["kernel"], p.get("bias"), 1e-6)
    err = (y.float() - ry.float()).abs().max().item()
    mx = ry.float().abs().max().item()
    rel_rs = ((rs - rrs).abs() / rrs.abs()).max().item()
    ok = (y.shape == (M, N) and rs.shape == (M, 1) and math.isfinite(err)
          and err <= BF16_BAR * mx and rel_rs <= 1e-4)
    log(f"  linear_rstat M={M} K={K} N={N} bias={bias}: y max_abs_err={err:.4g} "
        f"bar={BF16_BAR * mx:.4g} (2*2^-8*max|y|), rs max rel err {rel_rs:.3g} "
        f"(bar 1e-4) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("linear_rstat disagrees with its plain version")
    if launches:
        outs = [ms.linear_rstat(p, x, 1e-6) for _ in range(launches)]
        torch.cuda.synchronize()
        same = sum(torch.equal(y2, y) and torch.equal(rs2, rs) for y2, rs2 in outs)
        log(f"  linear_rstat x{launches} back to back at M={M}: {same}/{launches} equal "
            f"the first")
        if same != launches:
            raise AssertionError("linear_rstat: back-to-back launches disagree")
        del outs
    rec = {"max_abs_err": err}
    if timed:
        b = p.get("bias")
        rec["ms"] = cuda_ms(lambda: ms.linear_rstat(p, x, 1e-6), 20)
        rec["plain_ms"] = host_ms(lambda: ms.linear_rstat_plain(x, p["kernel"], b, 1e-6))

        def library():  # yardstick only, two calls: cuBLAS addmm, then the statistic
            yl = torch.addmm(b, x, p["kernel"]) if b is not None else x @ p["kernel"]
            return torch.rsqrt(yl.float().square().mean(-1, keepdim=True) + 1e-6)

        rec["library_ms"] = cuda_ms(library, 20)
        rec["library_note"] = "torch.addmm + the row statistic in torch (two calls)"
        # how close the GEMM comes to cuBLAS: addmm alone, no statistic
        rec["library_gemm_ms"] = cuda_ms(
            lambda: torch.addmm(b, x, p["kernel"]) if b is not None else x @ p["kernel"], 20)
        flops = 2 * M * K * N
        nbytes = (M * K + K * N + M * N) * 2 + (N * 2 if bias else 0) + M * 4
        rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes)
        log(f"    ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.2f} "
            f"library_ms={rec['library_ms']:.4f} (addmm + statistic) "
            f"library_gemm_ms={rec['library_gemm_ms']:.4f} (addmm alone) "
            f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}: {flops:.3e} FLOP, "
            f"{nbytes / 1e6:.1f} MB) -> {flops / rec['ms'] / 1e9:.1f} TFLOP/s")
    del x, y, ry
    torch.cuda.empty_cache()
    return rec


def randomize_zero_inits(params, dev, seed=7):
    """The head and the GeoAdapter skip projections are zero-init, which
    would make every prediction constant; give them small random weights."""
    g = torch.Generator(device=dev).manual_seed(seed)
    leaves = [params["head"]["head"], params["geoada_before_proj"]]
    leaves += [gp["after_proj"] for gp in params["geoada_blocks"]]
    for leaf in leaves:
        w = leaf["kernel"]
        w.copy_(torch.randn(w.shape, generator=g, device=dev) * 0.02)


def build_pipeline(dev):
    """The full-width pipeline every generate phase uses: umT5-xxl, Wan2.1-1.3B
    + GeoAdapter and the Wan VAE from seed 0, the zero-init leaves made random
    (randomize_zero_inits, seed 7)."""
    from versecrafter_tpu_torch.serve.model_server import default_pipeline_factory
    pipe = default_pipeline_factory(scale="1.3b", device=dev, seed=0)()
    randomize_zero_inits(pipe.dit_params, dev)
    return pipe


def step_inputs(pipe, dev):
    """Phase 4's 480x832x81 CFG-2 denoise step: latents and control latents
    from seed 81, the prompt pair's embedding, the RoPE tables."""
    from versecrafter_tpu_torch.kernels.rope import grid_cos_sin
    g4 = torch.Generator(device=dev).manual_seed(81)
    lat = torch.randn(1, 16, 21, 60, 104, generator=g4, device=dev).to(torch.bfloat16)
    geo = torch.randn(1, 128, 21, 60, 104, generator=g4, device=dev).to(torch.bfloat16)
    ctx = pipe.encode_prompt("a red car drives left", "blurry").to(torch.bfloat16)
    cos, sin = grid_cos_sin(pipe._angles, 21, 30, 52, device=dev)
    return lat, geo, ctx, cos, sin


def tree_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def sha256_of(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def step_digest(pipe, lat, geo, ctx, pred):
    """SHA-256 of a phase-4 step's prediction and of what it was computed
    from (the text embedding, the two latent inputs, every DiT weight), and
    max|prediction|."""
    return {"pred": sha256_of(pred), "ctx": sha256_of(ctx), "inputs": sha256_of(lat, geo),
            "dit_weights": sha256_of(*tree_leaves(pipe.dit_params)),
            "max_abs_pred": pred.float().abs().max().item()}


def denoise_digest_main(dev):
    """`chip_smoke.py --denoise-digest`: phase 4's step in a fresh process on
    a pipeline built from the same seeds; prints its step_digest as one JSON
    line."""
    pipe = build_pipeline(dev)
    lat, geo, ctx, cos, sin = step_inputs(pipe, dev)
    pred = pipe.denoise_step(lat, 999.0, ctx, geo, cos, sin, 5.0, 1.0, True)
    torch.cuda.synchronize()
    print(json.dumps(step_digest(pipe, lat, geo, ctx, pred)), flush=True)
    return 0


def fresh_process_digest(want):
    """Runs `chip_smoke.py --denoise-digest` in a new interpreter and holds
    its digest to this process's `want`; returns the keys that differ."""
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--denoise-digest"],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"the fresh-process step failed:\n{proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    differ = [k for k in want if got.get(k) != want[k]]
    log(f"[step] the same step in a fresh process ({time.perf_counter() - t1:.1f} s): "
        f"pred {got['pred'][:16]} vs {want['pred'][:16]}, max|pred| "
        f"{got['max_abs_pred']:.6g} vs {want['max_abs_pred']:.6g}; "
        + ("every digest equal" if not differ else f"DIFFERENT: {differ}"))
    for k in ("ctx", "inputs", "dit_weights"):
        log(f"  {k}: {got[k][:16]} vs {want[k][:16]}")
    return differ


def synth_request(n_frames, h, w, seed):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n_frames, dtype=np.float32)[None, None, :, None, None]
    yy = np.linspace(0, 1, h, dtype=np.float32)[None, None, None, :, None]
    xx = np.linspace(0, 1, w, dtype=np.float32)[None, None, None, None, :]
    controls = []
    for c in range(4):
        phase = rng.random((1, 3, 1, 1, 1)).astype(np.float32)
        controls.append(0.5 + 0.5 * np.sin(2 * np.pi * (xx + yy * (c + 1) + t + phase)))
    mask = ((xx > 0.3) & (xx < 0.7) & (yy > 0.25)).astype(np.float32)
    mask = np.broadcast_to(mask, (1, 1, n_frames, h, w)).copy()
    return [c.astype(np.float32) for c in controls], mask


def profile_step(step, step_ms, card, top=15):
    """Device time by kernel over one step under torch.profiler (the `top`
    kernels printed), and the device's idle share of the unprofiled step
    time `step_ms` (the profiler's own host cost inflates the wall time it
    sees), which it returns."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t1) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    if busy_ms == 0.0:
        raise AssertionError("the profiler recorded no device time")
    copy_ms = sum(us for name, (_, us) in by_name.items() if name.startswith("Memcpy")) / 1e3
    log(f"[profile] one step under torch.profiler: device busy {busy_ms:.1f} ms "
        f"(copies {copy_ms:.1f} ms of it; profiled wall {wall_ms:.1f} ms); idle share of "
        f"the {step_ms:.1f} ms unprofiled step {1 - busy_ms / step_ms:.4f} on {card}")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"  {us / 1e3:9.1f} ms {100 * us / 1e3 / busy_ms:5.1f}% x{n:<4d} {name[:100]}")
    return 1 - busy_ms / step_ms


def train_phase(fa, fab, ms, dev, card):
    """Phase 5: GeoAdapter-only training of the full-width Wan2.1-1.3B +
    GeoAdapter at 480x832x81, batch 1 (bf16, AdamW lr 1e-4 wd 1e-2, remat):
    the card's loss and gradients against the CPU's at 192 tokens, then a
    warm-up step and two timed steps with their launch counts, and one step
    under the profiler. Returns the new kernels' launches over the steps."""
    from versecrafter_tpu_torch.cli.train import default_config, unzero_head
    from versecrafter_tpu_torch.kernels.rope import grid_cos_sin, rope_3d_angles
    from versecrafter_tpu_torch.models.wan_dit import init_wan_dit
    from versecrafter_tpu_torch.parallel.train_step import (
        attention_launches_per_step, flow_matching_loss, make_optimizer,
        make_train_step, split_trainable, tree_leaves)
    from versecrafter_tpu_torch.sampling.pipeline import _to_device
    from versecrafter_tpu_torch.utils import prng

    t0 = time.perf_counter()
    cfg = default_config()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = unzero_head(init_wan_dit(cfg, gen, torch.bfloat16), 7)
    # the GeoAdapter's zero-init projections would give zero gradients to
    # everything but after_proj on the first step
    randomize_zero_inits(params, dev, seed=8)
    train, frozen = split_trainable(params)
    n_train = sum(t.numel() for t in tree_leaves(train))
    n_all = sum(t.numel() for t in tree_leaves(params))
    log(f"[train] Wan2.1-1.3B + GeoAdapter ({len(params['geoada_blocks'])} blocks) "
        f"built in {time.perf_counter() - t0:.1f} s: {n_all / 1e9:.3f}B params, "
        f"{n_train / 1e6:.1f}M trainable")

    # the card against the CPU at 192 tokens: one loss and its gradients
    g = torch.Generator(device=dev).manual_seed(9)
    small = [torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
             for shape in ((1, 16, 3, 16, 16), (1, 512, cfg.text_dim),
                           (1, 128, 3, 16, 16), (1, 16, 3, 16, 16))]
    sig = torch.tensor([0.6], device=dev)
    ang = rope_3d_angles(cfg.head_dim)
    cos, sin = grid_cos_sin(ang, 3, 8, 8, device=dev)

    def loss_and_grads(p, tr, device):
        x0, ctx, geo, noise = (t.to(device) for t in small)
        loss = flow_matching_loss(p, cfg, x0, ctx, cos.to(device), sin.to(device),
                                  geo, sig.to(device), noise)
        loss.backward()
        grads = torch.cat([t.grad.float().flatten().cpu() for t in tree_leaves(tr)])
        for t in tree_leaves(tr):
            t.grad = None
        return loss.item(), grads

    loss_gpu, grads_gpu = loss_and_grads(params, train, dev)
    cpu_params = _to_device(params, "cpu")
    cpu_train, _ = split_trainable(cpu_params)
    loss_cpu, grads_cpu = loss_and_grads(cpu_params, cpu_train, "cpu")
    del cpu_params, cpu_train
    rel_loss = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    rel_grad = ((grads_gpu - grads_cpu).abs().max() / grads_cpu.abs().max()).item()
    log(f"[train] card vs CPU at 192 tokens (bf16, {len(params['blocks'])} + "
        f"{len(params['geoada_blocks'])} blocks): loss {loss_gpu:.6f} vs "
        f"{loss_cpu:.6f} (rel {rel_loss:.3g}), GeoAdapter grads rel err {rel_grad:.4g} "
        f"(max|grad| {grads_cpu.abs().max().item():.4g}), bar 5e-2")
    if not (rel_loss <= 5e-2 and rel_grad <= 5e-2 and torch.isfinite(grads_gpu).all()
            and grads_cpu.abs().max().item() > 0):
        raise AssertionError("training on the card disagrees with the CPU reference")
    del grads_gpu, grads_cpu, small

    # latents 16x21x60x104, control latents 128x21x60x104, text context
    # 512x4096
    f, h, w = TRAIN_GRID
    x0 = torch.randn(1, 16, f, 2 * h, 2 * w, generator=g, device=dev).to(torch.bfloat16)
    geo = torch.randn(1, 128, f, 2 * h, 2 * w, generator=g, device=dev).to(torch.bfloat16)
    ctx = torch.randn(1, 512, cfg.text_dim, generator=g, device=dev).to(torch.bfloat16)
    cos, sin = grid_cos_sin(ang, f, h, w, device=dev)
    step_fn = make_train_step(cfg, make_optimizer(train, 1e-4, 1e-2))
    train_before = [t.detach().clone() for t in tree_leaves(train)]
    frozen_before = [t.detach().clone() for t in tree_leaves(frozen)]
    n_steps = [0]

    def step():  # step i draws its noise from key(2 + i), as the train CLI does
        n_steps[0] += 1
        return step_fn(params, x0, ctx, cos, sin, geo, key=prng.key(1 + n_steps[0], dev))

    fa.reset_launch_counts()
    fab.reset_launch_counts()
    ms.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(step().item())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    counts = {**fa.LAUNCHES, **fab.LAUNCHES, **ms.LAUNCHES}
    want = {**dict.fromkeys(counts, 0),
            **{k: TRAIN_STEPS * n for k, n in attention_launches_per_step(cfg).items()}}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[train] {f}x{h}x{w} token grid ({f * h * w} tokens) batch-1 train steps: "
        f"{' '.join(f'{t:.1f}' for t in times)} ms (first is the warm-up) on {card}; "
        f"losses {' '.join(f'{x:.7f}' for x in losses)}; peak {peak:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    log(f"[train] launches over {TRAIN_STEPS} steps {counts}, derived {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    if counts != want:
        raise AssertionError(f"training launch counts {counts} != {want}")
    moved = sum(not torch.equal(a, b) for a, b in zip(train_before, tree_leaves(train)))
    if moved != len(train_before):
        raise AssertionError(f"{len(train_before) - moved} trainable leaves did not move")
    if not all(torch.equal(a, b) for a, b in zip(frozen_before, tree_leaves(frozen))):
        raise AssertionError("a frozen leaf changed")
    log(f"[train] all {moved} trainable leaves moved; all "
        f"{len(frozen_before)} frozen leaves bit-identical")
    del train_before, frozen_before
    profile_step(step, min(times[1:]), card)
    log(f"[train] {time.perf_counter() - t0:.1f} s")
    return {k: counts[k] for k in ("flash_attention", "fa_backward_dq", "fa_backward_dkv")}


def timed_step(step, label, card, reps=2, tag="variants", profile=True, top=15):
    """A warm-up, then `reps` host-timed synchronised runs of a denoise step
    and (with `profile`) one under torch.profiler; returns (prediction,
    times, the device's idle share or None)."""
    first = step()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t1 = time.perf_counter()
        pred = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    if not torch.isfinite(pred).all():
        raise AssertionError(f"non-finite {label} prediction at 480x832x81")
    log(f"[{tag}] {label}: CFG-2 denoise step "
        f"{' '.join(f'{t:.1f}' for t in times)} ms on {card}; the prediction repeats "
        f"bit for bit: {torch.equal(first, pred)}")
    idle = profile_step(step, min(times), card, top) if profile else None
    return pred, times, idle


def variants_phase(fa, fab, ms, dev, card, scale="1.3b", size=E2E_SIZE,
                   blocks=45):
    """Phase 6: the two opt-in variants of the generate path on a fresh
    full-width pipeline. One 480x832x81 request with `int8_attention`
    through the serving toggle and one with wan_dit.PROJ_STAT_FUSION on,
    each with its launch counts; then one timed CFG-2 denoise step per
    variant, profiled, its prediction held against the default step's on
    the same inputs. `blocks` is the model's 30 base + 15 GeoAdapter
    blocks. Returns the launches of both requests."""
    from versecrafter_tpu_torch.kernels.rope import grid_cos_sin
    from versecrafter_tpu_torch.models import wan_dit
    from versecrafter_tpu_torch.serve.model_server import (
        default_pipeline_factory, run_loaded_request)

    t0 = time.perf_counter()
    pipe = default_pipeline_factory(scale=scale, device=dev, seed=0)()
    randomize_zero_inits(pipe.dit_params, dev)
    h, w, n = size
    grid = ((n - 1) // 4 + 1, h // 16, w // 16)  # latent frames, token rows, columns
    launches = {}
    for label, extra, fusion, want, seed in (
            ("int8_attention request", {"int8_attention": True}, False,
             {"fused_rope_rms_attention_int8": blocks * STEPS,
              "fused_rms_cross_attention": blocks * STEPS}, 13),
            # 2 self q/k + 1 cross q projection statistic per block
            ("PROJ_STAT_FUSION request", {}, True,
             {"linear_rstat": 3 * blocks * STEPS, "fused_rope_rms_attention": blocks * STEPS,
              "fused_rms_cross_attention": blocks * STEPS}, 14)):
        controls, mask = synth_request(n, h, w, seed)
        params = {"prompt": "a boat crosses a lake at dawn", "negative_prompt": "blurry",
                  "num_inference_steps": STEPS, "guidance_scale": 5.0, "seed": seed,
                  "height": h, "width": w, "num_frames": n, **extra}
        fa.reset_launch_counts()
        fab.reset_launch_counts()
        ms.reset_launch_counts()
        wan_dit.PROJ_STAT_FUSION = fusion
        t1 = time.perf_counter()
        try:
            video = run_loaded_request(pipe, params, controls, mask)
        finally:
            wan_dit.PROJ_STAT_FUSION = False
        dt = time.perf_counter() - t1
        counts = {**fa.LAUNCHES, **fab.LAUNCHES, **ms.LAUNCHES}
        for k_, v in counts.items():
            launches[k_] = launches.get(k_, 0) + v
        log(f"[variants] {label}: {video.shape} {video.dtype} in {dt:.1f} s "
            f"{ {k_: round(v, 2) for k_, v in pipe.last_wall_profile.items()} } "
            f"launches {counts}")
        if video.shape != (1, n, h, w, 3) or video.dtype != np.uint8:
            raise AssertionError(f"bad output {video.shape} {video.dtype}")
        if float(video.std()) == 0.0:
            raise AssertionError("constant output video")
        if counts != {**dict.fromkeys(counts, 0), **want}:
            raise AssertionError(f"{label}: launch counts {counts}, want {want}")
        if wan_dit.INT8_QK_SCORE:
            raise AssertionError("the int8_attention toggle outlived its request")

    f, th, tw = grid
    g6 = torch.Generator(device=dev).manual_seed(81)
    lat = torch.randn(1, 16, f, 2 * th, 2 * tw, generator=g6, device=dev).to(torch.bfloat16)
    geo = torch.randn(1, 128, f, 2 * th, 2 * tw, generator=g6, device=dev).to(torch.bfloat16)
    ctx = pipe.encode_prompt("a red car drives left", "blurry").to(torch.bfloat16)
    cos, sin = grid_cos_sin(pipe._angles, f, th, tw, device=dev)

    def step():
        return pipe.denoise_step(lat, 999.0, ctx, geo, cos, sin, 5.0, 1.0, True)

    log(f"[variants] denoise steps at {h}x{w}x{n} ({f * th * tw} tokens)")
    def plain_linear_rstat(p, x, eps):  # the GEMM's plain version, for comparison
        y, rs = ms.linear_rstat_plain(x.reshape(-1, x.shape[-1]), p["kernel"], p.get("bias"),
                                      eps)
        return y.reshape(*x.shape[:-1], -1), rs.reshape(*x.shape[:-1], 1)

    base, base_times, _ = timed_step(step, "default path", card)
    # the noise floor of this random-weight model: its prediction moves this
    # much when the latents move by about one bf16 ulp, (1 + 2^-8)
    lat_p = (lat.float() * (1 + 2.0 ** -8)).to(lat.dtype)
    floor = compare("default step at latents x (1 + 2^-8) vs default step (noise floor)",
                    pipe.denoise_step(lat_p, 999.0, ctx, geo, cos, sin, 5.0, 1.0, True), base)
    del lat_p
    try:
        wan_dit.INT8_QK_SCORE = True
        pred, int8_times, _ = timed_step(step, "INT8_QK_SCORE", card)
        wan_dit.INT8_QK_SCORE = False
        log(f"[variants] INT8_QK_SCORE step {min(int8_times):.1f} ms beside the default "
            f"step {min(base_times):.1f} ms: {min(int8_times) / min(base_times):.4f}x")
        compare("int8 step vs default step", pred, base, corr_bar=0.999, err_bar=2 * floor)
        wan_dit.PROJ_STAT_FUSION = True
        pred, _, _ = timed_step(step, "PROJ_STAT_FUSION", card)
        # the same step with linear_rstat's plain version: same rounding
        # points, so this isolates the GEMM kernel
        wan_dit.linear_rstat = plain_linear_rstat
        ref = step()
        wan_dit.linear_rstat = ms.linear_rstat
        wan_dit.PROJ_STAT_FUSION = False
        compare("proj-stat step vs the same step with linear_rstat's plain version",
                pred, ref, corr_bar=0.999, err_bar=2 * floor)
        # the default path rounds the bf16 product, then adds the bias in
        # bf16; linear_rstat adds it in fp32 before one rounding
        compare("proj-stat step vs default step", pred, base, corr_bar=0.999,
                err_bar=2 * floor)
    finally:
        wan_dit.INT8_QK_SCORE = wan_dit.PROJ_STAT_FUSION = False
        wan_dit.linear_rstat = ms.linear_rstat
    del pipe, lat, geo, ctx, pred, base, ref
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[variants] {time.perf_counter() - t0:.1f} s")
    return launches


def expected_tea_schedule(pipe, tea):
    """The skip schedule a TeaCache request must take, recomputed here: e0 of
    each of the request's timesteps from the port's wan_dit_e0 on the card,
    then the gate's decision in numpy with the pipeline's fp32 arithmetic
    (the relative L1 drift of e0, the polynomial by Horner's rule; every CFG
    row sees the same e0). Each decision from skip_start on must clear the
    threshold by TEA_MARGIN of it, at least one of them must skip and one
    must calculate. Returns (calc per step, accumulator before each
    decision)."""
    from versecrafter_tpu_torch.models.wan_dit import wan_dit_e0
    from versecrafter_tpu_torch.sampling.schedulers import make_scheduler
    timesteps = make_scheduler(pipe.scheduler_name, pipe.scheduler_cfg).set_timesteps(
        tea["steps"], shift=16.0)  # a request's default shift
    thr, start = np.float32(tea["threshold"]), tea["skip_start"]
    calc, before, prev, accum = [], [], None, np.float32(0.0)
    for i, t in enumerate(timesteps):
        tvec = torch.full((1,), float(np.float32(t)), dtype=torch.float32, device=pipe.device)
        e0 = wan_dit_e0(pipe.dit_params, pipe.dit_cfg, tvec)[1][0].cpu().numpy()
        if prev is not None:
            rel = np.float32(np.abs(e0 - prev).mean(dtype=np.float32)
                             / max(np.abs(prev).mean(dtype=np.float32), np.float32(1e-8)))
            poly = np.float32(0.0)
            for c in pipe.teacache_coefficients:
                poly = np.float32(poly * rel + np.float32(c))
            accum = np.float32(accum + poly)
        before.append(float(accum))
        calc.append(prev is None or i < start or bool(accum >= thr))
        if i >= start and not abs(float(accum) - float(thr)) > TEA_MARGIN * float(thr):
            raise AssertionError(f"TeaCache step {i}: accumulator {float(accum):.6g} within "
                                 f"{TEA_MARGIN:.0%} of the threshold {float(thr):.6g}")
        if calc[-1]:
            accum = np.float32(0.0)
        prev = e0
    if all(calc[start:]) or not any(calc[start:]):
        raise AssertionError(f"TeaCache threshold {float(thr)} gives the schedule {calc}: "
                             "nothing to skip, or nothing calculated after skip_start")
    return calc, before


def block_evaluations(calc, tea, cfg_parallel):
    """Model evaluations that ran the blocks: one a calculating step under
    batched CFG or in the cfg-skip window, two (one a branch) under
    sequential CFG."""
    skip_from = tea["steps"] * (1.0 - tea["cfg_skip_ratio"])
    return sum((1 if cfg_parallel or i >= skip_from else 2)
               for i, c in enumerate(calc) if c)


def tea_request(fa, fab, ms, pipe, tag, tea, blocks, seed, card):
    """One 480x832x81 request with TeaCache and cfg-skip through the serving
    toggles: its skip schedule (teacache_accum_history: 0 after a step that
    ran the blocks) must equal expected_tea_schedule, each attention flavor
    must launch `blocks` times per evaluation that ran the blocks and no
    other kernel may launch, the toggles must be restored afterwards, and
    the frames must be uint8 of the right shape, not constant. Returns the
    launch counts."""
    from versecrafter_tpu_torch.models import wan_dit
    from versecrafter_tpu_torch.serve.model_server import run_loaded_request

    h, w, n = 480, 832, FRAMES_E2E
    calc, before = expected_tea_schedule(pipe, tea)
    mode = "batched CFG (cfg_parallel=True)" if pipe.cfg_parallel else \
        "sequential CFG (cfg_parallel=False)"
    log(f"[{tag}] TeaCache request: {tea['steps']} UniPC steps, threshold "
        f"{tea['threshold']}, skip_start {tea['skip_start']}, cfg_skip_ratio "
        f"{tea['cfg_skip_ratio']}, {mode}; expected schedule "
        f"{''.join('C' if c else 'S' for c in calc)} (C runs the blocks, S skips), "
        f"accumulators before each decision {[round(a, 1) for a in before]}")
    controls, mask = synth_request(n, h, w, seed)
    params = {"prompt": "a lighthouse on a cliff at dusk", "negative_prompt": "blurry",
              "num_inference_steps": tea["steps"], "guidance_scale": 5.0, "seed": seed,
              "height": h, "width": w, "num_frames": n,
              "teacache_threshold": tea["threshold"], "teacache_skip_start": tea["skip_start"],
              "cfg_skip_ratio": tea["cfg_skip_ratio"]}
    toggles = (pipe.teacache_threshold, pipe.teacache_skip_start, pipe.cfg_skip_ratio)
    fa.reset_launch_counts()
    fab.reset_launch_counts()
    ms.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    pipe.teacache_debug = True
    t1 = time.perf_counter()
    try:
        video = run_loaded_request(pipe, params, controls, mask)
    finally:
        pipe.teacache_debug = False
    dt = time.perf_counter() - t1
    counts = {**fa.LAUNCHES, **fab.LAUNCHES, **ms.LAUNCHES}
    history = pipe.teacache_accum_history
    got = [bool(np.all(a == 0.0)) for a in history]
    evals = block_evaluations(calc, tea, pipe.cfg_parallel)
    log(f"[{tag}] TeaCache request: {video.shape} {video.dtype} in {dt:.1f} s "
        f"{ {k_: round(v, 2) for k_, v in pipe.last_wall_profile.items()} } "
        f"launches {counts}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"schedule {''.join('C' if c else 'S' for c in got)}, accumulators "
        f"{[a.tolist() for a in history]}; {evals} evaluations ran the blocks")
    if video.shape != (1, n, h, w, 3) or video.dtype != np.uint8:
        raise AssertionError(f"bad output {video.shape} {video.dtype}")
    if float(video.std()) == 0.0:
        raise AssertionError("constant output video")
    if any(bool(np.any(a == 0.0)) != g for a, g in zip(history, got)):
        raise AssertionError("TeaCache rows of one step decided apart")
    if got != calc:
        raise AssertionError(f"TeaCache schedule {got} != the recomputed {calc}")
    want = {**dict.fromkeys(counts, 0), "fused_rope_rms_attention": blocks * evals,
            "fused_rms_cross_attention": blocks * evals}
    if counts != want:
        raise AssertionError(f"TeaCache request launches {counts} != {want}")
    if (pipe.teacache_threshold, pipe.teacache_skip_start, pipe.cfg_skip_ratio) != toggles \
            or wan_dit.INT8_QK_SCORE:
        raise AssertionError("a request toggle outlived its request")
    return counts


def stream_vs_full(pipe, seed, card):
    """One 480x832x81 control video through the full-sequence VAE and the
    streaming one, encoded, and the full path's latents decoded by each.

    In bf16, the pipeline's dtype, each path rounds at every conv and the
    two round differently, so neither matches the other to 2*2^-8*max:
    the bf16 streaming path must come within that bar of the bf16 full
    path's own distance from the exact result (fp32 through the streaming
    path), latents and frames; the log gives both paths' max_abs_err
    against each other, bit-identity, time and peak memory above what was
    allocated before. The streaming math is held to the full sequence in
    fp32 on the first VAE_EXACT_FRAMES frames (the fp32 full path at 81
    frames does not fit beside the weights): within 2*2^-8*max."""
    from versecrafter_tpu_torch.models.vae import vae_decode, vae_encode
    from versecrafter_tpu_torch.models.vae_stream import (vae_decode_chunked,
                                                          vae_encode_chunked)
    controls, _ = synth_request(FRAMES_E2E, 480, 832, seed)
    video = torch.as_tensor(controls[0], device=pipe.device) * 2.0 - 1.0

    def run(fn, *args):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        out = fn(pipe.vae_params, pipe.vae_cfg, *args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t1, (torch.cuda.max_memory_allocated() - base) / 2**30

    def max_err(got, ref):
        if got.shape != ref.shape:
            raise AssertionError(f"streaming VAE shape {tuple(got.shape)} != {tuple(ref.shape)}")
        return (got.float() - ref.float()).abs().max().item()

    # the streaming math: fp32, both paths, the first VAE_EXACT_FRAMES frames
    x = video[:, :, :VAE_EXACT_FRAMES].contiguous()
    z_full, z_str = vae_encode(pipe.vae_params, pipe.vae_cfg, x), vae_encode_chunked(
        pipe.vae_params, pipe.vae_cfg, x)
    y_full = vae_decode(pipe.vae_params, pipe.vae_cfg, z_full)
    y_str = vae_decode_chunked(pipe.vae_params, pipe.vae_cfg, z_full)
    for what, got, ref in (("latents", z_str, z_full), ("frames", y_str, y_full)):
        err, mx = max_err(got, ref), ref.abs().max().item()
        ok = math.isfinite(err) and err <= BF16_BAR * mx
        log(f"[e2e] VAE fp32 {what} {tuple(got.shape)}, streaming vs full sequence: "
            f"max_abs_err {err:.4g} (bar {BF16_BAR * mx:.4g} = 2*2^-8*max|full|), "
            f"bit-identical {torch.equal(got, ref)} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"streaming VAE {what} disagree with the full sequence in fp32")
    del x, z_full, z_str, y_full, y_str
    torch.cuda.empty_cache()

    # the pipeline's dtype at the full length, against the exact result
    x = video.to(torch.bfloat16)
    z_exact = vae_encode_chunked(pipe.vae_params, pipe.vae_cfg, video)
    del video
    z_full, t_ef, m_ef = run(vae_encode, x)
    z_str, t_es, m_es = run(vae_encode_chunked, x)
    del x
    y_exact = vae_decode_chunked(pipe.vae_params, pipe.vae_cfg, z_full.float())
    y_full, t_df, m_df = run(vae_decode, z_full)
    y_str, t_ds, m_ds = run(vae_decode_chunked, z_full)
    for what, got, ref, exact, tf, ts, mf, ms_ in (
            ("latents", z_str, z_full, z_exact, t_ef, t_es, m_ef, m_es),
            ("frames", y_str, y_full, y_exact, t_df, t_ds, m_df, m_ds)):
        err, mx = max_err(got, ref), exact.abs().max().item()
        err_str, err_full = max_err(got, exact), max_err(ref, exact)
        ok = math.isfinite(err_str) and err_str <= err_full + BF16_BAR * mx
        log(f"[e2e] VAE bf16 {what} {tuple(got.shape)}: streaming vs full sequence max_abs_err "
            f"{err:.4g} ({err / mx:.4g} of max), bit-identical {torch.equal(got, ref)}; "
            f"against the exact (fp32) result: streaming {err_str:.4g}, full sequence "
            f"{err_full:.4g} (bar {err_full + BF16_BAR * mx:.4g} = the full path's + "
            f"2*2^-8*max); full {tf:.2f} s, peak +{mf:.2f} GiB; streaming {ts:.2f} s, peak "
            f"+{ms_:.2f} GiB, on {card} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"streaming VAE {what} less accurate than the full sequence")
    del z_exact, z_full, z_str, y_exact, y_full, y_str
    torch.cuda.empty_cache()


def sequential_step(pipe, lat, ctx, geo, cos, sin, tag, card, reps=2):
    """The CFG-2 step as sequential CFG (two batch-1 forwards, the positive
    prompt's and then the negative one's, combined): `reps` timed runs and
    the peak memory above what was allocated before; returns the
    prediction and that peak in GiB."""
    from versecrafter_tpu_torch.sampling.pipeline import Denoiser
    pipe.cfg_parallel = False
    try:
        den = Denoiser(pipe, lat.shape[0], cos.shape[0], 5.0, torch.bfloat16, 1)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(reps):
            t1 = time.perf_counter()
            pred = den.step(0, 999.0, lat, ctx, geo, cos, sin, 1.0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
    finally:
        pipe.cfg_parallel = True
    extra = (torch.cuda.max_memory_allocated() - base) / 2**30
    log(f"[{tag}] sequential-CFG step: {' '.join(f'{t:.1f}' for t in times)} ms on {card}; "
        f"peak +{extra:.2f} GiB above the {base / 2**30:.2f} GiB allocated before it")
    return pred, extra


def dit_subtree(params, cfg, base_blocks, geoada_blocks):
    """(params, cfg) of the DiT's embeddings, head, first `base_blocks`
    blocks and first `geoada_blocks` GeoAdapter blocks (the same
    interleaving: GeoAdapter block i before base block stride * i)."""
    sub = {k: v for k, v in params.items() if k not in ("blocks", "geoada_blocks")}
    sub["blocks"] = params["blocks"][:base_blocks]
    sub["geoada_blocks"] = params["geoada_blocks"][:geoada_blocks]
    stride = cfg.resolved_geoada_layers[1] - cfg.resolved_geoada_layers[0]
    return sub, dataclasses.replace(cfg, num_layers=base_blocks,
                                    geoada_layers=tuple(range(0, base_blocks, stride)))


def dit_card_vs_cpu(pipe, params, cfg, tag, what):
    """The DiT (or a sub-tree of it) on the card against the same weights on
    the CPU at 192 tokens (bf16, CFG-2 batch), bar 5e-2 * max."""
    from versecrafter_tpu_torch.kernels.rope import grid_cos_sin
    from versecrafter_tpu_torch.models.wan_dit import wan_dit_forward
    from versecrafter_tpu_torch.sampling.pipeline import _to_device
    dev = pipe.device
    gsm = torch.Generator(device=dev).manual_seed(5)
    lat = torch.randn(1, 16, 3, 16, 16, generator=gsm, device=dev).to(torch.bfloat16)
    geo = torch.randn(1, 128, 3, 16, 16, generator=gsm, device=dev).to(torch.bfloat16)
    ctx = pipe.encode_prompt("a small check", "").to(torch.bfloat16)
    cos, sin = grid_cos_sin(pipe._angles, 3, 8, 8, device=dev)
    tvec = torch.full((2,), 700.0, device=dev)
    lat2, geo2 = torch.cat([lat, lat]), torch.cat([geo, geo])
    out_gpu = wan_dit_forward(params, cfg, lat2, tvec, ctx, cos, sin,
                              geoada_context=geo2).float().cpu()
    cpu_params = _to_device(params, "cpu")
    out_cpu = wan_dit_forward(cpu_params, cfg, lat2.cpu(), tvec.cpu(), ctx.cpu(),
                              cos.cpu(), sin.cpu(), geoada_context=geo2.cpu()).float()
    del cpu_params
    rel = ((out_gpu - out_cpu).abs().max() / out_cpu.abs().max()).item()
    log(f"[{tag}] {what} card vs CPU at 192 tokens (bf16): rel err {rel:.4g} (bar 5e-2), "
        f"finite={bool(torch.isfinite(out_gpu).all())}")
    if not (rel <= 5e-2 and torch.isfinite(out_gpu).all()):
        raise AssertionError(f"{what} on the card disagrees with the CPU reference")


def flagship_phase(fa, fab, ms, dev, card, records):
    """Phase 7: Wan2.1-T2V-14B + GeoAdapter with umT5-xxl and the Wan VAE
    (the '14b' factory, random weights from seed 0). First, with the card
    empty, the fused attention kernels at its width (40 heads: [2, 32,760,
    5120], cross against 512 context tokens), timed, with reruns; then the
    pipeline's build time and resident memory, its first GeoAdapter
    superstep (2 base + 1 GeoAdapter blocks) card vs CPU, one 480x832x81
    TeaCache + cfg-skip request, one timed CFG-2 step under the profiler and
    one sequential-CFG step held to it. Returns the request's launches."""
    from versecrafter_tpu_torch.kernels.rope import grid_cos_sin
    from versecrafter_tpu_torch.serve.model_server import default_pipeline_factory

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[14b] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the phase")
    for name, ctx_len in (("fused_rope_rms_attention", None), ("fused_rms_cross_attention", 512)):
        records[name + "_14b"] = check_kernel(fa, name, 2, 32760, ctx_len or 32760, 40, dev,
                                              timed=True, rerun=True)
    t1 = time.perf_counter()
    pipe = default_pipeline_factory(scale="14b", device=dev, seed=0)()
    randomize_zero_inits(pipe.dit_params, dev)
    torch.cuda.synchronize()
    cfg = pipe.dit_cfg
    n_dit = sum(t.numel() for t in tree_leaves(pipe.dit_params))
    log(f"[14b] pipeline built (umT5-xxl + Wan2.1-T2V-14B + GeoAdapter, {cfg.num_layers} + "
        f"{len(pipe.dit_params['geoada_blocks'])} blocks, {n_dit / 1e9:.2f}B DiT params, + Wan "
        f"VAE) in {time.perf_counter() - t1:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
    sub, sub_cfg = dit_subtree(pipe.dit_params, cfg, 2, 1)
    dit_card_vs_cpu(pipe, sub, sub_cfg, "14b", "first GeoAdapter superstep (2 base + 1 "
                    "GeoAdapter blocks of the 14B DiT)")
    del sub
    pipe.cfg_parallel = CFG_PARALLEL_14B
    counts = tea_request(fa, fab, ms, pipe, "14b", TEA_14B, 60, 21, card)

    f, th, tw = TRAIN_GRID
    g7 = torch.Generator(device=dev).manual_seed(81)
    lat = torch.randn(1, 16, f, 2 * th, 2 * tw, generator=g7, device=dev).to(torch.bfloat16)
    geo = torch.randn(1, 128, f, 2 * th, 2 * tw, generator=g7, device=dev).to(torch.bfloat16)
    ctx = pipe.encode_prompt("a red car drives left", "blurry").to(torch.bfloat16)
    cos, sin = grid_cos_sin(pipe._angles, f, th, tw, device=dev)

    def step():
        return pipe.denoise_step(lat, 999.0, ctx, geo, cos, sin, 5.0, 1.0, True)

    torch.cuda.reset_peak_memory_stats()
    base, _, _ = timed_step(step, "14B default path", card, tag="14b")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[14b] peak over the timed steps {peak:.2f} GiB (F1: {PEAK_14B[0]} before the "
        f"FFN hidden was held through the residual, {PEAK_14B[1]} while it was; the "
        f"repair's bar {PEAK_14B[2]}: "
        f"{'met' if peak <= PEAK_14B[2] else 'NOT met'}) on {card}")
    lat_p = (lat.float() * (1 + 2.0 ** -8)).to(lat.dtype)
    moved = pipe.denoise_step(lat_p, 999.0, ctx, geo, cos, sin, 5.0, 1.0, True)
    floor = compare("14B step at latents x (1 + 2^-8) vs 14B step (noise floor)", moved, base)
    # twice the noise floor, in correlation as in max error: one bf16 ulp of
    # the latents already takes this random-weight 40-layer DiT's prediction
    # below correlation 0.999, so a bar of 0.999 would fail on any rounding
    corr_bar = min(0.999, 1.0 - 2.0 * (1.0 - correlation(moved, base)))
    del lat_p, moved
    seq, extra = sequential_step(pipe, lat, ctx, geo, cos, sin, "14b", card)
    log(f"[14b] F1: the sequential-CFG step's extra peak +{extra:.2f} GiB (before "
        f"+{SEQ_EXTRA_14B[0]}, with the hidden held +{SEQ_EXTRA_14B[1]})")
    compare("14B sequential-CFG step vs batched", seq, base, corr_bar=corr_bar,
            err_bar=2 * floor)
    del seq
    quant_14b(pipe, step, base, card)  # phase 9's 14B part, while it is resident
    del pipe, lat, geo, ctx, base
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[14b] {time.perf_counter() - t0:.1f} s")
    return counts


def latent_digests(pipe):
    """Has `pipe` record the SHA-256 of the latents each request decodes
    (where two runs of a request differ, this tells the denoise from the
    decode); returns the list they are appended to."""
    seen = []
    decode = pipe.decode_latents

    def recording(latents, *a, **kw):
        seen.append(sha256_of(latents))
        return decode(latents, *a, **kw)

    pipe.decode_latents = recording
    return seen


def frames_digest(video):
    """SHA-256 of a request's uint8 frames, with their shape."""
    return hashlib.sha256(np.ascontiguousarray(video)).hexdigest() + f" {video.shape}"


def dit_state_dict(p, cfg):
    """The port's DiT + GeoAdapter tree in the reference's torch layout (this
    script's own inverse of core/convert.convert_wan_dit): Linear weights
    [out, in], patch embeddings [D, C, pt, ph, pw], modulations [1, n, D]."""
    sd = {}

    def lin(name, q):
        sd[f"{name}.weight"] = q["kernel"].t().contiguous()
        sd[f"{name}.bias"] = q["bias"]

    def patch(name, q, c):
        sd[f"{name}.weight"] = q["kernel"].t().reshape(cfg.dim, c, *cfg.patch_size).contiguous()
        sd[f"{name}.bias"] = q["bias"]

    patch("patch_embedding", p["patch_embedding"], cfg.in_dim)
    for fc, idx in (("fc1", 0), ("fc2", 2)):
        lin(f"text_embedding.{idx}", p["text_embedding"][fc])
        lin(f"time_embedding.{idx}", p["time_embedding"][fc])
    lin("time_projection.1", p["time_projection"])
    lin("head.head", p["head"]["head"])
    sd["head.modulation"] = p["head"]["modulation"][None]
    blocks = ([(f"blocks.{i}", b) for i, b in enumerate(p["blocks"])]
              + [(f"geoada_blocks.{i}", b) for i, b in enumerate(p["geoada_blocks"])])
    for pre, b in blocks:
        for attn in ("self_attn", "cross_attn"):
            for n in "qkvo":
                lin(f"{pre}.{attn}.{n}", b[attn][n])
            sd[f"{pre}.{attn}.norm_q.weight"] = b[attn]["norm_q"]["scale"]
            sd[f"{pre}.{attn}.norm_k.weight"] = b[attn]["norm_k"]["scale"]
        lin(f"{pre}.ffn.0", b["ffn_in"])
        lin(f"{pre}.ffn.2", b["ffn_out"])
        sd[f"{pre}.modulation"] = b["modulation"][None]
        sd[f"{pre}.norm3.weight"] = b["norm3"]["scale"]
        sd[f"{pre}.norm3.bias"] = b["norm3"]["bias"]
        if "after_proj" in b:
            lin(f"{pre}.after_proj", b["after_proj"])
    lin("geoada_blocks.0.before_proj", p["geoada_before_proj"])
    patch("geoada_patch_embedding", p["geoada_patch_embedding"], cfg.resolved_geoada_in_dim)
    return sd


def vae_state_dict(p):
    """The Wan VAE tree in its torch layout: the encoder's downsamples and
    the decoder's upsamples numbered over res blocks and resamples, RMS
    gammas [C, 1, 1, 1] ([C, 1, 1] in attention), 1x1 attention convs."""
    sd = {}

    def conv(name, q):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = q["kernel"], q["bias"]

    def res(pre, q):
        sd[f"{pre}.residual.0.gamma"] = q["norm1"]["gamma"].reshape(-1, 1, 1, 1)
        conv(f"{pre}.residual.2", q["conv1"])
        sd[f"{pre}.residual.3.gamma"] = q["norm2"]["gamma"].reshape(-1, 1, 1, 1)
        conv(f"{pre}.residual.6", q["conv2"])
        if "shortcut" in q:
            conv(f"{pre}.shortcut", q["shortcut"])

    def mid(pre, q):
        res(f"{pre}.middle.0", q["res1"])
        a = q["attn"]
        sd[f"{pre}.middle.1.norm.gamma"] = a["norm"]["gamma"].reshape(-1, 1, 1)
        for ours, theirs in (("qkv", "to_qkv"), ("proj", "proj")):
            sd[f"{pre}.middle.1.{theirs}.weight"] = a[ours]["kernel"].t().contiguous()[..., None, None]
            sd[f"{pre}.middle.1.{theirs}.bias"] = a[ours]["bias"]
        res(f"{pre}.middle.2", q["res2"])

    for side, stages, resample in (("encoder", "downsamples", "down"),
                                   ("decoder", "upsamples", "up")):
        q = p[side]
        conv(f"{side}.conv1", q["conv_in"])
        idx = 0
        for st in q["stages"]:
            for r in st["res"]:
                res(f"{side}.{stages}.{idx}", r)
                idx += 1
            if resample in st:
                conv(f"{side}.{stages}.{idx}.resample.1", st[resample]["conv"])
                if "time_conv" in st[resample]:
                    conv(f"{side}.{stages}.{idx}.time_conv", st[resample]["time_conv"])
                idx += 1
        mid(side, q["mid"])
        sd[f"{side}.head.0.gamma"] = q["norm_out"]["gamma"].reshape(-1, 1, 1, 1)
        conv(f"{side}.head.2", q["conv_out"])
    conv("conv1", p["encoder"]["quant_conv"])
    conv("conv2", p["decoder"]["post_quant_conv"])
    return sd


def t5_state_dict(p):
    """The umT5 encoder tree in the Wan t5.py layout."""
    sd = {"token_embedding.weight": p["embed"], "norm.weight": p["final_norm"]}
    for i, b in enumerate(p["blocks"]):
        pre = f"blocks.{i}"
        for n in "qkvo":
            sd[f"{pre}.attn.{n}.weight"] = b["attn"][n].t().contiguous()
        sd[f"{pre}.pos_embedding.embedding.weight"] = b["attn"]["rel_bias"]
        sd[f"{pre}.norm1.weight"] = b["norm1"]
        sd[f"{pre}.norm2.weight"] = b["norm2"]
        for ours, theirs in (("wi_0", "gate.0"), ("wi_1", "fc1"), ("wo", "fc2")):
            sd[f"{pre}.ffn.{theirs}.weight"] = b["ffn"][ours].t().contiguous()
    return sd


def export_reference_layout(pipe, d):
    """Writes `pipe` as a reference-layout model directory: config.json, the
    DiT in one safetensors shard and the GeoAdapter in another,
    Wan2.1_VAE.pth and models_t5_umt5-xxl-enc-bf16.pth (torch.save copies one
    storage at a time to the host). Returns {file: bytes}."""
    from versecrafter_tpu_torch.core.convert import save_safetensors
    cfg = pipe.dit_cfg
    keys = ("model_type", "patch_size", "in_dim", "dim", "ffn_dim", "freq_dim", "text_dim",
            "out_dim", "num_heads", "num_layers", "geoada_in_dim")
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({k: getattr(cfg, k) for k in keys}, f)
    sizes = {"config.json": os.path.getsize(os.path.join(d, "config.json"))}
    dit = dit_state_dict(pipe.dit_params, cfg)
    for i, part in enumerate(({k: v for k, v in dit.items() if not k.startswith("geoada")},
                              {k: v for k, v in dit.items() if k.startswith("geoada")})):
        name = f"diffusion_pytorch_model-{i + 1:05d}-of-00002.safetensors"
        sizes[name] = save_safetensors(os.path.join(d, name), part)
    del dit
    for name, sd in (("Wan2.1_VAE.pth", vae_state_dict(pipe.vae_params)),
                     ("models_t5_umt5-xxl-enc-bf16.pth", t5_state_dict(pipe.t5_params))):
        torch.save(sd, os.path.join(d, name))
        sizes[name] = os.path.getsize(os.path.join(d, name))
        del sd
        torch.cuda.empty_cache()
    return sizes


def tree_digests(pipe):
    """SHA-256 over every DiT, VAE and T5 leaf of `pipe` (sorted keys), with
    each tree's leaf shapes and dtypes; the three hashed on threads."""
    def digest(tree):
        leaves = list(tree_leaves(tree))
        return sha256_of(*leaves), [(tuple(t.shape), str(t.dtype)) for t in leaves]
    with ThreadPoolExecutor(max_workers=3) as pool:
        jobs = {k: pool.submit(digest, getattr(pipe, f"{k}_params")) for k in ("dit", "vae", "t5")}
        return {k: j.result() for k, j in jobs.items()}


def host_rss():
    """(resident, resident and not file-backed) bytes of this process now,
    from /proc/self/statm."""
    with open("/proc/self/statm") as f:
        _, resident, shared = (int(v) for v in f.read().split()[:3])
    page = os.sysconf("SC_PAGE_SIZE")
    return resident * page, (resident - shared) * page


class RssSampler:
    """The largest host_rss() values seen every 20 ms while the block runs."""

    def __enter__(self):
        import threading
        self.start = self.peak = host_rss()
        self._stop = threading.Event()

        def run():
            while not self._stop.wait(0.02):
                self.peak = tuple(map(max, self.peak, host_rss()))
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = tuple(map(max, self.peak, host_rss()))


def http_json(url, body=None):
    """GET (or POST `body` as JSON) -> the JSON answer."""
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def front_door_phase(fa, fab, ms, dev, card, direct):
    """Phase 8: phase 3's pipeline written as a reference-layout checkpoint
    directory by this script's own inverse mapping, loaded through the
    port's default_pipeline_factory(model_path=...) (configs and the SHA-256
    of every leaf held to the built pipeline's), then phase 3's request 0
    posted to a port ApiServer whose tier is a port ModelServer, both over
    HTTP on 127.0.0.1. Its frames must equal phase 3's bit for bit, and it
    must launch each fused flavor 45 x STEPS times. Returns (the launches,
    a failure message or None)."""
    import resource
    import shutil
    import tempfile

    from versecrafter_tpu_torch.serve import api_server as api_mod
    from versecrafter_tpu_torch.serve import model_server as msrv
    from versecrafter_tpu_torch.serve.http import make_server, serve_forever_in_thread

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    # 1. the checkpoint directory
    pipe = build_pipeline(dev)
    torch.cuda.synchronize()
    want_cfgs = (pipe.dit_cfg, pipe.vae_cfg, pipe.t5_cfg)
    need = sum(t.numel() * t.element_size() for k in ("dit", "vae", "t5")
               for t in tree_leaves(getattr(pipe, f"{k}_params")))
    roots = {r: shutil.disk_usage(r).free
             for r in (tempfile.gettempdir(), os.path.dirname(os.path.abspath(__file__)))}
    root = max(roots, key=roots.get)
    log(f"[front] free bytes: {roots}; the checkpoint needs {need} bytes; writing under {root}")
    if roots[root] < need * 1.02:
        raise AssertionError(f"only {roots[root]} bytes free under {root}: the 1.3B "
                             f"reference-layout checkpoint needs {need} (~16 GB)")
    t1 = time.perf_counter()
    want = tree_digests(pipe)
    log(f"[front] SHA-256 of the built pipeline's leaves in {time.perf_counter() - t1:.1f} s: "
        + ", ".join(f"{k} {v[0][:16]} ({len(v[1])} leaves)" for k, v in want.items()))
    d = tempfile.mkdtemp(prefix="versecrafter_ckpt_", dir=root)
    api_dir = tempfile.mkdtemp(prefix="versecrafter_api_")
    servers = []
    try:
        t1 = time.perf_counter()
        sizes = export_reference_layout(pipe, d)
        log(f"[front] wrote {sum(sizes.values())} bytes in {time.perf_counter() - t1:.1f} s: {sizes}")
        del pipe
        gc.collect()
        torch.cuda.empty_cache()

        # 2. load it through the port
        maxrss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        mem0 = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        with RssSampler() as rss:
            loaded = msrv.default_pipeline_factory(model_path=d, device=dev)()
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        maxrss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        log(f"[front] loaded through default_pipeline_factory(model_path=...) in {load_s:.1f} s; "
            f"host peak RSS (ru_maxrss) {maxrss0} -> {maxrss1} bytes; RSS (all, not "
            f"file-backed) {rss.start} before the load, {host_rss()} after, largest sampled "
            f"during it {rss.peak}; device memory resident "
            f"{(torch.cuda.memory_allocated() - mem0) / 2**30:.2f} GiB "
            f"(torch.cuda.memory_allocated {torch.cuda.memory_allocated()} bytes)")
        got_cfgs = (loaded.dit_cfg, loaded.vae_cfg, loaded.t5_cfg)
        if got_cfgs != want_cfgs:
            raise AssertionError(f"loaded configs {got_cfgs} != built {want_cfgs}")
        got = tree_digests(loaded)
        bad = [k for k in want if got[k] != want[k]]
        log(f"[front] configs equal; SHA-256 of every leaf: "
            + ", ".join(f"{k} {got[k][0][:16]}" for k in got)
            + (" - all equal to the built pipeline's" if not bad else f" - DIFFERENT: {bad}"))
        if bad:
            raise AssertionError(f"the loaded checkpoint's {bad} leaves differ from the built ones")
        decoded = latent_digests(loaded)

        # 3. both serving tiers over HTTP
        class SmokeModelServer(msrv.ModelServer):
            """Serves phase 3's synthetic control videos (no cv2 here to read
            mp4 maps) and keeps each request's digests, times and launches."""

            def _generate(self, pipe, params, progress):
                seed = int(params["seed"])
                n_, h_, w_ = (int(params[k]) for k in ("num_frames", "height", "width"))
                t2 = time.perf_counter()
                controls, mask = synth_request(n_, h_, w_, seed)
                t3 = time.perf_counter()
                before = dict(fa.LAUNCHES)
                video = msrv.run_loaded_request(pipe, params, controls, mask, progress)
                served[seed] = {
                    "inputs_s": t3 - t2, "s": time.perf_counter() - t3,
                    "profile": dict(pipe.last_wall_profile),
                    "latents": decoded[-1], "frames": frames_digest(video),
                    "launches": {k: v - before.get(k, 0) for k, v in fa.LAUNCHES.items()}}
                return video

            def _save(self, video, params):
                return f"(frames kept in memory, seed {params['seed']})"

        def serve(router):
            httpd = make_server(router, "127.0.0.1", 0)
            serve_forever_in_thread(httpd)
            servers.append(httpd)
            return f"http://127.0.0.1:{httpd.server_address[1]}"

        served = {}
        ms_url = serve(msrv.build_router(SmokeModelServer(lambda: loaded)))
        api_url = serve(api_mod.build_router(api_mod.ApiServer(
            workdir=api_dir, model_server_url=ms_url, subprocess_fallback=False, device=dev)))
        log(f"[front] ModelServer at {ms_url}, ApiServer at {api_url} (model_server_url "
            f"{ms_url}, no subprocess fallback)")
        log("[front] mp4 decoding and encoding did not run on this machine (no cv2 here): "
            "the served requests take phase 3's synthetic control arrays through "
            "ModelServer._generate / _save; tests/test_torch_video_io.py and "
            "tests/test_torch_serving.py hold the mp4 path to the JAX package on the CPU")
        health = http_json(f"{ms_url}/health")
        log(f"[front] GET /health before the first request: {health}")
        if health["model_loaded"] is not False:
            raise AssertionError(f"/health before the first request: {health}")
        h, w, n = E2E_SIZE
        fa.reset_launch_counts()
        fab.reset_launch_counts()
        ms.reset_launch_counts()
        posted, tasks = {}, {}
        for prompt, seed in E2E_REQUESTS[:1]:
            posted[seed] = time.perf_counter()
            tasks[seed] = http_json(f"{api_url}/api/generate", {
                "rendering_maps_path": f"maps_{seed}", "prompt": prompt,
                "negative_prompt": "blurry", "num_inference_steps": STEPS,
                "guidance_scale": 5.0, "seed": seed, "height": h, "width": w,
                "num_frames": n})["task_id"]
        progress = {seed: [] for seed in tasks}
        done = {}
        while len(done) < len(tasks):
            if time.perf_counter() - posted[E2E_REQUESTS[0][1]] > 1200:
                raise AssertionError("the served request did not finish in 1200 s")
            for seed, task in tasks.items():
                if seed in done:
                    continue
                st = http_json(f"{api_url}/api/status/{task}")
                progress[seed].append(st["progress"])
                if st["status"] in ("COMPLETED", "FAILED"):
                    done[seed] = (st, time.perf_counter() - posted[seed])
            time.sleep(0.5)
        for seed, (st, dt) in done.items():
            srv = served.get(seed, {})
            log(f"  seed {seed}: {st['status']} through ApiServer -> ModelServer in {dt:.1f} s "
                f"(in the model server: synthetic inputs {srv.get('inputs_s', float('nan')):.1f} "
                f"s, request {srv.get('s', float('nan')):.1f} s, last_wall_profile "
                f"{ {k: round(v, 2) for k, v in srv.get('profile', {}).items()} }; "
                f"direct in phase 3 {direct[seed]['s']:.1f} s "
                f"{ {k: round(v, 2) for k, v in direct[seed]['profile'].items()} }); "
                f"progress seen {progress[seed]}; launches {srv.get('launches')}")
            if st["status"] != "COMPLETED":
                raise AssertionError(f"served request seed {seed}: {st}")
            if progress[seed] != sorted(progress[seed]) or progress[seed][-1] != 100:
                raise AssertionError(f"mirrored progress of seed {seed}: {progress[seed]}")
        log(f"[front] /metrics after the request: {http_json(f'{ms_url}/metrics')}")
        counts = dict(fa.LAUNCHES)
        per = 45 * STEPS
        want_counts = {"fused_rope_rms_attention": per, "fused_rms_cross_attention": per,
                       "fused_rope_rms_attention_int8": 0, "flash_attention": 0}
        per_request = [served[s]["launches"] for s in tasks]
        if (counts != want_counts or any(fab.LAUNCHES.values()) or any(ms.LAUNCHES.values())
                or any(c["fused_rope_rms_attention"] != per or c["fused_rms_cross_attention"] != per
                       for c in per_request)):
            raise AssertionError(f"served launches {counts} (per request {per_request}) "
                                 f"{fab.LAUNCHES} {ms.LAUNCHES} != {want_counts}")
        seed0 = E2E_REQUESTS[0][1]
        got0, want0 = served[seed0], direct[seed0]
        same = got0["frames"] == want0["frames"]
        log(f"[front] served request 0 (seed {seed0}) frames {got0['frames'][:16]} vs phase 3 "
            f"{want0['frames'][:16]}: " + ("bit-identical" if same else "DIFFERENT")
            + f"; denoised latents {got0['latents'][:16]} vs {want0['latents'][:16]} "
            + ("equal" if got0["latents"] == want0["latents"] else "DIFFERENT"))
        differ = None if same else (
            f"served request 0's frames differ from phase 3's (latents "
            f"{'equal' if got0['latents'] == want0['latents'] else 'differ'})")
        after = http_json(f"{ms_url}/health")
        unloaded = http_json(f"{ms_url}/unload", {})
        log(f"[front] GET /health after: {after}; POST /unload: {unloaded}")
        if not after["model_loaded"] or not unloaded["unloaded"]:
            raise AssertionError(f"/health {after}, /unload {unloaded} after the requests")
        return counts, differ
    finally:
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()
        shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(api_dir, ignore_errors=True)
        loaded = None
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[front] {time.perf_counter() - t0:.1f} s")


def bf16_ulps(a, b):
    """Per-element distance of two bf16 tensors in bf16 ulps (the bit
    patterns mapped onto one monotonic integer line)."""
    def key(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (key(a) - key(b)).abs()


def ulps_of(t, d):
    """|d| in ulps of the bf16 values t (an ulp of x is 2^(e - 8) for
    |x| = m 2^e, m in [0.5, 1))."""
    _, e = torch.frexp(t.float())
    return d.abs() / torch.ldexp(torch.ones_like(d), e - 8)


def w8a8_product(dev, card):
    """Phase 9, first part: the W8A8 and W4A8 products at the 14B FFN's
    in-projection (x [65,520, 5120] bf16 against [5120, 13,824]) timed whole
    and split into activation quantize / s8 product / fp32 epilogue (and the
    int4 unpack), beside torch.addmm in bf16; the call's peak bytes; its
    first PRODUCT_CHECK_ROWS rows equal to the same function on the CPU bit
    for bit."""
    from versecrafter_tpu_torch.utils import quantize as qz

    M, K, N = FFN_14B
    g = torch.Generator(device=dev).manual_seed(90)
    x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
    lim = math.sqrt(6.0 / (K + N))
    w = ((torch.rand(K, N, generator=g, device=dev) * 2 - 1) * lim).to(torch.bfloat16)
    bias = (torch.randn(N, generator=g, device=dev) * 0.01).to(torch.bfloat16)
    addmm_ms = cuda_ms(lambda: torch.addmm(bias, x, w), 10)
    flops = 2.0 * M * K * N
    log(f"[quant] the 14B FFN in-projection [{M}, {K}] x [{K}, {N}]: torch.addmm bf16 "
        f"{addmm_ms:.3f} ms ({flops / addmm_ms / 1e9:.1f} TFLOP/s) on {card}")
    for label, bits in (("W8A8", 8), ("W4A8", 4)):
        leaf = qz.tag_block(qz.quantize_block({"ffn_in": {"kernel": w}}, "blocks", 1, bits,
                                              0 if bits == 4 else None),
                            "blocks", 0, 1)["ffn_in"]["kernel"]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = qz.int8_compute_dot(leaf, x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        whole_ms = cuda_ms(lambda: qz.int8_compute_dot(leaf, x), 5)
        wv = qz._product_weight(leaf)  # column-major [K, N]
        unpack_ms = cuda_ms(lambda: qz._product_weight(leaf), 5) if bits == 4 else 0.0

        a, xq = qz._quantize_rows(x, None)
        act_ms = cuda_ms(lambda: qz._quantize_rows(x, None), 5)
        mm_ms = cuda_ms(lambda: qz._int_mm(xq, wv), 5)
        y = qz._int_mm(xq, wv)
        w_rows = wv.contiguous()  # the same weight row-major (N contiguous)
        row_major_ms = cuda_ms(lambda: torch._int_mm(xq, w_rows), 3)
        same_layouts = torch.equal(torch._int_mm(xq, w_rows), y)
        del w_rows

        def epilogue():
            return qz._rescale(y, a, leaf["qscales"], x.dtype)

        epi_ms = cuda_ms(epilogue, 5)
        same_split = torch.equal(epilogue(), out)
        del y, xq, a
        wbytes = wv.numel() * (0.5 if bits == 4 else 1)
        bound_ms = max(flops / PEAK_INT8_OPS, (2 * M * K + wbytes + 2 * M * N)
                       / PEAK_BYTES_PER_S) * 1e3
        cpu_leaf = {k: v.cpu() for k, v in leaf.items()}
        ref = qz.int8_compute_dot(cpu_leaf, x[:PRODUCT_CHECK_ROWS].cpu())
        equal = torch.equal(out[:PRODUCT_CHECK_ROWS].cpu(), ref)
        rel = ((out.float() - (x @ w).float()).abs().max() / out.float().abs().max()).item()
        log(f"[quant] {label} product (int8_compute_dot, per-row dynamic scales): "
            f"{whole_ms:.3f} ms whole = activation quantize {act_ms:.3f} + "
            + (f"int4 unpack {unpack_ms:.3f} + " if bits == 4 else "")
            + f"_int_mm {mm_ms:.3f} ({flops / mm_ms / 1e9:.1f} TOP/s) + fp32 epilogue "
            f"{epi_ms:.3f} ms (the split recomposes the call's bits: {same_split}); "
            f"{whole_ms / addmm_ms:.3f}x torch.addmm; bound {bound_ms:.3f} ms; peak "
            f"{peak / 2**30:.3f} GiB above its inputs (output {M * N * 2 / 2**30:.3f} GiB); "
            f"max|diff| against the bf16 product {rel:.4g} of max; on {card}")
        log(f"[quant] {label} product: _int_mm with the weight row-major instead "
            f"{row_major_ms:.3f} ms ({flops / row_major_ms / 1e9:.1f} TOP/s), the same "
            f"bits: {same_layouts}")
        log(f"[quant] {label} product: the card's first {PRODUCT_CHECK_ROWS} rows equal the "
            f"CPU's bit for bit: {equal}")
        if not (equal and same_split and same_layouts):
            raise AssertionError(f"the {label} product on the card differs from the CPU's")
        del out, leaf, cpu_leaf, ref, wv
        gc.collect()
        torch.cuda.empty_cache()


def lora_train(fa, fab, ms, dev, card, out_dir):
    """Phase 9, LoRA training: `cli/train.py --synthetic 1 --steps 3
    --lora_rank 16` at the default width (the 1.3B + GeoAdapter, bf16) and
    480x832x81, in this process: finite losses, the base tree's SHA-256
    before (the CLI's own build from the same seed) and after equal, some up
    factor moved off zero, the launches equal to
    attention_launches_per_step(cfg, lora=True) a step, and the exported
    step_000003_lora.safetensors read back through the port's reader equal
    to the factors. Returns (export path, launches)."""
    from versecrafter_tpu_torch.cli import train as tcli
    from versecrafter_tpu_torch.core.convert import load_torch_state_dict
    from versecrafter_tpu_torch.parallel.train_step import attention_launches_per_step
    from versecrafter_tpu_torch.utils.lora import lora_to_torch_sd

    t0 = time.perf_counter()
    args = tcli.parse_args(["--synthetic", "1", "--steps", str(TRAIN_STEPS), "--lora_rank",
                            str(LORA_RANK), "--output_dir", out_dir, "--log_every", "1"])
    cfg, params = tcli.build_model(args, dev)
    before = sha256_of(*tree_leaves(params))
    del params
    fa.reset_launch_counts()
    fab.reset_launch_counts()
    ms.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out = tcli.run(args)
    counts = {**fa.LAUNCHES, **fab.LAUNCHES, **ms.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {**dict.fromkeys(counts, 0),
            **{k: TRAIN_STEPS * n for k, n in attention_launches_per_step(cfg, lora=True).items()}}
    after = sha256_of(*tree_leaves(out["params"]))
    factors = out["train"]
    n_factors = sum(t.numel() for t in tree_leaves(factors))
    up_max = max(f["up"].abs().max().item() for g in factors.values() for f in g.values())
    log(f"[lora] LoRA rank {LORA_RANK} over {len(out['params']['blocks'])} + "
        f"{len(out['params']['geoada_blocks'])} blocks ({n_factors / 1e6:.2f}M factors), "
        f"{TRAIN_GRID[0]}x{TRAIN_GRID[1]}x{TRAIN_GRID[2]} tokens batch 1: train steps "
        f"{' '.join(f'{1e3 * t:.1f}' for t in out['step_s'])} ms (first is the warm-up) on "
        f"{card}; losses {' '.join(f'{x:.7f}' for x in out['losses'])}; peak {peak:.2f} GiB; "
        f"max|up| {up_max:.4g}")
    log(f"[lora] launches over {TRAIN_STEPS} steps {counts}, derived {want}")
    log(f"[lora] SHA-256 of the base tree before {before[:16]}, after {after[:16]}")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"non-finite LoRA loss {out['losses']}")
    if counts != want:
        raise AssertionError(f"LoRA launch counts {counts} != {want}")
    if before != after:
        raise AssertionError("LoRA training changed the base tree")
    if not up_max > 0:
        raise AssertionError("no LoRA up factor moved")
    path = os.path.join(out_dir, f"step_{TRAIN_STEPS:06d}_lora.safetensors")
    sd = load_torch_state_dict(path)
    want_sd = lora_to_torch_sd(factors)
    same = sorted(sd) == sorted(want_sd) and all(torch.equal(sd[k], v)
                                                 for k, v in want_sd.items())
    log(f"[lora] {os.path.basename(path)}: {os.path.getsize(path)} bytes, {len(sd)} tensors, "
        f"read back equal to the factors: {same}; phase {time.perf_counter() - t0:.1f} s")
    if not same:
        raise AssertionError("the exported LoRA differs from the trained factors")
    del out, factors, want_sd
    gc.collect()
    torch.cuda.empty_cache()
    return path, {k: counts[k] for k in ("flash_attention", "fa_backward_dq", "fa_backward_dkv")}


def quant_phase(fa, fab, ms, dev, card, bf16_step):
    """Phase 9: quantization and LoRA (see the module docstring). bf16_step:
    phase 4's step on the same pipeline and inputs ({"pred", "ms",
    "idle"}), which each mode's step is held beside. Returns the main
    path's launches: the LoRA steps' and the W8A8 request's."""
    import tempfile

    from versecrafter_tpu_torch.core.convert import load_torch_state_dict
    from versecrafter_tpu_torch.models.wan_dit import wan_dit_forward
    from versecrafter_tpu_torch.serve.model_server import run_loaded_request
    from versecrafter_tpu_torch.sampling.pipeline import _to_device
    from versecrafter_tpu_torch.utils import quantize as qz
    from versecrafter_tpu_torch.utils.lora import _target, merge_lora

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[quant] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the phase")
    w8a8_product(dev, card)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        lora_path, counts = lora_train(fa, fab, ms, dev, card, tmp)
        for k_, v in counts.items():
            launches[k_] = launches.get(k_, 0) + v
        lora_sd = dict(load_torch_state_dict(lora_path).items())

    pipe = build_pipeline(dev)
    cfg = pipe.dit_cfg
    base = pipe.dit_params
    lat, geo, ctx, cos, sin = step_inputs(pipe, dev)

    def step():
        return pipe.denoise_step(lat, 999.0, ctx, geo, cos, sin, 5.0, 1.0, True)

    ref = step()
    if not torch.equal(ref, bf16_step["pred"]):
        raise AssertionError("the rebuilt pipeline's bf16 step differs from phase 4's")
    rows = [("bf16 (phase 4)", qz.tree_bytes(base), bf16_step["ms"], bf16_step["idle"], 1.0,
             0.0)]
    t1 = time.perf_counter()
    _, stats = wan_dit_forward(base, cfg, torch.cat([lat, lat]), torch.full((2,), 999.0,
                               device=dev), ctx, cos, sin,
                               geoada_context=torch.cat([geo, geo]), calibrate=True)
    scales = qz.fit_act_scales([stats])
    log(f"[quant] calibrate=True on one 480x832x81 CFG-2 forward + fit_act_scales: "
        f"{time.perf_counter() - t1:.1f} s, {len(scales)} sites, scales "
        f"{ {k: round(v.max().item(), 4) for k, v in scales.items()} } (max over blocks)")
    for label, bits, compute, static in QUANT_MODES:
        pipe.dit_params = base
        t1 = time.perf_counter()
        pipe.quantize_weights(int8_compute=compute, bits=bits,
                              act_scales=scales if static else None)
        torch.cuda.synchronize()
        nbytes = qz.tree_bytes(pipe.dit_params)
        log(f"[quant] {label}: quantized in {time.perf_counter() - t1:.2f} s, resident DiT "
            f"{nbytes / 2**30:.3f} GiB (bf16 {qz.tree_bytes(base) / 2**30:.3f} GiB)")
        pred, times, idle = timed_step(step, label, card, reps=1, tag="quant", top=6)
        err = (pred.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
        rows.append((label, nbytes, min(times), idle, correlation(pred, ref), err))
        sub, sub_cfg = dit_subtree(pipe.dit_params, cfg, 2, 1)
        dit_card_vs_cpu(pipe, sub, sub_cfg, "quant", f"{label}: first GeoAdapter superstep "
                        "(2 base + 1 GeoAdapter blocks)")
        del pred, sub
    pipe.dit_params = base
    log(f"[quant] 1.3B, 480x832x81 CFG-2 step by mode on {card} (mode: resident DiT GiB, "
        f"best step ms, idle share, correlation and max|diff|/max against the bf16 step):")
    for label, nbytes, ms_, idle, corr, err in rows:
        log(f"  {label:13s} {nbytes / 2**30:8.3f} GiB {ms_:9.1f} ms idle {idle:.4f} "
            f"corr {corr:.6f} err {err:.4g}")

    # a 3-step W8A8 request through the serving mapping, then another mode
    h, w, n = E2E_SIZE
    controls, mask = synth_request(n, h, w, 16)
    params = {"prompt": "a kite over a beach", "negative_prompt": "blurry",
              "num_inference_steps": STEPS, "guidance_scale": 5.0, "seed": 16,
              "height": h, "width": w, "num_frames": n, "int8_compute": True}
    fa.reset_launch_counts()
    fab.reset_launch_counts()
    ms.reset_launch_counts()
    t1 = time.perf_counter()
    video = run_loaded_request(pipe, params, controls, mask)
    dt = time.perf_counter() - t1
    counts = {**fa.LAUNCHES, **fab.LAUNCHES, **ms.LAUNCHES}
    log(f"[quant] W8A8 request ({{'int8_compute': true}}): {video.shape} {video.dtype} in "
        f"{dt:.1f} s {({k_: round(v, 2) for k_, v in pipe.last_wall_profile.items()})} "
        f"launches {counts}; resident as {pipe._quantized} (bits, int8_compute)")
    blocks = len(base["blocks"]) + len(base["geoada_blocks"])
    want = {**dict.fromkeys(counts, 0), "fused_rope_rms_attention": blocks * STEPS,
            "fused_rms_cross_attention": blocks * STEPS}
    if video.shape != (1, n, h, w, 3) or video.dtype != np.uint8 or float(video.std()) == 0:
        raise AssertionError(f"bad W8A8 output {video.shape} {video.dtype}")
    if counts != want:
        raise AssertionError(f"W8A8 request launches {counts} != {want}")
    for k_ in ("fused_rope_rms_attention", "fused_rms_cross_attention"):
        launches[k_] = launches.get(k_, 0) + counts[k_]
    try:
        run_loaded_request(pipe, {**params, "int8_compute": False, "quantize_bits": 4},
                           controls, mask)
    except ValueError as e:
        log(f"[quant] then {{'quantize_bits': 4}} raises ValueError: {e}")
    else:
        raise AssertionError("a request for another quantize mode did not raise")
    pipe.dit_params = base
    del pipe._quantized

    # the trained LoRA merged at 0.55 into this (phase 3's) pipeline
    pipe.merge_lora(lora_sd, LORA_WEIGHT)
    merged = pipe.dit_params
    for mod in ("blocks.0.self_attn.q", f"geoada_blocks.{len(base['geoada_blocks']) - 1}.ffn.2"):
        pair = {k: v for k, v in lora_sd.items() if k.startswith(mod + ".")}
        grp, layer = mod.split(".")[0], int(mod.split(".")[1])
        node = _target(base, mod)
        one_block = {grp: [None] * layer + [_to_device(base[grp][layer], "cpu")]}
        cpu = _target(merge_lora(one_block, pair, LORA_WEIGHT), mod)["kernel"]
        card_k = _target(merged, mod)["kernel"]
        same = torch.equal(card_k.cpu(), cpu)
        log(f"[lora] merged {mod} ({tuple(card_k.shape)} {card_k.dtype}) equals the CPU "
            f"merge bit for bit: {same}; moved {bf16_ulps(card_k, node['kernel']).max().item()} "
            f"ulps at most")
        if not same:
            raise AssertionError(f"the merged {mod} differs from the CPU merge")
    t1 = time.perf_counter()
    pred = step()
    torch.cuda.synchronize()
    log(f"[lora] CFG-2 step with the LoRA merged at {LORA_WEIGHT}: "
        f"{(time.perf_counter() - t1) * 1e3:.1f} ms, finite {bool(torch.isfinite(pred).all())}, "
        f"correlation {correlation(pred, ref):.6f} with the base step")
    if not torch.isfinite(pred).all():
        raise AssertionError("non-finite prediction with the LoRA merged")
    pipe.unmerge_lora(lora_sd, LORA_WEIGHT)
    bits, of_merged, exact, elems, rel = [], [], 0, 0, 0.0
    for key in lora_sd:
        if key.endswith(".lora_down.weight"):
            mod = key[: -len(".lora_down.weight")]
            back, b0 = _target(pipe.dit_params, mod)["kernel"], _target(base, mod)["kernel"]
            d = back.float() - b0.float()
            bits.append(bf16_ulps(back, b0).max().item())
            of_merged.append(ulps_of(_target(merged, mod)["kernel"], d).max().item())
            exact += int((d == 0).sum())
            elems += d.numel()
            rel = max(rel, (d.abs().max() / b0.float().abs().max()).item())
    log(f"[lora] unmerged: {len(bits)} leaves, {exact}/{elems} elements back bit for bit "
        f"({exact / elems:.6f}); per leaf the largest distance from the base in bf16 ulps of "
        f"the base value: {min(bits)} to {max(bits)} (median {sorted(bits)[len(bits) // 2]}: "
        f"elements near 0, whose ulp is tiny, take an ulp of the merged value they were "
        f"rounded at), in ulps of the merged value: at most {max(of_merged):.3g}; largest "
        f"|unmerged - base| {rel:.3g} of the leaf's max|base|")
    del pipe, base, merged, ref, pred, lora_sd, lat, geo, ctx
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[quant] phase 9 {time.perf_counter() - t0:.1f} s")
    return launches


def quant_14b(pipe, step, bf16_pred, card):
    """Phase 9, 14B part (run inside phase 7, while the 14B pipeline is
    resident): the pipeline quantized in place to W8A8, its resident memory,
    one CFG-2 step (a warm-up and two timed) with its peak, and its first
    GeoAdapter superstep against the CPU at 192 tokens."""
    from versecrafter_tpu_torch.utils import quantize as qz

    t0 = time.perf_counter()
    dit_bf16 = qz.tree_bytes(pipe.dit_params)
    pipe.quantize_weights(int8_compute=True, bits=8)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[14b-w8a8] quantized in place in {dt:.1f} s: DiT {dit_bf16 / 2**30:.2f} -> "
        f"{qz.tree_bytes(pipe.dit_params) / 2**30:.2f} GiB, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
    torch.cuda.reset_peak_memory_stats()
    pred, times, _ = timed_step(step, "14B W8A8", card, reps=1, tag="14b-w8a8",
                                profile=False)
    err = (pred.float() - bf16_pred.float()).abs().max() / bf16_pred.float().abs().max()
    log(f"[14b-w8a8] peak over the steps {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"against the bf16 step: correlation {correlation(pred, bf16_pred):.6f}, max|diff| "
        f"{err.item():.4g} of max")
    sub, sub_cfg = dit_subtree(pipe.dit_params, pipe.dit_cfg, 2, 1)
    dit_card_vs_cpu(pipe, sub, sub_cfg, "14b-w8a8", "W8A8 first GeoAdapter superstep (2 base "
                    "+ 1 GeoAdapter blocks of the 14B DiT)")
    log(f"[14b-w8a8] {time.perf_counter() - t0:.1f} s")


def render_inputs(h, w, n, seed):
    """Phase 10's seeded scene (geometry/synthetic.py) and the arguments of
    render_control_maps for it: the background carved by the dilated
    object masks (no cv2 here: the port's own dilate), the OpenCV
    world-to-camera trajectory, the Gaussians and their colours."""
    from versecrafter_tpu_torch.geometry.coords import blender_c2w_to_opencv_w2c
    from versecrafter_tpu_torch.geometry.pointcloud import build_background
    from versecrafter_tpu_torch.geometry.splat import TAB20
    from versecrafter_tpu_torch.geometry.synthetic import synthetic_scene
    s = synthetic_scene(h, w, n, seed)
    pts, cols = build_background(s["image"], s["depth"], s["K"],
                                 s["masks"].any(0).astype(np.uint8))
    return s, (pts, cols, s["K"], blender_c2w_to_opencv_w2c(s["c2w_blender"]), s["means"],
               s["covs"], s["present"], TAB20[s["color_idx"]], (h, w))


def maps_agree(tag, got, want):
    """Holds two renders' uint8 streams to the CPU tests' bars (merged_mask
    equal on MASK_AGREE of its pixels, every other stream within one code
    on all but BEYOND_ONE_CODE of its values); logs the figures."""
    for name in want:
        d = np.abs(got[name].astype(np.int16) - want[name].astype(np.int16))
        differ, beyond = float((d > 0).any(-1).mean()), float((d > 1).mean())
        ok = (1 - differ >= MASK_AGREE) if name == "merged_mask" else beyond <= BEYOND_ONE_CODE
        log(f"  {tag} {name}: {differ:.3e} of pixels differ, {beyond:.3e} of values by "
            f"more than one code {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag}: {name} outside its bar")


def visible_objects(scene, w2c):
    """[T] bool: frames where some Gaussian is present, in front of the
    camera (depth > 0.5, the projection's own cut) and projects its centre
    inside the image."""
    h, w = scene["depth"].shape
    K = scene["K"]
    pc = np.einsum("tij,tkj->tki", w2c[:, :3, :3].astype(np.float64),
                   scene["means"].astype(np.float64)) + w2c[:, None, :3, 3]
    z = pc[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = K[0, 0] * pc[..., 0] / z + K[0, 2]
        v = K[1, 1] * pc[..., 1] / z + K[1, 2]
    return (scene["present"] & (z > 0.5) & (u >= 0) & (u < w) & (v >= 0) & (v < h)).any(1)


def maps_to_request(maps, image):
    """The six rendered streams as a generate request's inputs, the way
    load_request_inputs makes them from decoded frames: the four control
    clips [1, 3, T, H, W] in [0, 1], merged_mask's first channel with frame
    0 zeroed, the input image over control 0's frame 0."""
    from versecrafter_tpu_torch.serve.model_server import CONTROL_NAMES

    def clip(name):
        return np.ascontiguousarray(
            (maps[name].astype(np.float32) / 255.0).transpose(3, 0, 1, 2)[None])
    controls = [clip(name[:-len(".mp4")]) for name in CONTROL_NAMES]
    mask = np.ascontiguousarray(clip("merged_mask")[:, :1])
    mask[:, :, 0] = 0.0
    controls[0][:, :, 0] = image.astype(np.float32).transpose(2, 0, 1) / 255.0
    return controls, mask


def copy_rates(stream, dev, card, reps=3):
    """Whether a pinned copy would pay: logs the rate (GB/s, best of
    `reps`) of one rendered uint8 stream copied from the card into pageable
    numpy memory (as render_control_maps copies) and into page-locked
    memory."""
    x = torch.from_numpy(stream).to(dev)
    pageable = np.empty(stream.shape, np.uint8)
    pinned = torch.empty(stream.shape, dtype=torch.uint8, pin_memory=True)
    rates = {}
    for label, dst in (("pageable", torch.from_numpy(pageable)), ("pinned", pinned)):
        best = math.inf
        for _ in range(reps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dst.copy_(x)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t1)
        rates[label] = x.numel() / best / 1e9
    log(f"[render] device -> host copy of one {x.numel() / 1e6:.1f} MB stream: pageable "
        f"{rates['pageable']:.2f} GB/s, pinned {rates['pinned']:.2f} GB/s on {card}")


def workflow_phase(fa, fab, ms, dev, card):
    """Phase 10: the render -> generate workflow of the Blender add-on's
    postprocess. The renderer on the card against the same code on the CPU
    at RENDER_SMALL; at 480x832x81 (frame_batch 27) its time split, stages,
    peak and a bit-identical rerun, each stream's shape and the Gaussians
    in every frame that shows one; one 27-frame batch under torch.profiler;
    then the six streams as a 3-step request on phase 3's 1.3B pipeline
    through run_loaded_request (45 launches a step per fused flavor).
    Returns the request's launches."""
    from versecrafter_tpu_torch.geometry import render as tr
    from versecrafter_tpu_torch.serve.model_server import run_loaded_request
    t0 = time.perf_counter()
    log(f"[render] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the phase")
    _, small = render_inputs(*RENDER_SMALL, RENDER_SEED)
    t1 = time.perf_counter()
    on_card = tr.render_control_maps(*small, frame_batch=4, device=dev)
    t2 = time.perf_counter()
    on_cpu = tr.render_control_maps(*small, frame_batch=4, device="cpu")
    log(f"[render] {'x'.join(map(str, RENDER_SMALL))} on the card ({t2 - t1:.2f} s, the "
        f"first call) against the CPU ({time.perf_counter() - t2:.2f} s):")
    maps_agree("card vs CPU", on_card, on_cpu)

    h, w, n = RENDER_SIZE
    t1 = time.perf_counter()
    scene, args = render_inputs(h, w, n, RENDER_SEED)
    log(f"[render] scene {h}x{w}x{n}: {len(args[0])} background points of {h * w} pixels, "
        f"{scene['means'].shape[1]} Gaussians, present in {int(scene['present'].sum())} of "
        f"{scene['present'].size} slots; host set-up {time.perf_counter() - t1:.2f} s")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    maps = tr.render_control_maps(*args, device=dev)
    first = dict(tr.last_render_profile)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    again = tr.render_control_maps(*args, device=dev)
    prof = dict(tr.last_render_profile)
    same = all(np.array_equal(maps[k], again[k]) for k in maps)
    del again
    for label, p in (("first call", first), ("second call", prof)):
        log(f"[render] {h}x{w}x{n}, frame_batch 27, {label}: device {p['device_s']:.4f} s "
            f"({p['device_fps']:.2f} frames/s), download {p['download_s']:.4f} s, wall "
            f"{p['wall_s']:.4f} s; by stage (CUDA events) "
            f"{ {k: round(v, 5) for k, v in p['stages_s'].items()} } on {card}")
    log(f"[render] peak {peak:.3f} GiB above the {base / 2**30:.2f} GiB allocated before it; "
        f"depth range {prof['depth_range']}; the rerun's streams are bit-identical: {same}")
    if not same:
        raise AssertionError("a rerun of the render gave other streams")
    for name, v in maps.items():
        if v.shape != (n, h, w, 3) or v.dtype != np.uint8:
            raise AssertionError(f"{name}: {v.shape} {v.dtype}")
    shown = visible_objects(scene, args[3])
    drawn = maps["3D_gaussian_RGB"].any(-1).any((1, 2))
    log(f"[render] frames with a Gaussian present, in front and on screen: {int(shown.sum())} "
        f"of {n}; of those with Gaussian pixels: {int((shown & drawn).sum())}")
    if (shown & ~drawn).any() or shown.sum() == 0:
        raise AssertionError(f"frames {np.nonzero(shown & ~drawn)[0].tolist()} lack their Gaussians")

    # one batch of 27 frames: device time by kernel, idle share
    batch = args[:3] + tuple(a[:27] for a in args[3:7]) + args[7:]
    tr.render_control_maps(*batch, device=dev)
    t1 = time.perf_counter()
    tr.render_control_maps(*batch, device=dev)
    batch_ms = (time.perf_counter() - t1) * 1e3
    log(f"[render] one 27-frame batch: {batch_ms:.2f} ms wall on {card}")
    profile_step(lambda: tr.render_control_maps(*batch, device=dev), batch_ms, card, top=12)
    copy_rates(maps["background_RGB"], dev, card)

    # the workflow's generate: the rendered maps as phase 3's request
    pipe = build_pipeline(dev)
    controls, mask = maps_to_request(maps, scene["image"])
    if any(c.shape != (1, 3, n, h, w) for c in controls) or mask.shape != (1, 1, n, h, w):
        raise AssertionError(f"request inputs {[c.shape for c in controls]} {mask.shape}")
    del maps
    fa.reset_launch_counts()
    fab.reset_launch_counts()
    ms.reset_launch_counts()
    t1 = time.perf_counter()
    video = run_loaded_request(pipe, {"prompt": "a red car drives left", "negative_prompt":
                                      "blurry", "num_inference_steps": STEPS,
                                      "guidance_scale": 5.0, "seed": 13, "height": h,
                                      "width": w, "num_frames": n}, controls, mask)
    dt = time.perf_counter() - t1
    counts = dict(fa.LAUNCHES)
    split = {k: round(v, 3) for k, v in pipe.last_wall_profile.items()}
    log(f"[workflow] request {video.shape} {video.dtype} in {dt:.2f} s {split} launches "
        f"{counts}; render {prof['wall_s']:.3f} s wall + request {dt:.2f} s = "
        f"{prof['wall_s'] + dt:.2f} s render -> generate on {card}")
    want = {"fused_rope_rms_attention": 45 * STEPS, "fused_rope_rms_attention_int8": 0,
            "fused_rms_cross_attention": 45 * STEPS, "flash_attention": 0}
    if counts != want or any(fab.LAUNCHES.values()) or any(ms.LAUNCHES.values()):
        raise AssertionError(f"launch counts {counts} {fab.LAUNCHES} {ms.LAUNCHES} != {want}")
    if video.shape != (1, n, h, w, 3) or video.dtype != np.uint8 or float(video.std()) == 0.0:
        raise AssertionError(f"bad output {video.shape} {video.dtype}")
    del pipe, controls, mask, video
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[workflow] phase 10 {time.perf_counter() - t0:.1f} s")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from versecrafter_tpu_torch.kernels import _build
    from versecrafter_tpu_torch.kernels import flash_attention as fa
    from versecrafter_tpu_torch.kernels import flash_attention_bwd as fab
    from versecrafter_tpu_torch.kernels import matmul_stat as ms
    from versecrafter_tpu_torch.serve.model_server import _call_pipe

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    if sys.argv[1:] == ["--denoise-digest"]:
        return denoise_digest_main(dev)
    card = gpu_line()
    t_all = time.perf_counter()
    failures = []

    # -- 1. environment + build ------------------------------------------
    log(f"[env] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:  # beside the builds' own nvccs
        reports = {src: pool.submit(_build.ptxas_report, src)
                   for src in sorted({src for src, _ in PTXAS_KERNELS.values()})}
        _build.build_all(_build.kernel_sources())
        reports = {src: r.result() for src, r in reports.items()}
    log(f"[build] {_build.kernel_sources()} built in {time.perf_counter() - t0:.1f} s")
    ptxas_check(_build, reports)

    # -- 2. kernel parity ------------------------------------------------
    t0 = time.perf_counter()
    log("[parity] kernel vs plain")
    records = {}
    for name, ctx_len in (("fused_rope_rms_attention", None),
                          ("fused_rms_cross_attention", 512)):
        records[name] = check_kernel(fa, name, 2, 32760, ctx_len or 32760, 12, dev,
                                     timed=True, rerun=True)
        check_kernel(fa, name, 2, 14040, ctx_len or 14040, 12, dev)
        check_kernel(fa, name, 2, 520, 77 if ctx_len else 520, 12, dev)
    check_kernel(fa, "fused_rope_rms_attention", 2, 520, 520, 2, dev,
                 window=(64, 32), k_lens=(300, 0))
    # the fused kernel's tile geometry: the layout check, then lengths
    # that straddle its 128-row q tiles and 128-key tiles in both
    # directions, keys shorter than a tile, k_lens holding a 0, windows, and
    # 32,760 = 255 * 128 + 120 q rows at one head
    check_fused_layout(fa, dev)
    for name in ("fused_rope_rms_attention", "fused_rms_cross_attention",
                 "fused_rope_rms_attention_int8"):
        for B_, N_, Sq, Skv, window, k_lens in FUSED_EDGE_CASES:
            check_kernel(fa, name, B_, Sq, Skv, N_, dev, window=window, k_lens=k_lens,
                         seed=1, rerun=True)
    # the training path's shapes: self 32,760 and cross 32,760 x 512, batch 1
    records.update(check_flash(fa, fab, 1, 12, 32760, 32760, dev, timed=True))
    cross = check_flash(fa, fab, 1, 12, 32760, 512, dev, timed=True)
    for name, rec in cross.items():  # the cross shape's numbers ride along
        records[name].update({f"cross_{k_}": v for k_, v in rec.items()
                              if k_ in ("ms", "plain_ms", "bound_ms", "library_ms",
                                        "inference_ms")})
    check_flash(fa, fab, 2, 2, 520, 520, dev)
    check_flash(fa, fab, 2, 2, 520, 520, dev, window=(64, 32), k_lens=(300, 0))
    check_flash(fa, fab, 2, 2, 333, 333, dev, window=(100, 27), k_lens=(333, 0), seed=1)
    # the backward pair's tile geometry: the layout check, then lengths that
    # straddle 64-row tiles and 128-row CTAs in both directions, a key
    # sequence shorter than a tile, and 32,760 = 255 * 128 + 120 at one head
    # (seed 1: with seed 0 max|dQ| of the first shape is 1.969, and one
    # element that rounds to the other side of 2.0, one bf16 ulp of 2^-6,
    # is already outside 2*2^-8*1.969)
    check_wgmma_layout(fab, dev)
    check_flash(fa, fab, 1, 2, 193, 321, dev, seed=1)
    check_flash(fa, fab, 2, 2, 129, 64, dev, k_lens=(64, 1), seed=1)
    check_flash(fa, fab, 1, 2, 384, 384, dev, window=(100, 27), seed=1)
    check_flash(fa, fab, 1, 2, 200, 40, dev, seed=1)
    check_flash(fa, fab, 1, 1, 32760, 192, dev, seed=1)
    check_back_to_back(fa, dev)
    # the opt-in variants' kernels: the int8 flavor at the generate path's
    # shapes, and linear_rstat at the q/k projections' [B*S, 1536] x
    # [1536, 1536] (CFG-2 and CFG-1 at 480x832x81) and a ragged M
    int8 = "fused_rope_rms_attention_int8"
    records[int8] = check_kernel(fa, int8, 2, 32760, 32760, 12, dev, timed=True)
    check_kernel(fa, int8, 2, 14040, 14040, 12, dev)
    check_kernel(fa, int8, 2, 520, 520, 12, dev)
    check_kernel(fa, int8, 2, 520, 520, 2, dev, window=(64, 32), k_lens=(300, 0))
    records["linear_rstat"] = check_rstat(ms, 65520, dev, timed=True, launches=20)
    check_rstat(ms, 65520, dev, bias=False)
    check_rstat(ms, 32760, dev)
    check_rstat(ms, 333, dev)
    check_rstat(ms, 333, dev, bias=False)
    check_rstat(ms, 333, dev, K=5120, N=5120)  # the Wan2.1-14B width
    log(f"[parity] {time.perf_counter() - t0:.1f} s")

    # -- 3. the slice end to end -----------------------------------------
    t0 = time.perf_counter()
    pipe = build_pipeline(dev)
    torch.cuda.synchronize()
    log(f"[e2e] pipeline built (umT5-xxl + Wan2.1-1.3B + GeoAdapter "
        f"{len(pipe.dit_params['geoada_blocks'])} blocks + Wan VAE) in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
    h, w, n = E2E_SIZE
    log(f"[e2e] requests at {h}x{w}x{n}")
    torch.cuda.reset_peak_memory_stats()
    launches_main = {k: 0 for k in fa.LAUNCHES}
    decoded = latent_digests(pipe)
    direct = {}  # phase 8 serves the same requests: frames and times to hold it to
    for r, (prompt, seed) in enumerate(E2E_REQUESTS):
        controls, mask = synth_request(n, h, w, seed)
        fa.reset_launch_counts()
        fab.reset_launch_counts()
        ms.reset_launch_counts()
        t1 = time.perf_counter()
        video = _call_pipe(pipe, {"prompt": prompt, "negative_prompt": "blurry",
                                  "num_inference_steps": STEPS, "guidance_scale": 5.0,
                                  "seed": seed}, controls, mask, h, w, n, None)
        dt = time.perf_counter() - t1
        counts = dict(fa.LAUNCHES)
        for k_ in counts:
            launches_main[k_] += counts[k_]
        direct[seed] = {"s": dt, "profile": dict(pipe.last_wall_profile),
                        "frames": frames_digest(video), "latents": decoded[-1]}
        log(f"  request {r}: {video.shape} {video.dtype} in {dt:.1f} s "
            f"{ {k_: round(v, 2) for k_, v in pipe.last_wall_profile.items()} } "
            f"launches {counts}; SHA-256 of the uint8 frames {direct[seed]['frames'][:16]}, "
            f"of the denoised latents {decoded[-1][:16]}")
        if video.shape != (1, n, h, w, 3) or video.dtype != np.uint8:
            raise AssertionError(f"bad output {video.shape} {video.dtype}")
        if float(video.std()) == 0.0:
            raise AssertionError("constant output video")
        want = {"fused_rope_rms_attention": 45 * STEPS, "fused_rope_rms_attention_int8": 0,
                "fused_rms_cross_attention": 45 * STEPS, "flash_attention": 0}
        if counts != want or any(fab.LAUNCHES.values()) or any(ms.LAUNCHES.values()):
            raise AssertionError(f"launch counts {counts} {fab.LAUNCHES} {ms.LAUNCHES} "
                                 f"!= {want}")
    log(f"[e2e] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated); the VAE streams above "
        f"{pipe.VAE_STREAM_THRESHOLD} voxels, a {n}x{h}x{w} video has {n * h * w}")

    # small-input reference: the same DiT on the CPU (plain attention)
    dit_card_vs_cpu(pipe, pipe.dit_params, pipe.dit_cfg, "e2e", "DiT (45 blocks)")
    # the streaming VAE against the full-sequence one on a full-size video
    stream_vs_full(pipe, 11, card)
    # TeaCache with cfg-skip: the skip schedule and the launches it implies
    for k_, v in tea_request(fa, fab, ms, pipe, "e2e", TEA_13B, 45, 15, card).items():
        launches_main[k_] = launches_main.get(k_, 0) + v
    log(f"[e2e] {time.perf_counter() - t0:.1f} s")

    # -- 4. one timed denoise step at 480x832x81 -------------------------
    t0 = time.perf_counter()
    lat, geo, ctx, cos, sin = step_inputs(pipe, dev)

    def step():
        return pipe.denoise_step(lat, 999.0, ctx, geo, cos, sin, 5.0, 1.0, True)

    step()
    torch.cuda.synchronize()
    times, preds = [], []
    for _ in range(2):
        t1 = time.perf_counter()
        preds.append(step())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    pred = preds[-1]
    if not torch.isfinite(pred).all():
        raise AssertionError("non-finite prediction at 480x832x81")
    same = torch.equal(preds[0], preds[1])
    log(f"[step] the two timed steps' predictions are bit-identical: {same} "
        f"(max|pred| {pred.float().abs().max().item():.6g}, max|difference| "
        f"{(preds[0].float() - preds[1].float()).abs().max().item():.6g})")
    if not same:  # the later phases still run; the smoke fails at its end
        failures.append("two denoise steps on the same inputs differ")
    del preds
    log(f"[step] 480x832x81 (32,760 tokens) CFG-2 denoise step: "
        f"{' '.join(f'{t:.1f}' for t in times)} ms on {card}; kernels alone "
        f"{45 * (records['fused_rope_rms_attention']['ms'] + records['fused_rms_cross_attention']['ms']):.1f} ms "
        f"(45 x each flavor); peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"phase {time.perf_counter() - t0:.1f} s")
    idle = profile_step(step, min(times), card)
    # phase 9 quantizes this pipeline's tree (built again from the same
    # seeds) and holds each mode's step to this one
    bf16_step = {"pred": pred, "ms": min(times), "idle": idle}
    digest = step_digest(pipe, lat, geo, ctx, pred)
    # sequential CFG against the batched step, held to twice the noise floor
    lat_p = (lat.float() * (1 + 2.0 ** -8)).to(lat.dtype)
    floor = compare("step at latents x (1 + 2^-8) vs step (noise floor)",
                    pipe.denoise_step(lat_p, 999.0, ctx, geo, cos, sin, 5.0, 1.0, True), pred)
    del lat_p
    seq, _ = sequential_step(pipe, lat, ctx, geo, cos, sin, "step", card)
    compare("sequential-CFG step vs batched", seq, pred, corr_bar=0.999, err_bar=2 * floor)
    del pipe, lat, geo, ctx, pred, seq
    gc.collect()
    torch.cuda.empty_cache()
    # the same step in a fresh process on a pipeline built from the same seeds
    differ = fresh_process_digest(digest)
    if differ:  # the later phases still run; the smoke fails at its end
        failures.append(f"the 480x832x81 denoise step in a fresh process differs: {differ}")

    # -- 5. GeoAdapter training at 480x832x81 ----------------------------
    launches_main.update(train_phase(fa, fab, ms, dev, card))

    # -- 6. the opt-in variants: int8 attention, projection statistics ----
    for k_, v in variants_phase(fa, fab, ms, dev, card).items():
        launches_main[k_] = launches_main.get(k_, 0) + v

    # -- 7. the flagship: Wan2.1-T2V-14B + GeoAdapter at 480x832x81 -------
    counts = flagship_phase(fa, fab, ms, dev, card, records)
    for name in ("fused_rope_rms_attention", "fused_rms_cross_attention"):
        launches_main[name + "_14b"] = counts[name]

    # -- 8. the front door: a reference-layout checkpoint served over HTTP --
    counts, differ = front_door_phase(fa, fab, ms, dev, card, direct)
    for name in ("fused_rope_rms_attention", "fused_rms_cross_attention"):
        launches_main[name] += counts[name]
    if differ:  # reported after the phase's other checks ran
        failures.append(differ)

    # -- 9. quantization and LoRA (the 14B part ran inside phase 7) --------
    for k_, v in quant_phase(fa, fab, ms, dev, card, bf16_step).items():
        launches_main[k_] = launches_main.get(k_, 0) + v

    # -- 10. the render -> generate workflow -----------------------------------
    for k_, v in workflow_phase(fa, fab, ms, dev, card).items():
        launches_main[k_] = launches_main.get(k_, 0) + v

    if failures:
        raise AssertionError("; ".join(failures))
    kernels = []
    for name, rec in records.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": launches_main[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            **{k_: v for k_, v in rec.items()
               if k_.startswith("cross_") or k_ in ("inference_ms", "inference_plain_ms",
                                                    "library_note", "library_gemm_ms")}})
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
