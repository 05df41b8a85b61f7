#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (versecrafter_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each timed, any failure fatal (exit code != 0, no result line):
  1. environment and the kernels' build (nvcc, one process per source, all
     started together), with ptxas's registers and spills of every wgmma
     kernel: the attention kernels of csrc/fused_attention.cu,
     csrc/flash_attention.cu and csrc/flash_attention_bwd.cu and the GEMM of
     csrc/matmul_stat.cu (a ptxas warning C7512, wgmma serialised, anywhere
     in these sources or a spill in one of these kernels fails); beside them
     the host media codecs of csrc/host/ (c++);
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
     pipeline with umT5-xxl and the Wan VAE from random weights serves a
     generate request (480x832x45, 2 UniPC steps, CFG 5; the VAE streams
     at that size; the served 480p requests run 45 frames and 2 steps, not
     81 and 3, to leave room for phase 13) through the serving
     mapping; the launch counters must read 45 per step per fused flavor,
     and the DiT on the card must agree with the same DiT on the CPU at a
     small input; one 480x832x45 control video through the streaming and
     the full-sequence VAE (in fp32 on its first 17 frames the two within
     2*2^-8*max; in bf16 at 45 frames the streaming path within 2*2^-8*max
     of the full path's own distance from the fp32 result; each path's
     time and peak memory); one 480x832x45 request with TeaCache and
     cfg-skip (8 steps),
     whose skip schedule must equal the one recomputed here from the
     timesteps' e0 and whose launches must be 45 per evaluation that ran the
     blocks; the generate request's uint8 frames and denoised latents are
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
     the card against the CPU at 192 tokens, a warm-up and a timed step
     (finite losses, every trainable leaf moved, every frozen leaf
     unchanged, launch counts as derived from the model), peak memory, and
     one step under torch.profiler;
  6. the generate path's two opt-in variants on a fresh full-width
     pipeline: one 480x832x45 request with `int8_attention` through the
     serving toggle (int8-scored self-attention) and one with
     wan_dit.PROJ_STAT_FUSION on (q/k statistics from the linear_rstat
     GEMM), each with its launch counts; then one timed CFG-2 denoise step
     per variant under torch.profiler, its prediction held against the
     default path's on the same inputs, and each variant's step time beside
     the default's;
  7. the flagship: the fused attention kernels at the Wan2.1-14B width (40
     heads, [2, 32,760, 5120], cross against 512 keys) against their plain
     versions, timed, reruns bit-identical, then at 720p (phase 13, part 1)
     and the 720p controls rendered; then Wan2.1-T2V-14B + GeoAdapter
     with umT5-xxl and the Wan VAE from random weights (build time, resident
     memory), its first GeoAdapter superstep on the card against the CPU at
     192 tokens, the 720p step (phase 13, part 2), one 480x832x45 request
     with TeaCache and cfg-skip (4 steps;
     schedule, 60 launches per evaluation that ran the blocks, stage split,
     peak memory), one timed CFG-2 step under torch.profiler and the same
     step as sequential CFG held to it (twice the noise floor, in max error
     and in correlation), both steps' peaks printed beside the earlier
     measurements with and without the FFN hidden held through the
     residual (fault F1); then the Wan2.2 two-expert MoE at Wan2.2-T2V-A14B
     width (each expert the 14B + GeoAdapter): phase 7's DiT dropped and an
     expert_swap building the high expert from seed 1 and then the low one
     from seed 0 at sigma 0.95 and 0.5 (swap calls ["high", "low"], the high
     expert freed before the low one is built; phase 13 serves a request
     through the swap at 720p), a 2-step 240x416x33 request at 1.3B width as
     a resident pair and as an expert swap (latents bit-identical), and after
     phase 9's W8A8 conversion (and phase 7's pipeline dropped) the resident
     int8 pair through default_pipeline_factory(moe=True, quantize=(8,
     True)), which quantizes each expert W8A8 (dynamic scales) before it
     makes the next (build peak, resident bytes; a pair that does not fit
     fails), serving the same 2-step request through __call__ (60 launches
     of rows 1-2 a step, each step's time, the peak);
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
     2 times (phase 3's second request, once served back to back behind
     it, was cut to keep the run inside its time; the check that it
     waited in the queue at depth 1 moved to the CPU test
     tests/test_torch_serving.py::test_model_server_queues_a_second_request).
     The model server takes phase 3's synthetic control arrays through
     its _generate / _save override points, so that the frames can equal
     phase 3's bit for bit (phase 10 serves a request from files);
  9. quantization and LoRA: the W8A8 and W4A8 products (int8_compute_dot)
     at the 14B FFN in-projection's shape, [65,520, 5120] x [5120, 13,824],
     timed whole and split (activation quantize, int4 unpack, _int_mm, fp32
     epilogue) beside torch.addmm in bf16, with their peak bytes, the first
     1,024 rows equal to the CPU's bit for bit; LoRA training through
     cli/train.py --lora_rank 16 (two 480x832x81 batch-1 steps of the
     1.3B + GeoAdapter: finite losses, the base tree's SHA-256 unchanged,
     an up factor moved, launches as attention_launches_per_step(cfg,
     lora=True) derives, the exported step_000002_lora.safetensors read
     back equal); then phase 3's pipeline (bf16 tree kept) in five modes in
     turn (int8, int4 with group scales, W8A8 dynamic, W8A8 static with
     scales from calibrate=True on one 480x832x81 forward, W4A8): resident
     DiT bytes and its first GeoAdapter superstep within 5e-2 * max of the
     CPU in the same mode at 192 tokens, W4A8 also one timed 480x832x81
     CFG-2 step against the bf16 step (the rebuilt pipeline's bf16 step
     must equal phase 4's bit for bit); one 2-step
     480x832x45 request with {"int8_compute": true} through
     run_loaded_request (45 launches per step per fused flavor), after which
     {"quantize_bits": 4} must raise; the trained LoRA merged at 0.55 (two
     merged leaves equal to the CPU merge bit for bit), one CFG-2 step, and
     the unmerged leaves' distance from the base in bf16 ulps. Its 14B part
     runs at the end of phase 7, on the resident 14B pipeline: quantized in
     place to W8A8, resident bytes, one timed CFG-2 step with its peak,
     the first GeoAdapter superstep against the CPU;
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
     share); then the request from files, as the add-on sends it: the six
     streams written as mp4s by the renderer's writer
     (render.write_control_maps), the scene's image uploaded as a PNG, a
     generate task on a port ApiServer whose in-process tier holds phase
     3's 1.3B pipeline (no override point) on the first 45 frames
     (480x832x45), 2 steps, CFG 5: 45 launches a step per fused flavor; the
     controls the pipeline decoded within WRITER_PSNR_DB of the rendered
     frames, the video fetched with /api/download and decoded by the port
     equal to the port's encode -> decode of the request's frames (PSNR
     printed), its seconds beside the render's wall time.
 11. the conditioning extras: a 2-step 480x832x45 video= masked-init
     request on phase 3's pipeline (the rendered background clip masked by merged_mask as
     the single control, a geoada_patch_embedding for its 80 channels);
     row 4b, the plain forward's exp2 flavor, at the i2v cross shapes
     ([2, 12, 32,760, 128] against 512 and 257 keys) against its plain
     version with a rerun and twenty back-to-back launches bit-identical,
     timed beside SDPA and its bound; then the widths of Wan2.1-Fun-1.3B-InP
     (i2v, in_dim 36) + the GeoAdapter + the SimpleAdapter + the CLIP
     ViT-H/14 tower from random weights: the DiT on the card against the
     CPU at 192 tokens with y, clip_fea and y_camera (5e-2 * max),
     encode_image of a 480x832 uint8 frame against the CPU (2 * 2^-8 *
     max, timed), one 480x832x45 request (2 UniPC steps, CFG 5, batched)
     with clip_image, y as Wan i2v builds it [1, 20, 12, 60, 104], 24-channel
     camera maps [1, 24, 12, 480, 832] and phase 10's four rendered controls
     (launches a step: row 1 45, row 2 15, row 4b 60; stage split, peak),
     a 2-step request with one subject reference frame (noise drawn at 13
     latent frames, 45 frames out), one timed CFG-2 step at 480x832x81 under
     torch.profiler, and the plain cross path's parts beside the fused
     cross kernel by CUDA events.
 12. preprocessing and the whole chain (run on phase 10's pipeline, between
     phase 11's video= request and its i2v part): the scene's first frame
     written as a PNG by the port and uploaded with a baseline and a
     progressive JPEG fixture to a port ApiServer, all read back from its
     workdir (the PNG equal to the frame, each JPEG to its fixture digest);
     MoGe-v2 (ViT-L + HEAD_L, seed 0) on the PNG's image edge-padded to
     490x840 (2,100 tokens), points and mask logits card vs CPU (1e-3 *
     max), the focal and shift recovered from each side's point map, a rerun
     bit-identical, seconds and peak; a preprocess request with the default
     parameters (the saliency segmenter) on the uploaded progressive JPEG,
     completed with objects and timed; the neural segmenter at the full
     widths but a reduced depth (Swin-T stages 2,2,2,2, BERT-base and the
     encoder / decoder at 2 layers; Hiera-L stages 2,2,4,2) card vs CPU:
     the encoder's proposal scores, then, both sides decoding the CPU's
     top-900 selection (the devices rank near-equal proposal scores
     differently), the detector's logits and boxes and the masks / IoU of
     the same boxes (1e-3 * max), and, with every query's score and every
     kept detection's token probabilities 0.002 from their thresholds, the
     detection lists of that selection; the segmenter at full depth (Grounding DINO Swin-T
     896 + BERT-base, SAM 2.1 Hiera-L 1024, init_gdino / init_sam2 from
     seed 0): each model's seconds, the peak, the detections; the depth
     PNGs (moge.save_outputs) and the mask PNGs (save_results) written and
     read back equal to their arrays; then the chain: the card's depth and
     the masks from their files, eroded -> fit_objects_from_depth ->
     each Gaussian moved sideways over 81 frames under the scene's camera
     -> render_control_maps -> a 2-step 480x832x81 request (45 launches a
     step per fused flavor), each stage's seconds and the wall from image
     to video; the video uint8 [1, 81, 480, 832, 3] and not constant.
 13. 720p at 14B (720x1280x81, 75,600 tokens), in three parts: with the
     card empty (in phase 7), rows 1-2 at [2, 75,600, 40, 128] (cross
     against 512 keys), a rerun bit-identical, heads 0 and 39 of both batch
     items held to the plain version on those heads, timed beside their
     bounds and SDPA, and the seeded scene rendered at 720x1280x81 as the
     request's controls; on phase 7's resident pipeline, the request's first
     step (its noise, the prompt pair through umT5, the controls through the
     VAE) as sequential CFG, timed with its peak, and as batched CFG where
     the measured sequential peak plus the memory model's batched term stays
     under sampling/staged.CARD_MODEL's bar (else not launched); after phase
     7, the request through staged.generate_staged with
     fresh_init_factories("14b", bits=0) (phase 7's DiT bit for bit), 2
     UniPC steps, CFG 5 as auto_cfg_parallel picks: each stage's seconds and
     peak, the bytes left after each free (the stage outputs within 64
     MiB), 60 launches of rows 1-2 an evaluation, frames [1, 81, 720, 1280,
     3] uint8, the first step's prediction held to the resident one (bit for
     bit in the same CFG mode, else twice the noise floor); the same request
     as the Wan2.2 swap under staged residency (timesteps 950 and 500, the
     high expert from seed 1: its build seconds, the bytes before each
     build, the stages); and record -> fit -> fire (generate_staged with
     record_teacache, teacache.fit_teacache_coefficients, the recorded
     latents decoded, a fired request) at the 1.3B widths at 240x416x33, 4
     steps.
 14. parallelism, one rank's share of the reference's 8-GPU points (the card
     has one GPU): an NCCL world of one through utils/cache and core/mesh,
     one all_to_all_single and one batch_isend_irecv to itself; row 4b on
     [2, 5, 75,600, 128] through sharding.ulysses_attention (the 14B at
     720p, sp = 8) against its plain version on two heads; the ring's hops
     (ring_attention.attend_shard) for the q shards of ranks 0 and 7 of the
     1.3B at 480p, sp = 8 ([2, 12, 4,095, 128]) against the full
     attention's rows; the ring's backward hops (hop_backward) at its train
     point against the full fa_backward; the bytes a rank sends per layer.
 15. the VAE's width over 8 ranks at phase 13's 720x1280x81 point (latents
     [1, 16, 21, 90, 160] bf16 from a seed, the Wan VAE from random
     weights; 20 latent columns a shard), one rank's share at a time (one
     card: no exchange): the whole streaming decode timed with its peak; a
     second whole decode through a recording stand-in width shard (smoke
     only) that keeps, call by call, the halo columns shards 0, 3 and 7
     would receive and the attention block's whole frames; each of those
     shards decoded on its slice with those columns replayed, timed with its
     peak, held on the first 9 frames (the decode is causal in time) to the
     exact fp32 decode within the whole bf16 decode's own distance from it +
     2*2^-8*max (the bf16 decode's bar), and on all 81 to the whole
     decode's slice within twice that bar (two decodes each within it of
     the exact one); the bytes one rank sends per decode (its edge columns to
     each neighbour at every conv, its slice of each attention frame to the
     seven others), counted from the shapes. Then one --tiny train step
     of the train CLI with --attn_impl xla on the card (no kernel launched)
     against the default step on the CPU, the losses within 1e-4 * |loss|.
 16. quantized tensor parallelism, one rank's share of tp = 8 (one card: the
     eight shards run one after another, each torch.distributed.all_reduce
     replayed round by round from the shards' own contributions, smoke
     only): the Wan2.1-T2V-14B FFN pair in W8A8 and in W4A8 at the
     480x832x81 CFG-2 point (65,520 rows), ffn_in's column shards
     concatenated equal to the whole product and ffn_out's s32 partials
     summed equal to the whole s32 product, each shard's rescaled output
     equal to the whole int8_compute_dot, all bit for bit; then one 14B +
     GeoAdapter block in W8A8 on shard 0 (rows 1-2 at 5 heads, the q / k
     statistics of the whole rows) against the whole block's output within
     twice its bf16 noise floor, the shard's and the whole's times and
     peaks, rows 1-2 timed at the shard's shapes, and the bytes a rank sends
     per block (each all_reduce call's tensor, ring-reduced over 8 ranks)
     beside a bf16 tp path's. Phase 5's trained GeoAdapter tree is written
     through core/checkpoint.py (the JAX package's orbax layout) and read
     back byte-equal.
 17. the host code on the card's host (the machine has no OpenCV; the
     port's own PNG, JPEG (baseline, progressive, CMYK), mp4 and MPEG-4
     Part 2 code and the saliency segmenter's blur, k-means and connected
     components, built from csrc/host/ in phase 1): each fixture of
     tests/data/media decoded to the SHA-256 the JAX package's OpenCV reads
     gave; the saliency segmentation of the 480x832 progressive fixture with
     a seeded depth, on a fresh host thread, timed, its detections equal to
     the JAX package's; and a 480x832x81 clip encoded by save_video and
     decoded by load_video on one host thread, timed, with its size and
     PSNR.
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
    "flash_attention_inference": "versecrafter_tpu/kernels/flash_attention.py:363",
    "fa_backward_dq": "versecrafter_tpu/kernels/flash_attention_bwd.py:100",
    "fa_backward_dkv": "versecrafter_tpu/kernels/flash_attention_bwd.py:142",
    "fused_rope_rms_attention_int8": "versecrafter_tpu/kernels/flash_attention.py:800",
    "linear_rstat": "versecrafter_tpu/kernels/matmul_stat.py:76",
    "fused_rope_rms_attention_14b": "versecrafter_tpu/kernels/flash_attention.py:800",
    "fused_rms_cross_attention_14b": "versecrafter_tpu/kernels/flash_attention.py:800",
    "flash_attention_inference_ulysses": "versecrafter_tpu/kernels/flash_attention.py:363",
    "flash_attention_ring_hop": "versecrafter_tpu/kernels/flash_attention.py:363",
    "fa_backward_dq_ring": "versecrafter_tpu/kernels/flash_attention_bwd.py:100",
    "fa_backward_dkv_ring": "versecrafter_tpu/kernels/flash_attention_bwd.py:142",
    "fused_rope_rms_attention_tp8": "versecrafter_tpu/kernels/flash_attention.py:800",
    "fused_rms_cross_attention_tp8": "versecrafter_tpu/kernels/flash_attention.py:800",
}
SOURCES = {
    "fused_rope_rms_attention": "versecrafter_tpu_torch/csrc/fused_attention.cu",
    "fused_rms_cross_attention": "versecrafter_tpu_torch/csrc/fused_attention.cu",
    "flash_attention": "versecrafter_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_inference": "versecrafter_tpu_torch/csrc/flash_attention.cu",
    "fa_backward_dq": "versecrafter_tpu_torch/csrc/flash_attention_bwd.cu",
    "fa_backward_dkv": "versecrafter_tpu_torch/csrc/flash_attention_bwd.cu",
    "fused_rope_rms_attention_int8": "versecrafter_tpu_torch/csrc/fused_attention.cu",
    "linear_rstat": "versecrafter_tpu_torch/csrc/matmul_stat.cu",
    "fused_rope_rms_attention_14b": "versecrafter_tpu_torch/csrc/fused_attention.cu",
    "fused_rms_cross_attention_14b": "versecrafter_tpu_torch/csrc/fused_attention.cu",
    "flash_attention_inference_ulysses": "versecrafter_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_ring_hop": "versecrafter_tpu_torch/csrc/flash_attention.cu",
    "fa_backward_dq_ring": "versecrafter_tpu_torch/csrc/flash_attention_bwd.cu",
    "fa_backward_dkv_ring": "versecrafter_tpu_torch/csrc/flash_attention_bwd.cu",
    "fused_rope_rms_attention_tp8": "versecrafter_tpu_torch/csrc/fused_attention.cu",
    "fused_rms_cross_attention_tp8": "versecrafter_tpu_torch/csrc/fused_attention.cu",
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
VAE_EXACT_FRAMES = 17  # the fp32 stream-vs-full check's length (full path fits)
TRAIN_STEPS = 2  # a warm-up step and a timed one
TRAIN_GRID = (21, 30, 52)  # 480x832x81: latents 21x60x104, 32,760 tokens
STEPS = 2
# the served 480p requests' frames: the fewest whose video (480 x 832 x 45 =
# 17,971,200 voxels) still goes through the streaming VAE (above 2^24), cut
# from 81 to make room for phase 13
FRAMES_E2E = 45
# phase 10: the least PSNR (dB) of a rendered control stream written by the
# port's mp4 writer and decoded by load_request_inputs (the textured
# background_RGB is the lowest; PERF.md section 5 has the card's readings)
WRITER_PSNR_DB = 25.0
# phases 12 and 17: the media fixtures (scripts/make_torch_media_fixtures.py)
MEDIA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "media")
# phase 12's uploads: name in the workdir -> fixture
UPLOADED_JPEGS = {"photo.jpg": "yuv420.jpg", "photo_prog.jpg": "prog420_rst.jpg"}
E2E_SIZE = (480, 832, FRAMES_E2E)  # height, width, frames of the served requests
# phase 3's generate request (prompt, seed); phase 8 serves it again through
# the HTTP tiers
E2E_REQUESTS = (("a red car drives left along a coast road", 11),)
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
# phase 7's Wan2.2 MoE: two custom timesteps straddling the boundary (sigma
# 0.95 on the high-noise expert, 0.5 on the low one), and the size of the
# 1.3B pair-vs-swap check
MOE_BOUNDARY = 0.875
MOE_TIMESTEPS = (950.0, 500.0)
MOE_SMALL = (240, 416, 33)
# phase 11: the i2v + camera point's factory scale and its request's steps
I2V_SCALE = "i2v-1.3b"
I2V_STEPS = 2
# phase 12: the prompt of the preprocess on the scene's first frame (the
# words are in the smoke vocabulary), MoGe's input padded to the 14-pixel
# patch (2,100 tokens), the segmenter's request knobs (max_area_ratio 1.0:
# random SAM masks cover most of the image), the depth of the segmenter's
# card-vs-CPU check (the full widths), and the bars
PRE_PROMPT = "car. person. box."
PRE_PAD = (490, 840)
PRE_KNOBS = dict(box_threshold=0.25, text_threshold=0.25, max_objects=5,
                 min_area_ratio=0.002, max_area_ratio=1.0)
PRE_CPU_DEPTH = {"gdino": dict(swin_depths=(2, 2, 2, 2), bert_layers=2, enc_layers=2,
                               dec_layers=2),
                 "sam2": dict(blocks=(2, 2, 4, 2), global_blocks=(6,))}
MOGE_BAR = 1e-3  # fp32 with TF32 off on both sides: max|card - CPU| / max|CPU|
SEG_BAR = 1e-3
DET_MARGIN = 0.002  # a detection decision's distance from its threshold
PRE_MASK_AGREE = 0.99  # share of a detection's mask pixels equal card vs CPU
# phase 13: 720p at 14B. The request's size, its steps and its prompt,
# negative prompt and seed (its controls the renderer's seeded scene at that
# size); the heads whose columns the 720p kernel checks hold to the plain
# version; the record -> fit -> fire check's size and steps (the fit needs
# more than 4 observations: 3 step pairs x 2 CFG rows) at the 1.3B widths
SIZE_720P = (720, 1280, 81)
STAGED_STEPS = 2
REQUEST_720P = ("a red car drives left along a coast road", "blurry", 47)
HEADS_720P = (0, 39)
FIT_SIZE = (240, 416, 33)
FIT_STEPS = 4
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
                 timed=False, seed=0, rerun=False, heads=None):
    """Kernel vs plain on the same inputs; returns the record's numbers. The
    int8 flavor is also held to the exact bf16 kernel (int8 envelope). With
    `rerun`, a second launch on the same inputs must be bit-identical; a
    batch element with k_len 0 must write zeros. `heads`: the plain version
    runs on those heads' columns only (at 720p it would take ~17 s on all),
    which the kernel's output is held to (and plain_ms timed on)."""
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
    cols = None if heads is None else torch.cat(
        [torch.arange(h * fa.HEAD_DIM, (h + 1) * fa.HEAD_DIM) for h in heads]).to(dev)

    def sliced(t):
        return t if cols is None else t.index_select(-1, cols).contiguous()

    def plain():
        if cols is None:
            return fa.fused_attention_plain(*args, **kw)
        return fa.fused_attention_plain(sliced(q), sliced(k), sliced(v), rq, rk, gqv[cols],
                                        gkv[cols], ci, si, **{**kw, "num_heads": len(heads)})

    ref = plain()
    err = (sliced(got).float() - ref.float()).abs().max().item()
    mx = ref.float().abs().max().item()
    ok = math.isfinite(err) and err <= BF16_BAR * mx
    log(f"  {name} B={B} S={S} Skv={Skv} N={N} window={window} k_lens={k_lens}"
        f"{'' if heads is None else f' heads {heads} of every batch item'}: "
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
        plain()
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
    checkpoint_round_trip(train, card)
    profile_step(step, min(times[1:]), card)
    log(f"[train] {time.perf_counter() - t0:.1f} s")
    return {k: counts[k] for k in ("flash_attention", "fa_backward_dq", "fa_backward_dkv")}


def checkpoint_round_trip(train, card):
    """Phase 5's trained GeoAdapter tree written through core/checkpoint.py
    (the JAX package's orbax layout: block lists stacked, one uncompressed
    zarr array a leaf) into a temporary directory, read back against the
    tree itself, every leaf's bytes equal."""
    import tempfile

    from versecrafter_tpu_torch.core import checkpoint as tckpt
    from versecrafter_tpu_torch.parallel.train_step import tree_leaves
    tree = {"params": train}
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(train))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "step_000002")
        t1 = time.perf_counter()
        tckpt.save_checkpoint(path, tree)
        save_s = time.perf_counter() - t1
        files = len(os.listdir(path))
        t1 = time.perf_counter()
        back = tckpt.load_checkpoint(path, template=tree, device=torch.device("cuda"))
        load_s = time.perf_counter() - t1
    same = all(torch.equal(a.detach().contiguous().view(torch.uint8),
                           b.contiguous().view(torch.uint8))
               for a, b in zip(tree_leaves(train), tree_leaves(back["params"])))
    log(f"[train] checkpoint (orbax layout, {files} entries, {nbytes / 1e9:.3f} GB): "
        f"written in {save_s:.1f} s, read back in {load_s:.1f} s, every leaf byte-equal "
        f"{same} on {card}")
    if not same:
        raise AssertionError("the checkpoint did not read back byte-equal")


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
    full-width pipeline. One 480x832x45 request with `int8_attention`
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
    """One 480x832x45 request with TeaCache and cfg-skip through the serving
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
    """One 480x832x45 control video through the full-sequence VAE and the
    streaming one, encoded, and the full path's latents decoded by each.

    In bf16, the pipeline's dtype, each path rounds at every conv and the
    two round differently, so neither matches the other to 2*2^-8*max:
    the bf16 streaming path must come within that bar of the bf16 full
    path's own distance from the exact result (fp32 through the streaming
    path), latents and frames; the log gives both paths' max_abs_err
    against each other, bit-identity, time and peak memory above what was
    allocated before. The streaming math is held to the full sequence in
    fp32 on the first VAE_EXACT_FRAMES frames (the fp32 full path at 81
    frames did not fit beside the weights): within 2*2^-8*max."""
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


def sequential_step(pipe, lat, ctx, geo, cos, sin, tag, card, reps=2, t=999.0):
    """The CFG-2 step at timestep t as sequential CFG (two batch-1
    forwards, the positive prompt's and then the negative one's, combined):
    `reps` timed runs and the peak memory above what was allocated before;
    returns the prediction and that peak in GiB."""
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
            pred = den.step(0, t, lat, ctx, geo, cos, sin, 1.0)
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


def flagship_phase(fa, fab, ms, dev, card, records, p13):
    """Phase 7: Wan2.1-T2V-14B + GeoAdapter with umT5-xxl and the Wan VAE
    (the '14b' factory, random weights from seed 0). First, with the card
    empty, the fused attention kernels at its width (40 heads: [2, 32,760,
    5120], cross against 512 context tokens), timed, with reruns, then at
    720x1280x81 (phase 13, part 1) and the 720p controls rendered; then the
    pipeline's build time and resident memory, its first GeoAdapter
    superstep (2 base + 1 GeoAdapter blocks) card vs CPU, one 480x832x45
    TeaCache + cfg-skip request, one timed CFG-2 step under the profiler and
    one sequential-CFG step held to it, the 720p step (phase 13, part 2; its
    inputs and results go to `p13`), the MoE swap's build and free. Returns
    the launches of its requests."""
    from versecrafter_tpu_torch.kernels.rope import grid_cos_sin
    from versecrafter_tpu_torch.serve.model_server import default_pipeline_factory

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[14b] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the phase")
    for name, ctx_len in (("fused_rope_rms_attention", None), ("fused_rms_cross_attention", 512)):
        records[name + "_14b"] = check_kernel(fa, name, 2, 32760, ctx_len or 32760, 40, dev,
                                              timed=True, rerun=True)
    for name, ctx_len in (("fused_rope_rms_attention", None), ("fused_rms_cross_attention", 512)):
        records[name + "_14b"].update(check_kernel_720p(fa, name, ctx_len, dev))
    p13["controls"], p13["mask"], p13["render_s"] = render_720p(card)
    t1 = time.perf_counter()
    pipe = default_pipeline_factory(scale="14b", device=dev, seed=0)()
    randomize_zero_inits(pipe.dit_params, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
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
    # phase 13, part 2, on the pipeline alone (as the memory model measured it)
    p13["resident"] = resident_720p(pipe, p13["controls"], p13["mask"], card)
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
    base, _, _ = timed_step(step, "14B default path", card, reps=1, tag="14b")
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
    seq, extra = sequential_step(pipe, lat, ctx, geo, cos, sin, "14b", card, reps=1)
    log(f"[14b] F1: the sequential-CFG step's extra peak +{extra:.2f} GiB (before "
        f"+{SEQ_EXTRA_14B[0]}, with the hidden held +{SEQ_EXTRA_14B[1]})")
    compare("14B sequential-CFG step vs batched", seq, base, corr_bar=corr_bar,
            err_bar=2 * floor)
    del seq
    # the Wan2.2 two-expert MoE: an expert swap at 14B, pair vs swap at 1.3B
    moe_swap_14b(pipe, card, build_s)
    moe_pair_vs_swap_13b(pipe, card)
    quant_14b(pipe, step, base, card)  # phase 9's 14B part, while it is resident
    del pipe, step, lat, geo, ctx, base
    for k_, v in moe_pair_14b(fa, fab, ms, dev, card).items():  # the resident int8 pair
        counts[k_] = counts.get(k_, 0) + v
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
            """Serves phase 3's synthetic control arrays (its bit-for-bit
            check against phase 3 needs them; phase 10 serves from files)
            and keeps each request's digests, times and launches."""

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
        log("[front] the served request takes phase 3's synthetic control arrays through "
            "ModelServer._generate / _save, so that its frames can equal phase 3's bit for "
            "bit; phase 10 serves a request from mp4 files and phase 17 times the codecs")
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
    cfg, params, _ = tcli.build_model(args, dev)
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
    "idle"}), which the rebuilt pipeline's step must equal. Returns the main
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
    rows = [("bf16 (phase 4)", qz.tree_bytes(base))]
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
        rows.append((label, nbytes))
        if label == QUANT_MODES[-1][0]:  # the deepest mode also takes a full-width step
            pred, _, _ = timed_step(step, label, card, reps=1, tag="quant", profile=False)
            err = (pred.float() - ref.float()).abs().max() / ref.float().abs().max()
            log(f"[quant] {label} 480x832x81 CFG-2 step (finite) against the bf16 step: "
                f"correlation {correlation(pred, ref):.6f}, max|diff| {err.item():.4g} of max")
            del pred
        sub, sub_cfg = dit_subtree(pipe.dit_params, cfg, 2, 1)
        dit_card_vs_cpu(pipe, sub, sub_cfg, "quant", f"{label}: first GeoAdapter superstep "
                        "(2 base + 1 GeoAdapter blocks)")
        del sub
    pipe.dit_params = base
    log(f"[quant] 1.3B resident DiT by mode on {card}:")
    for label, nbytes in rows:
        log(f"  {label:13s} {nbytes / 2**30:8.3f} GiB")

    # a 2-step W8A8 request through the serving mapping, then another mode
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
    one timed CFG-2 step (no warm-up: phase 9 repeats the 1.3B W4A8 step)
    with its peak, and its first GeoAdapter superstep against the CPU at
    192 tokens."""
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
    t1 = time.perf_counter()
    pred = step()
    torch.cuda.synchronize()
    log(f"[14b-w8a8] 14B W8A8: CFG-2 denoise step {(time.perf_counter() - t1) * 1e3:.1f} ms "
        f"(the first) on {card}")
    if not torch.isfinite(pred).all():
        raise AssertionError("non-finite 14B W8A8 prediction")
    err = (pred.float() - bf16_pred.float()).abs().max() / bf16_pred.float().abs().max()
    log(f"[14b-w8a8] peak over the steps {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"against the bf16 step: correlation {correlation(pred, bf16_pred):.6f}, max|diff| "
        f"{err.item():.4g} of max")
    sub, sub_cfg = dit_subtree(pipe.dit_params, pipe.dit_cfg, 2, 1)
    dit_card_vs_cpu(pipe, sub, sub_cfg, "14b-w8a8", "W8A8 first GeoAdapter superstep (2 base "
                    "+ 1 GeoAdapter blocks of the 14B DiT)")
    log(f"[14b-w8a8] {time.perf_counter() - t0:.1f} s")


def build_expert(cfg, seed, dev):
    """An expert as the MoE checks build it: the DiT of `cfg` from `seed`
    with its zero-init leaves made random from seed + 7 (expert seed 0 is
    phase 7's DiT bit for bit)."""
    from versecrafter_tpu_torch.serve.model_server import build_dit
    params = build_dit(cfg, seed, dev)
    randomize_zero_inits(params, dev, seed=7 + seed)
    return params


def moe_swap_14b(pipe, card, build_s):
    """Phase 7's Wan2.2 timestep-MoE expert swap at Wan2.2-T2V-A14B width
    (each expert the Wan2.1-14B architecture + GeoAdapter), its build and
    free only (phase 13 serves a request through it at 720p under staged
    residency): phase 7's DiT dropped, then expert_for at sigma 0.95 and at
    0.5 builds the high expert from seed 1 and then the low one from seed 0.
    The calls must be ["high", "low"] and the bytes allocated before the
    second build no more than before the first (the high expert freed
    first). Leaves the low expert (phase 7's DiT bit for bit) resident."""
    dev, cfg = pipe.device, pipe.dit_cfg
    t0 = time.perf_counter()
    pipe.dit_params = None
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[moe] shell: phase 7's DiT dropped, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated (umT5-xxl + VAE + the step inputs)")
    builds = []

    def swap(which):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        params = build_expert(cfg, 1 if which == "high" else 0, dev)
        torch.cuda.synchronize()
        builds.append((which, time.perf_counter() - t1, before))
        return params

    pipe.expert_swap, pipe.moe_boundary = swap, MOE_BOUNDARY
    try:
        for t in MOE_TIMESTEPS:
            pipe.expert_for(t)
    finally:
        pipe.expert_swap = None
    for which, s_, before in builds:
        log(f"[moe] expert_swap('{which}'): built in {s_:.1f} s with {before / 2**30:.2f} GiB "
            f"allocated just before (phase 7's whole pipeline built in {build_s:.1f} s) on "
            f"{card}")
    if [b[0] for b in builds] != ["high", "low"]:
        raise AssertionError(f"swap calls {[b[0] for b in builds]} != ['high', 'low']")
    if builds[1][2] > builds[0][2]:
        raise AssertionError("the high expert was still allocated when the low one was built")
    log(f"[moe] {time.perf_counter() - t0:.1f} s")


def moe_pair_vs_swap_13b(pipe, card):
    """At Wan2.1-1.3B + GeoAdapter width, beside the 14B pipeline's umT5 and
    VAE: two experts (seeds 10 and 11) as a resident pair and as an expert
    swap serve the same 2-step MOE_SMALL request; the latents must be
    bit-identical and the swap calls ["high", "low"]."""
    from versecrafter_tpu_torch.sampling.pipeline import VerseCrafterPipeline
    from versecrafter_tpu_torch.serve.model_server import pipeline_configs

    t0 = time.perf_counter()
    dev, cfg = pipe.device, pipeline_configs("1.3b")[0]
    h, w, n = MOE_SMALL
    controls, mask = synth_request(n, h, w, 33)
    kw = dict(negative_prompt="blurry", control_videos=controls, mask_video=mask, height=h,
              width=w, num_frames=n, timesteps=list(MOE_TIMESTEPS), guidance_scale=5.0,
              seed=33, output_type="latent")

    def small(**fields):
        return VerseCrafterPipeline(
            dit_cfg=cfg, vae_params=pipe.vae_params, vae_cfg=pipe.vae_cfg,
            t5_params=pipe.t5_params, t5_cfg=pipe.t5_cfg, tokenizer=pipe.tokenizer,
            moe_boundary=MOE_BOUNDARY, device=dev, **fields)

    pair = small(dit_params=build_expert(cfg, 10, dev), dit_params_high=build_expert(cfg, 11, dev))
    resident = pair("a ferry crosses a bay", **kw)
    del pair
    calls = []

    def swap(which):
        calls.append(which)
        return build_expert(cfg, 11 if which == "high" else 10, dev)

    staged = small(dit_params=None, expert_swap=swap)("a ferry crosses a bay", **kw)
    same = torch.equal(staged, resident)
    log(f"[moe] 1.3B pair vs swap at {h}x{w}x{n}, timesteps {MOE_TIMESTEPS}: latents "
        f"{tuple(staged.shape)} bit-identical: {same}; swap calls {calls}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not same or calls != ["high", "low"]:
        raise AssertionError("the 1.3B expert swap differs from the resident pair")


def moe_pair_14b(fa, fab, ms, dev, card):
    """The resident int8 pair at 14B, through the entry point a server
    calls: default_pipeline_factory(scale="14b", moe=True, quantize=(8,
    True)) builds the low expert from seed 0 and quantizes it W8A8 (dynamic
    scales) before it builds the high one from seed 1, then umT5-xxl and the
    VAE (the experts' zero-init leaves made random as build_expert does).
    Prints the build's seconds and peak and the resident bytes, then serves
    one 480x832x45 request through __call__ on the two custom timesteps
    that straddle the boundary (CFG-2 batched; 60 launches of rows 1-2 a
    step), each step's time, the request's peak. A pair that does not fit
    fails, with the shortfall printed. Returns the request's launches."""
    from versecrafter_tpu_torch.serve import model_server
    from versecrafter_tpu_torch.utils import quantize as qz

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build = model_server.build_dit

    def randomized(cfg, seed, device=None, dtype=torch.bfloat16):
        params = build(cfg, seed, device, dtype)
        randomize_zero_inits(params, dev, seed=7 + seed)
        return params

    model_server.build_dit = randomized
    try:
        pipe = model_server.default_pipeline_factory(scale="14b", device=dev, seed=0, moe=True,
                                                     quantize=(8, True))()
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        free, total = torch.cuda.mem_get_info()
        log(f"[moe-pair] OUT OF MEMORY building the pair over {before / 2**30:.2f} GiB: peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of {total / 2**30:.2f} GiB "
            f"({e})")
        raise AssertionError("the 14B int8 pair does not fit one card") from e
    finally:
        model_server.build_dit = build
    build_s, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
    low_b, high_b = qz.tree_bytes(pipe.dit_params), qz.tree_bytes(pipe.dit_params_high)
    log(f"[moe-pair] default_pipeline_factory(scale='14b', moe=True, quantize=(8, True)) built "
        f"in {build_s:.1f} s (each expert W8A8 with dynamic scales before the next is made); "
        f"build peak {peak:.2f} GiB over {before / 2**30:.2f} GiB before it; resident DiTs low "
        f"{low_b / 2**30:.2f} + high {high_b / 2**30:.2f} GiB, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated in all "
        f"({torch.cuda.memory_reserved() / 2**30:.2f} reserved; PYTORCH_CUDA_ALLOC_CONF "
        f"{os.environ.get('PYTORCH_CUDA_ALLOC_CONF')}) on {card}")
    pipe.moe_boundary, pipe.cfg_parallel = MOE_BOUNDARY, True
    h, w, n = E2E_SIZE
    controls, mask = synth_request(n, h, w, 31)
    stamps = []

    def progress(i, total):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    fa.reset_launch_counts()
    fab.reset_launch_counts()
    ms.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    video = pipe("a harbour at dawn", negative_prompt="blurry", control_videos=controls,
                 mask_video=mask, height=h, width=w, num_frames=n,
                 timesteps=list(MOE_TIMESTEPS), guidance_scale=5.0, seed=31,
                 output_type="uint8", progress=progress)
    dt = time.perf_counter() - t1
    counts = {**fa.LAUNCHES, **fab.LAUNCHES, **ms.LAUNCHES}
    wall = pipe.last_wall_profile
    step2 = (stamps[1] - stamps[0]) * 1e3
    log(f"[moe-pair] request at {h}x{w}x{n}, timesteps {MOE_TIMESTEPS} (boundary "
        f"{MOE_BOUNDARY}; high expert, then low), CFG-2 batched, both experts W8A8: "
        f"{video.shape} {video.dtype} in {dt:.1f} s { {k: round(v, 2) for k, v in wall.items()} } "
        f"launches {counts}; high-expert step {wall['denoise'] * 1e3 - step2:.1f} ms (the "
        f"denoise stage less the second step), low-expert step {step2:.1f} ms; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved on {card}")
    blocks = pipe.dit_cfg.num_layers + len(pipe.dit_cfg.resolved_geoada_layers)
    want = {**dict.fromkeys(counts, 0), "fused_rope_rms_attention": blocks * 2,
            "fused_rms_cross_attention": blocks * 2}
    if counts != want:
        raise AssertionError(f"int8-pair request launches {counts} != {want}")
    if video.shape != (1, n, h, w, 3) or video.dtype != np.uint8 or float(video.std()) == 0.0:
        raise AssertionError(f"bad output {video.shape} {video.dtype}")
    del pipe, video
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[moe-pair] {time.perf_counter() - t0:.1f} s")
    return counts


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
    then the six streams' first FRAMES_E2E frames as a 2-step request on
    phase 3's 1.3B pipeline through run_loaded_request (45 launches a step
    per fused flavor). Returns the request's launches and {"pipe",
    "controls", "mask", "image"}: the pipeline and the whole 81-frame
    request inputs, which phase 11 takes over."""
    from versecrafter_tpu_torch.geometry import render as tr
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

    # the workflow's generate through files: the renderer's six mp4s, the
    # scene's image uploaded as a PNG, an ApiServer generate task (its
    # in-process tier on phase 3's 1.3B pipeline), then /api/download
    pipe = build_pipeline(dev)
    full = maps_to_request(maps, scene["image"])
    if any(c.shape != (1, 3, n, h, w) for c in full[0]) or full[1].shape != (1, 1, n, h, w):
        raise AssertionError(f"request inputs {[c.shape for c in full[0]]} {full[1].shape}")
    served = file_request(fa, fab, ms, pipe, maps, scene["image"], full, card)
    del maps
    log(f"[workflow] render {prof['wall_s']:.3f} s wall + request through files "
        f"{served['s']:.2f} s = {prof['wall_s'] + served['s']:.2f} s render -> generate on {card}")
    counts = served["launches"]
    log(f"[workflow] phase 10 {time.perf_counter() - t0:.1f} s")
    return counts, {"pipe": pipe, "controls": full[0], "mask": full[1], "image": scene["image"]}


class RecordingPipeline:
    """The pipeline as the ApiServer's in-process tier calls it: each call's
    control clips, mask and uint8 frames are kept for the phase's checks
    (attributes read and set pass through to the pipeline)."""

    def __init__(self, pipe):
        object.__setattr__(self, "pipe", pipe)
        object.__setattr__(self, "calls", [])

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __setattr__(self, name, value):
        setattr(self.pipe, name, value)

    def __call__(self, *args, **kw):
        out = self.pipe(*args, **kw)
        self.calls.append((kw["control_videos"], kw["mask_video"], out))
        return out


def psnr_db(a, b, peak=1.0):
    d = np.asarray(a, np.float32) - np.asarray(b, np.float32)
    mse = float(np.mean(np.square(d), dtype=np.float64))
    return math.inf if mse == 0 else 10 * math.log10(peak * peak / mse)


def file_request(fa, fab, ms, pipe, maps, image, full, card):
    """Phase 10's request from files, as the Blender add-on sends it: the
    six rendered streams written by the renderer's own writer
    (geometry/render.write_control_maps), the scene's image uploaded as a
    PNG over HTTP, a generate task on a port ApiServer whose in-process
    tier holds `pipe` (no override point), the result fetched with
    /api/download and decoded by the port. Checks: the controls the
    pipeline received (decoded by load_request_inputs) against `full`, the
    rendered frames as maps_to_request makes them, within WRITER_PSNR_DB;
    the downloaded video's samples equal, byte for byte, to the port's own
    encoding of the frames the pipeline returned, its decode's PSNR against
    those frames printed; 45 launches a step of each fused flavor.
    Returns {"s": the request's seconds, "launches"}."""
    import shutil
    import tempfile
    import urllib.request

    from versecrafter_tpu_torch.geometry import render as tr
    from versecrafter_tpu_torch.serve import api_server as api_mod
    from versecrafter_tpu_torch.serve.http import make_server, serve_forever_in_thread
    from versecrafter_tpu_torch.utils import mp4, mpeg4, png

    h, w, n = E2E_SIZE
    api_dir = tempfile.mkdtemp(prefix="versecrafter_api_")
    httpd = None
    try:
        t1 = time.perf_counter()
        tr.write_control_maps(maps, os.path.join(api_dir, "rendering_4D_maps"), fps=16)
        write_s = time.perf_counter() - t1
        sizes = {k: os.path.getsize(os.path.join(api_dir, "rendering_4D_maps", f"{k}.mp4"))
                 for k in maps}
        rec = RecordingPipeline(pipe)
        httpd = make_server(api_mod.build_router(api_mod.ApiServer(
            workdir=api_dir, pipeline_factory=lambda: rec)), "127.0.0.1", 0)
        serve_forever_in_thread(httpd)
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        t1 = time.perf_counter()
        up = urllib.request.Request(f"{url}/api/upload?filename=upload/scene.png",
                                    data=png.encode(image), method="POST")
        with urllib.request.urlopen(up, timeout=60) as r:
            uploaded = json.loads(r.read())
        fa.reset_launch_counts()
        fab.reset_launch_counts()
        ms.reset_launch_counts()
        task = http_json(f"{url}/api/generate", {
            "rendering_maps_path": "rendering_4D_maps", "input_image_path": "upload/scene.png",
            "prompt": "a red car drives left", "negative_prompt": "blurry",
            "num_inference_steps": STEPS, "guidance_scale": 5.0, "seed": 13, "height": h,
            "width": w, "num_frames": n, "fps": 16})["task_id"]
        while True:
            st = http_json(f"{url}/api/status/{task}")
            if st["status"] in ("COMPLETED", "FAILED"):
                break
            if time.perf_counter() - t1 > 900:
                raise AssertionError("the file request did not finish in 900 s")
            time.sleep(0.2)
        request_s = time.perf_counter() - t1
        counts = dict(fa.LAUNCHES)
        if st["status"] != "COMPLETED":
            raise AssertionError(f"the file request: {st}")
        t1 = time.perf_counter()
        with urllib.request.urlopen(f"{url}/api/download/{st['result']['video_path']}",
                                    timeout=60) as r:
            data = r.read()
        track = mp4.parse(data)
        got = mpeg4.decode(data, track)
        fetch_s = time.perf_counter() - t1
        controls, mask, frames = rec.calls[-1]
        log(f"[workflow] files: six {'x'.join(map(str, maps['merged_mask'].shape[1:3]))}x"
            f"{len(maps['merged_mask'])} mp4s written in {write_s:.2f} s ({sizes} bytes); "
            f"PNG uploaded {uploaded}; ApiServer generate task {request_s:.2f} s "
            f"(request {pipe.last_wall_profile}); {len(data)} bytes downloaded and decoded "
            f"in {fetch_s:.2f} s; launches {counts}")
        # 1. the controls the pipeline got against the rendered frames
        want_c, want_m = full
        scores = {name: psnr_db(c, wc[:, :, :n]) for name, c, wc in
                  zip(("background_RGB", "background_depth", "3D_gaussian_RGB",
                       "3D_gaussian_depth"), controls, want_c)}
        scores["merged_mask"] = psnr_db(mask, want_m[:, :, :n])
        log(f"[workflow] decoded controls vs the rendered frames, PSNR dB (bar "
            f"{WRITER_PSNR_DB}): { {k: round(v, 2) for k, v in scores.items()} }")
        if min(scores.values()) < WRITER_PSNR_DB:
            raise AssertionError(f"decoded controls below {WRITER_PSNR_DB} dB: {scores}")
        # 2. the downloaded video against the frames the pipeline returned
        _, samples = mpeg4.encode(frames[0], 16)
        same = [data[o:o + z] for o, z in zip(track.offsets, track.sizes)] == samples
        log(f"[workflow] downloaded video {got.shape}: PSNR {psnr_db(got, frames[0], 255.0):.2f} "
            f"dB against the request's frames in memory; its samples equal to the port's "
            f"encoding of those frames: {same}")
        if not same or got.shape != frames[0].shape:
            raise AssertionError("the downloaded video is not the request's frames as written")
        want = {"fused_rope_rms_attention": 45 * STEPS, "fused_rope_rms_attention_int8": 0,
                "fused_rms_cross_attention": 45 * STEPS, "flash_attention": 0}
        if counts != want or any(fab.LAUNCHES.values()) or any(ms.LAUNCHES.values()):
            raise AssertionError(f"launch counts {counts} {fab.LAUNCHES} {ms.LAUNCHES} != {want}")
        if frames.shape != (1, n, h, w, 3) or float(frames.std()) == 0.0:
            raise AssertionError(f"bad output {frames.shape} {frames.dtype}")
        return {"s": request_s, "launches": counts}
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        shutil.rmtree(api_dir, ignore_errors=True)


def check_flash_cross(fa, dev, skv, card, seed=0):
    """Row 4b (the plain forward's exp2 inference flavor) at an i2v cross
    shape, [2, 12, 32,760, 128] queries against `skv` keys, no k_lens, as
    models/wan_dit.py calls it: against its plain version, a rerun and
    twenty back-to-back launches bit-identical; kernel, plain, SDPA and
    bound times. Returns the record."""
    B, N, Sq, D = 2, 12, 32760, fa.HEAD_DIM
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (2.0 * torch.randn(B, N, Sq, D, generator=g, device=dev)).to(torch.bfloat16)
    k, v = (torch.randn(B, N, skv, D, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    log(f"  flash (inference flavor) B={B} N={N} Sq={Sq} Skv={skv}")
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    rec = {"max_abs_err": agree("forward (inference)", out, fa.flash_attention_plain(q, k, v))}
    outs = [fa.flash_attention(q, k, v) for _ in range(21)]
    torch.cuda.synchronize()
    same = all(torch.equal(o, out) for o in outs)
    log(f"    a rerun and twenty back-to-back launches bit-identical: {same}")
    if not same:
        raise AssertionError(f"flash attention at {skv} keys: a rerun differs")
    del outs
    rec["ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v), 10)
    rec["plain_ms"] = host_ms(lambda: fa.flash_attention_plain(q, k, v))
    rec["library_ms"] = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v), 10)
    rec["bound_ms"], rec["bound_by"] = bound(4 * B * N * Sq * skv * D,
                                             (2 * q.numel() + k.numel() + v.numel()) * 2)
    log(f"    {rec['ms']:.4f} ms, plain {rec['plain_ms']:.1f} ms, SDPA {rec['library_ms']:.4f} "
        f"ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}): "
        f"{rec['ms'] / rec['bound_ms']:.2f}x the bound, {rec['ms'] / rec['library_ms']:.2f}x "
        f"SDPA on {card}")
    del q, k, v, out
    torch.cuda.empty_cache()
    return rec


def masked_init_request(fa, fab, ms, pipe, controls, mask, card):
    """A 2-step video= request on phase 3's 1.3B pipeline: the rendered
    background clip masked by merged_mask (v * keep + 0.5 * (1 - keep))
    becomes the single control video. One control's 16 latent channels plus
    the 64 mask channels are 80, where the t2v GeoAdapter takes four
    controls' 128, so for this request the pipeline carries geoada_in_dim
    80 and a fresh geoada_patch_embedding (as a checkpoint loaded with
    another geoada_in_dim gets one); restored afterwards."""
    from versecrafter_tpu_torch.models.wan_dit import _init_linear

    t0 = time.perf_counter()
    dev, cfg0 = pipe.device, pipe.dit_cfg
    pe0 = pipe.dit_params["geoada_patch_embedding"]
    n_in = pipe.vae_cfg.z_dim + pipe.vae_cfg.spatial_compression_ratio ** 2
    pipe.dit_cfg = dataclasses.replace(cfg0, geoada_in_dim=n_in)
    g = torch.Generator(device=dev).manual_seed(23)
    pipe.dit_params["geoada_patch_embedding"] = _init_linear(
        g, n_in * math.prod(cfg0.patch_size), cfg0.dim, pe0["kernel"].dtype, dev)
    fa.reset_launch_counts()
    fab.reset_launch_counts()
    ms.reset_launch_counts()
    n, h, w = mask.shape[2:]
    try:
        video = pipe("a red car drives left", negative_prompt="blurry", video=controls[0],
                     mask_video=mask, height=h, width=w, num_frames=n,
                     num_inference_steps=2, guidance_scale=5.0, seed=23, output_type="uint8")
    finally:
        pipe.dit_cfg = cfg0
        pipe.dit_params["geoada_patch_embedding"] = pe0
    counts = {**fa.LAUNCHES, **fab.LAUNCHES, **ms.LAUNCHES}
    log(f"[extras] video= masked-init request (2 steps, {h}x{w}x{n}): {video.shape} "
        f"{video.dtype} in {time.perf_counter() - t0:.1f} s "
        f"{ {k: round(v, 2) for k, v in pipe.last_wall_profile.items()} } launches {counts} "
        f"on {card}")
    blocks = cfg0.num_layers + len(cfg0.resolved_geoada_layers)
    want = {**dict.fromkeys(counts, 0), "fused_rope_rms_attention": blocks * 2,
            "fused_rms_cross_attention": blocks * 2}
    if counts != want:
        raise AssertionError(f"masked-init request launches {counts} != {want}")
    if video.shape != (1, n, h, w, 3) or video.dtype != np.uint8 or float(video.std()) == 0.0:
        raise AssertionError(f"bad output {video.shape} {video.dtype}")
    return counts


def i2v_y(pipe, image, n, h, w):
    """y as Wan i2v builds it: 4 mask channels keeping the first frame (the
    first frame's mask repeated 4 times, then one per frame, grouped by the
    VAE's 4-frame stride), then the VAE latents of the first frame followed
    by zero frames: [1, 20, T', H/8, W/8]."""
    dev = pipe.device
    ts, ss = pipe.vae_cfg.temporal_compression_ratio, pipe.vae_cfg.spatial_compression_ratio
    msk = torch.ones(1, n, h // ss, w // ss, device=dev)
    msk[:, 1:] = 0
    msk = torch.cat([msk[:, :1].repeat_interleave(ts, dim=1), msk[:, 1:]], dim=1)
    msk = msk.view(1, msk.shape[1] // ts, ts, h // ss, w // ss).transpose(1, 2)
    x = torch.zeros(1, 3, n, h, w, dtype=torch.bfloat16, device=dev)
    x[:, :, 0] = torch.as_tensor(image, device=dev).permute(2, 0, 1).float() / 127.5 - 1.0
    lat = pipe._vae_encode(x)
    return torch.cat([msk.to(lat.dtype), lat], dim=1).to(torch.bfloat16)


def i2v_dit_card_vs_cpu(pipe):
    """The i2v + camera DiT on the card against the same weights on the CPU
    at 192 tokens with y, clip_fea and y_camera (bf16, CFG-2 batch), bar
    5e-2 * max."""
    from versecrafter_tpu_torch.kernels.rope import grid_cos_sin
    from versecrafter_tpu_torch.models.wan_dit import wan_dit_forward
    from versecrafter_tpu_torch.sampling.pipeline import _to_device
    dev, cfg = pipe.device, pipe.dit_cfg
    g = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    lat, y, geo = rnd(2, 16, 3, 16, 16), rnd(2, 20, 3, 16, 16), rnd(2, 128, 3, 16, 16)
    clip, cam = rnd(2, 257, cfg.img_emb_dim), rnd(2, 24, 3, 128, 128)
    ctx = pipe.encode_prompt("a small check", "").to(torch.bfloat16)
    cos, sin = grid_cos_sin(pipe._angles, 3, 8, 8, device=dev)
    tvec = torch.full((2,), 700.0, device=dev)
    args = (lat, tvec, ctx, cos, sin)
    kw = dict(geoada_context=geo, y=y, clip_fea=clip, y_camera=cam)
    out_gpu = wan_dit_forward(pipe.dit_params, cfg, *args, **kw).float().cpu()
    cpu = _to_device(pipe.dit_params, "cpu")
    out_cpu = wan_dit_forward(cpu, cfg, *(a.cpu() for a in args),
                              **{k: v.cpu() for k, v in kw.items()}).float()
    del cpu
    rel = ((out_gpu - out_cpu).abs().max() / out_cpu.abs().max()).item()
    log(f"[extras] i2v + camera DiT ({len(pipe.dit_params['blocks'])} blocks + "
        f"{len(pipe.dit_params['geoada_blocks'])} GeoAdapter) card vs CPU at 192 tokens "
        f"with y, clip_fea, y_camera (bf16): rel err {rel:.4g} (bar 5e-2), "
        f"finite={bool(torch.isfinite(out_gpu).all())}")
    if not (rel <= 5e-2 and torch.isfinite(out_gpu).all()):
        raise AssertionError("the i2v DiT on the card disagrees with the CPU reference")


def cross_path_times(fa, pipe, card, rows=32760):
    """The i2v base block's plain cross path against the t2v block's fused
    cross at 480x832x81 CFG-2 ([2, 32,760, 1536] queries, 512 text keys, 257
    image keys), device ms by CUDA events: the whole cross-attention
    function (projections included) each way, and the plain path's parts
    (q RMSNorm, the relayouts to and from head-major, the two row-4b
    launches) beside the fused kernel alone."""
    from versecrafter_tpu_torch.kernels.flash_attention import _heads
    from versecrafter_tpu_torch.kernels.norms import rms_norm
    from versecrafter_tpu_torch.models import wan_dit as tw
    dev, cfg = pipe.device, pipe.dit_cfg
    p = pipe.dit_params["blocks"][0]["cross_attn"]
    g = torch.Generator(device=dev).manual_seed(41)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    x, ctx, img = rnd(2, rows, cfg.dim), rnd(2, 512, cfg.dim), rnd(2, 257, cfg.dim)
    n = cfg.num_heads
    t = {"i2v cross (plain path)": cuda_ms(lambda: tw._cross_attention(p, x, ctx, cfg, None, img), 5),
         "t2v cross (fused kernel)": cuda_ms(lambda: tw._cross_attention(p, x, ctx, cfg), 5)}
    q = tw._linear(p["q"], x)
    k, v = tw._linear(p["k"], ctx), tw._linear(p["v"], ctx)
    ki, vi = tw._linear(p["k_img"], img), tw._linear(p["v_img"], img)
    qh = _heads(rms_norm(q, p["norm_q"]["scale"], cfg.eps), n)
    kh, vh, kih, vih = (_heads(a, n) for a in (k, v, ki, vi))
    out = fa.flash_attention(qh, kh, vh)
    t["q RMSNorm"] = cuda_ms(lambda: rms_norm(q, p["norm_q"]["scale"], cfg.eps), 5)
    t["q relayout to head-major"] = cuda_ms(lambda: _heads(q, n), 5)
    t["row 4b, 512 text keys"] = cuda_ms(lambda: fa.flash_attention(qh, kh, vh), 5)
    t["row 4b, 257 image keys"] = cuda_ms(lambda: fa.flash_attention(qh, kih, vih), 5)
    t["add + relayout back"] = cuda_ms(
        lambda: (out + out).transpose(1, 2).reshape(2, rows, cfg.dim), 5)
    t["fused cross kernel alone"] = cuda_ms(lambda: fa.fused_rms_cross_attention(
        q, k, v, p["norm_q"]["scale"], p["norm_k"]["scale"], num_heads=n, eps=cfg.eps), 5)
    log(f"[extras] cross-attention of one block at 480x832x81 CFG-2, device ms on {card}:")
    for name, ms_ in t.items():
        log(f"  {name:28s} {ms_:8.3f}")
    plain = sum(t[k] for k in ("q RMSNorm", "q relayout to head-major", "row 4b, 512 text keys",
                               "row 4b, 257 image keys", "add + relayout back"))
    n_base = len(pipe.dit_params["blocks"])
    log(f"  plain path's parts {plain:.3f} ms vs the fused kernel "
        f"{t['fused cross kernel alone']:.3f} ms: x{n_base} base blocks, "
        f"{n_base * (plain - t['fused cross kernel alone']):.1f} ms a step")
    del x, ctx, img, q, k, v, ki, vi, qh, kh, vh, kih, vih, out
    torch.cuda.empty_cache()
    return t


def extras_phase(fa, fab, ms, dev, card, records, image, controls, mask):
    """Phase 11: the conditioning extras at the widths of Wan2.1-Fun-1.3B-InP
    (i2v, in_dim 36) + the GeoAdapter + the SimpleAdapter + the CLIP
    ViT-H/14 tower ('i2v-1.3b', random weights from seed 0). See the module
    docstring. Returns the requests' launches."""
    from versecrafter_tpu_torch.kernels.rope import grid_cos_sin
    from versecrafter_tpu_torch.models.clip import encode_image
    from versecrafter_tpu_torch.sampling import pipeline as tpipe
    from versecrafter_tpu_torch.sampling.pipeline import _to_device
    from versecrafter_tpu_torch.serve.model_server import default_pipeline_factory

    t0 = time.perf_counter()
    log(f"[extras] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the phase")
    records["flash_attention_inference"] = check_flash_cross(fa, dev, 512, card)
    r257 = check_flash_cross(fa, dev, 257, card, seed=1)
    records["flash_attention_inference"].update(
        {f"cross257_{k}": v for k, v in r257.items()})
    t1 = time.perf_counter()
    pipe = default_pipeline_factory(scale=I2V_SCALE, device=dev, seed=0)()
    randomize_zero_inits(pipe.dit_params, dev)
    torch.cuda.synchronize()
    cfg = pipe.dit_cfg
    log(f"[extras] i2v pipeline built (umT5-xxl + i2v Wan2.1-1.3B in_dim {cfg.in_dim} + "
        f"GeoAdapter {len(pipe.dit_params['geoada_blocks'])} blocks + SimpleAdapter + CLIP "
        f"ViT-H/14 depth {pipe.clip_cfg['depth']} + Wan VAE) in {time.perf_counter() - t1:.1f} "
        f"s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
    i2v_dit_card_vs_cpu(pipe)

    # the CLIP encode of a 480x832 uint8 frame: the card against the CPU
    tok = encode_image(pipe.clip_params, pipe.clip_cfg, image)
    enc_s = host_ms(lambda: encode_image(pipe.clip_params, pipe.clip_cfg, image)) / 1e3
    cpu_tok = encode_image(_to_device(pipe.clip_params, "cpu"), pipe.clip_cfg, image)
    err = (tok.cpu() - cpu_tok).abs().max().item()
    mx = cpu_tok.abs().max().item()
    log(f"[extras] encode_image 480x832 uint8 -> {tuple(tok.shape)} {tok.dtype}: {enc_s:.4f} s "
        f"on the card; against the CPU max|diff| {err:.4g}, bar {BF16_BAR * mx:.4g}")
    n_tok = (pipe.clip_cfg["img_size"] // pipe.clip_cfg["patch"]) ** 2 + 1
    if tuple(tok.shape) != (1, n_tok, pipe.clip_cfg["dim"]) or not err <= BF16_BAR * mx:
        raise AssertionError("encode_image on the card disagrees with the CPU")
    del cpu_tok

    # the profiled step takes phase 10's whole 81-frame render, the requests
    # its first FRAMES_E2E frames
    h, w = mask.shape[3:]
    n_base, n_geo = len(pipe.dit_params["blocks"]), len(pipe.dit_params["geoada_blocks"])
    y_step = i2v_y(pipe, image, mask.shape[2], h, w)
    gc_ = torch.Generator(device=dev).manual_seed(43)
    cam_step = torch.randn(1, 24, y_step.shape[2], h, w, generator=gc_,
                           device=dev).to(torch.bfloat16)
    n = FRAMES_E2E
    controls = [np.ascontiguousarray(c[:, :, :n]) for c in controls]
    mask = np.ascontiguousarray(mask[:, :, :n])
    y = i2v_y(pipe, image, n, h, w)
    cam = cam_step[:, :, :y.shape[2]].contiguous()
    fa.reset_launch_counts()
    fab.reset_launch_counts()
    ms.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    video = pipe("a red car drives left", negative_prompt="blurry", control_videos=controls,
                 mask_video=mask, clip_image=image, y=y, camera_video=cam, height=h, width=w,
                 num_frames=n, num_inference_steps=I2V_STEPS, guidance_scale=5.0, seed=43,
                 output_type="uint8")
    dt = time.perf_counter() - t1
    counts = {**fa.LAUNCHES, **fab.LAUNCHES, **ms.LAUNCHES}
    log(f"[extras] i2v + camera request (clip_image, y {tuple(y.shape)}, camera_video "
        f"{tuple(cam.shape)}, the four rendered controls; {I2V_STEPS} UniPC steps, CFG 5, "
        f"batched): {video.shape} {video.dtype} in {dt:.1f} s "
        f"{ {k: round(v, 3) for k, v in pipe.last_wall_profile.items()} } launches {counts}; "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    want = {**dict.fromkeys(counts, 0),
            "fused_rope_rms_attention": (n_base + n_geo) * I2V_STEPS,
            "fused_rms_cross_attention": n_geo * I2V_STEPS,
            "flash_attention": 2 * n_base * I2V_STEPS}
    if counts != want:
        raise AssertionError(f"i2v request launches {counts} != {want}")
    if video.shape != (1, n, h, w, 3) or video.dtype != np.uint8 or float(video.std()) == 0.0:
        raise AssertionError(f"bad output {video.shape} {video.dtype}")
    launches = dict(counts)

    # one subject reference frame: T' + 1 = 22 latent frames (y carries a
    # zero slot for it: the i2v DiT takes 36 channels), no camera maps
    drawn = []
    normal = tpipe.prng.normal

    def spy(key, shape, dtype):
        drawn.append(tuple(shape))
        return normal(key, shape, dtype)

    ref_img = [controls[0][:, :, :1].copy()]
    y22 = torch.cat([torch.zeros_like(y[:, :, :1]), y], dim=2)
    fa.reset_launch_counts()
    fab.reset_launch_counts()
    ms.reset_launch_counts()
    tpipe.prng.normal = spy
    t1 = time.perf_counter()
    try:
        video = pipe("a red car drives left", negative_prompt="blurry", control_videos=controls,
                     mask_video=mask, subject_ref_images=ref_img, clip_image=image, y=y22,
                     height=h, width=w, num_frames=n, num_inference_steps=2,
                     guidance_scale=5.0, seed=44, output_type="uint8")
    finally:
        tpipe.prng.normal = normal
    counts = {**fa.LAUNCHES, **fab.LAUNCHES, **ms.LAUNCHES}
    log(f"[extras] subject-reference request (2 steps): noise drawn at {drawn}, output "
        f"{video.shape} {video.dtype} in {time.perf_counter() - t1:.1f} s "
        f"{ {k: round(v, 3) for k, v in pipe.last_wall_profile.items()} } "
        f"launches {counts}")
    if drawn != [(1, pipe.vae_cfg.z_dim, y.shape[2] + 1, *y.shape[3:])] \
            or video.shape != (1, n, h, w, 3):
        raise AssertionError(f"reference request: noise {drawn}, output {video.shape}")
    want = {k_: v // I2V_STEPS * 2 for k_, v in want.items()}  # the same a step, 2 steps
    if counts != want:
        raise AssertionError(f"reference request launches {counts} != {want}")
    for k_, v in counts.items():
        launches[k_] += v
    del video, y22

    # one timed CFG-2 step under the profiler, then the cross path's parts
    g4 = torch.Generator(device=dev).manual_seed(81)
    y, cam = y_step, cam_step
    grid = y.shape[2:]
    lat = torch.randn(1, pipe.vae_cfg.z_dim, *grid, generator=g4, device=dev).to(torch.bfloat16)
    geo = torch.randn(1, cfg.resolved_geoada_in_dim, *grid, generator=g4,
                      device=dev).to(torch.bfloat16)
    ctx = pipe.encode_prompt("a red car drives left", "blurry").to(torch.bfloat16)
    cos, sin = grid_cos_sin(pipe._angles, grid[0], grid[1] // 2, grid[2] // 2, device=dev)
    extras = {"y": y, "clip_fea": tok.to(torch.bfloat16), "y_camera": cam}
    timed_step(lambda: pipe.denoise_step(lat, 999.0, ctx, geo, cos, sin, 5.0, 1.0, True,
                                         extras=extras),
               "i2v + camera (1.3B)", card, reps=1, tag="extras", top=12)
    cross_path_times(fa, pipe, card, rows=lat.numel() // lat.shape[1] // 4)
    del pipe, lat, geo, ctx, extras, y, cam, tok
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[extras] phase 11 {time.perf_counter() - t0:.1f} s")
    return launches


def tree_to(tree, device):
    """A parameter tree with every tensor moved to `device` (other leaves
    kept)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def rel_to_max(got, ref):
    """max|got - ref| / max|ref| over the entries finite in ref (on the CPU,
    in fp32)."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    fin = torch.isfinite(ref)
    if not torch.equal(fin, torch.isfinite(got)):
        return math.inf
    return ((got - ref)[fin].abs().max() / ref[fin].abs().max()).item()


def peak_since(base):
    """GiB allocated at the peak since the last reset, above `base` bytes."""
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def moge_check(dev, image, card):
    """MoGe-v2 at ViT-L + HEAD_L from seed 0 on the scene's first frame
    edge-padded to PRE_PAD: points and mask logits card vs CPU (MOGE_BAR *
    max), infer's focal and shift from each side's point map, a rerun
    bit-identical; seconds and peak. Returns (params on the card, infer's
    output on the card cropped to the image, seconds)."""
    from versecrafter_tpu_torch.perception import moge
    h, w = image.shape[:2]
    padded = np.pad(image, ((0, PRE_PAD[0] - h), (0, PRE_PAD[1] - w), (0, 0)), mode="edge")
    x = torch.from_numpy(padded.astype(np.float32) / 255.0)[None]
    t1 = time.perf_counter()
    params = moge.init_moge(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"[pre] MoGe ViT-L + HEAD_L built on the card in {time.perf_counter() - t1:.2f} s, "
        f"{sum(t.numel() for t in tree_leaves(params)) / 1e6:.1f} M parameters, "
        f"{(PRE_PAD[0] // 14) * (PRE_PAD[1] // 14)} tokens at {PRE_PAD[0]}x{PRE_PAD[1]}")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    moge.moge_forward(params, x.to(dev))  # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pts, mlog = moge.moge_forward(params, x.to(dev))
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t1
    peak = peak_since(base)
    pts2, mlog2 = moge.moge_forward(params, x.to(dev))
    same = torch.equal(pts, pts2) and torch.equal(mlog, mlog2)
    t1 = time.perf_counter()
    cpu_params = tree_to(params, "cpu")
    pts_h, mlog_h = moge.moge_forward(cpu_params, x)
    cpu_s = time.perf_counter() - t1
    e_pts, e_mask = rel_to_max(pts, pts_h), rel_to_max(mlog, mlog_h)
    f_c, s_c = moge.recover_focal_shift(pts[0].cpu().numpy(), (mlog[0] > 0).cpu().numpy())
    f_h, s_h = moge.recover_focal_shift(pts_h[0].numpy(), (mlog_h[0] > 0).numpy())
    log(f"[pre] MoGe forward {fwd_s * 1e3:.1f} ms on {card} (CPU {cpu_s:.1f} s), peak "
        f"{peak:.3f} GiB above the {base / 2**30:.2f} GiB before it; card vs CPU: points "
        f"{e_pts:.3e}, mask logits {e_mask:.3e} of max (bar {MOGE_BAR}); focal {f_c:.6f} vs "
        f"{f_h:.6f}, shift {s_c:.6f} vs {s_h:.6f}; rerun bit-identical: {same}")
    del cpu_params, pts_h, mlog_h, pts2, mlog2
    if not same:
        raise AssertionError("a rerun of MoGe gave other outputs")
    if max(e_pts, e_mask) > MOGE_BAR:
        raise AssertionError(f"MoGe card vs CPU {e_pts:.3e} / {e_mask:.3e} above {MOGE_BAR}")
    if abs(f_c - f_h) > MOGE_BAR * abs(f_h) or abs(s_c - s_h) > MOGE_BAR * max(abs(s_h), 1.0):
        raise AssertionError(f"focal / shift differ: {f_c} {s_c} vs {f_h} {s_h}")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = moge.infer(params, padded.astype(np.float32) / 255.0)
    infer_s = time.perf_counter() - t1
    for k in ("depth", "points", "mask"):
        out[k] = out[k][:h, :w]
    if not np.isfinite(out["depth"]).all() or out["depth"].shape != (h, w):
        raise AssertionError(f"depth {out['depth'].shape} not finite everywhere")
    log(f"[pre] infer (forward + host focal / shift) {infer_s:.3f} s; depth {h}x{w} in "
        f"[{out['depth'].min():.3f}, {out['depth'].max():.3f}], focal "
        f"{out['intrinsics'][0, 0]:.4f} (normalized fx)")
    return params, out, infer_s


def _tokenizer():
    import tempfile

    from versecrafter_tpu_torch.perception.wordpiece import SMOKE_VOCAB, WordPieceTokenizer
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write("\n".join(SMOKE_VOCAB))
    tok = WordPieceTokenizer(f.name)
    os.unlink(f.name)
    return tok


def segmenter_check(dev, image, labels, card):
    """The neural segmenter at full width and PRE_CPU_DEPTH depth (Swin-T
    896 + BERT-base widths, Hiera-L 1024 widths, from seed 1), card against
    the CPU. The two-stage query selection ranks ~16,660 proposals by
    continuous scores whose neighbours lie closer than the two devices'
    rounding, and each rank carries its own query embedding: so the
    encoder's scores are held to SEG_BAR * max, and both sides then decode
    the CPU's selection (the logits, boxes, and the masks / IoU of the same
    boxes within SEG_BAR * max). After asserting that every query's score
    and every kept detection's token probabilities clear their thresholds
    by DET_MARGIN (the sides' probabilities differing by less than half of
    it), the detection lists of that selection are compared."""
    from versecrafter_tpu_torch.perception import gdino_hf, sam2
    from versecrafter_tpu_torch.perception.segmenter import (
        IMAGENET_MEAN, IMAGENET_STD, ImageSegmenter)
    gen = torch.Generator(device=dev).manual_seed(1)
    gcfg = dict(gdino_hf.SWINT_CFG)
    scfg = dict(sam2.HIERA_LARGE, **PRE_CPU_DEPTH["sam2"])
    tok = _tokenizer()
    card_seg = ImageSegmenter(backend="neural", tokenizer=tok, **PRE_KNOBS,
                              gdino_params=(gdino_hf.init_gdino(gcfg, gen,
                                                                shapes=PRE_CPU_DEPTH["gdino"]),
                                            gcfg),
                              sam2_params=(sam2.init_sam2(gen, scfg), scfg))
    cpu_seg = ImageSegmenter(backend="neural", tokenizer=tok, **PRE_KNOBS,
                             gdino_params=(tree_to(card_seg.gdino_params[0], "cpu"), gcfg),
                             sam2_params=(tree_to(card_seg.sam2_params[0], "cpu"), scfg))
    t1 = time.perf_counter()
    ids, _ = gdino_hf.phrase_token_spans(tok, labels)
    L = ids.shape[1]
    gimg, _, _ = ImageSegmenter._letterbox(image, card_seg.det_size)
    px = torch.from_numpy(((gimg - IMAGENET_MEAN) / IMAGENET_STD).transpose(2, 0, 1)[None]
                          .astype(np.float32))
    enc_c = gdino_hf.gdino_encode(card_seg.gdino_params[0], gcfg, px, ids)
    enc_h = gdino_hf.gdino_encode(cpu_seg.gdino_params[0], gcfg, px, ids)
    top = gdino_hf.topk_stable(enc_h["scores"], gcfg["num_queries"])
    own = gdino_hf.topk_stable(enc_c["scores"], gcfg["num_queries"]).cpu()
    ranks_differ = int((own != top).sum())
    in_both = len(set(own[0].tolist()) & set(top[0].tolist()))
    lg_c, bx_c = gdino_hf.gdino_decode(card_seg.gdino_params[0], gcfg, enc_c, top.to(dev))
    lg_h, bx_h = gdino_hf.gdino_decode(cpu_seg.gdino_params[0], gcfg, enc_h, top)
    real_forward = gdino_hf.gdino_forward

    def cpu_selection(params, cfg, pixels, input_ids):  # both sides decode the CPU's ranks
        enc = gdino_hf.gdino_encode(params, cfg, pixels, input_ids)
        return gdino_hf.gdino_decode(params, cfg, enc, top.to(enc["vis"].device))
    gdino_hf.gdino_forward = cpu_selection
    try:
        found_h, pix_h, _, _ = cpu_seg.detect(image, labels)
        m_c, iou_c, _ = card_seg.masks_for_boxes(image, pix_h)
        m_h, iou_h, _ = cpu_seg.masks_for_boxes(image, pix_h)
        got = card_seg.segment_image(image, PRE_PROMPT)
        want = cpu_seg.segment_image(image, PRE_PROMPT)
    finally:
        gdino_hf.gdino_forward = real_forward
    errs = {"scores": rel_to_max(enc_c["scores"], enc_h["scores"]),
            "logits": rel_to_max(lg_c, lg_h), "boxes": rel_to_max(bx_c, bx_h),
            "masks": rel_to_max(m_c, m_h), "iou": rel_to_max(iou_c, iou_h)}
    p_c = torch.sigmoid(lg_c[0, :, :L].float().cpu())
    p_h = torch.sigmoid(lg_h[0, :, :L].float())
    dp = (p_c - p_h).abs().max().item()
    score_gap = (p_h.amax(-1) - PRE_KNOBS["box_threshold"]).abs().min().item()
    token_gap = min([(torch.from_numpy(d["probs"][1:L - 1]) - PRE_KNOBS["text_threshold"])
                     .abs().min().item() for d in found_h] or [math.inf])
    log(f"[pre] segmenter at depth {PRE_CPU_DEPTH} (card + CPU {time.perf_counter() - t1:.1f} s): "
        f"card vs CPU {({k: f'{v:.3e}' for k, v in errs.items()})} of max (bar {SEG_BAR}); "
        f"the card's own top-{gcfg['num_queries']} ranks differ at {ranks_differ} places "
        f"({in_both} proposals in both); probabilities differ by {dp:.2e} at most; closest "
        f"score to box_threshold {score_gap:.4f}, closest kept token to text_threshold "
        f"{token_gap:.4f} (margin {DET_MARGIN}); {len(found_h)} boxes kept after NMS")
    if max(errs.values()) > SEG_BAR:
        raise AssertionError(f"segmenter card vs CPU {errs} above {SEG_BAR}")
    if not (score_gap > DET_MARGIN and token_gap > DET_MARGIN and dp < DET_MARGIN / 2):
        raise AssertionError(f"a detection decision lies within {DET_MARGIN} of its threshold")
    agree = [float((a.mask == b.mask).mean()) for a, b in zip(got, want)]
    boxes = [[(d.label, tuple(int(v) for v in d.box)) for d in ds] for ds in (got, want)]
    log(f"[pre] detection lists: card {boxes[0]}, CPU {boxes[1]}; masks agree on "
        f"{[round(a, 5) for a in agree]} of pixels")
    if boxes[0] != boxes[1] or min(agree, default=1.0) < PRE_MASK_AGREE:
        raise AssertionError("the card's detection list differs from the CPU's")


def preprocess_phase(fa, fab, ms, pipe, dev, card):
    """Phase 12: the Blender add-on's preprocess, then the whole chain. MoGe
    (moge_check) and the segmenter's card-vs-CPU check (segmenter_check),
    then the segmenter at full depth (build_neural fresh_init: Swin-T 896 +
    BERT-base, Hiera-L 1024) with its seconds and peak; the chain on the
    scene's first frame, read back from a PNG uploaded to a port ApiServer
    (uploaded_image, with a JPEG fixture beside it): the card's depth and
    masks, written as the preprocess's PNGs by the port and read back equal
    (the masks eroded from their files) -> fit_objects_from_depth -> each
    fitted Gaussian moved sideways over 81 frames under the scene's camera
    -> render_control_maps -> a 2-step 480x832x81 request on phase 10's
    1.3B pipeline (45 launches a step per fused flavor). Returns the
    request's launches."""
    import shutil
    import tempfile

    from versecrafter_tpu_torch.geometry.synthetic import synthetic_scene
    t0 = time.perf_counter()
    h, w, n = RENDER_SIZE
    log(f"[pre] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the phase "
        f"(phase 10's pipeline resident)")
    scene = synthetic_scene(h, w, n, RENDER_SEED)
    media = tempfile.mkdtemp(prefix="versecrafter_pre_")
    try:
        image = uploaded_image(scene["image"], media, card)
        return chain_phase(fa, fab, ms, pipe, dev, card, scene, image, media, t0)
    finally:
        shutil.rmtree(media, ignore_errors=True)


def uploaded_image(image, media, card):
    """Phase 12's image as the add-on sends it: the scene's first frame
    written as a PNG by the port, a baseline and a progressive JPEG fixture,
    all uploaded to a port ApiServer over HTTP and read back from its
    workdir by the port's codecs: the PNG equal to the frame bit for bit,
    each JPEG to its fixture digest. Returns the PNG's image."""
    import urllib.request

    from versecrafter_tpu_torch.serve import api_server as api_mod
    from versecrafter_tpu_torch.serve.http import make_server, serve_forever_in_thread
    from versecrafter_tpu_torch.utils import png
    from versecrafter_tpu_torch.utils.video import load_image, read_image

    t1 = time.perf_counter()
    files = {"scene.png": png.encode(image)}
    for name, fixture in UPLOADED_JPEGS.items():
        with open(os.path.join(MEDIA_DIR, fixture), "rb") as f:
            files[name] = f.read()
    httpd = make_server(api_mod.build_router(api_mod.ApiServer(workdir=media)), "127.0.0.1", 0)
    serve_forever_in_thread(httpd)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        for name, data in files.items():
            req = urllib.request.Request(f"{url}/api/upload?filename=upload/{name}", data=data,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
    got = read_image(os.path.join(media, "upload", "scene.png"))
    with open(os.path.join(MEDIA_DIR, "digests.json")) as f:
        want = json.load(f)
    digests = {}
    for name, fixture in UPLOADED_JPEGS.items():
        photo = load_image(os.path.join(media, "upload", name))
        digests[name] = (photo.shape, hashlib.sha256(photo.tobytes()).hexdigest() == want[fixture])
    log(f"[pre] uploaded {[(k, len(v)) for k, v in files.items()]} bytes and read back in "
        f"{time.perf_counter() - t1:.2f} s: the PNG {got.shape} equal to the frame: "
        f"{np.array_equal(got, image)}; the JPEGs (shape, digest equal to the fixture's) "
        f"{digests} on the host of {card}")
    if not np.array_equal(got, image) or not all(ok for _, ok in digests.values()):
        raise AssertionError("an uploaded image did not read back as written")
    return got


def default_preprocess(moge_params, media, card):
    """Phase 12's default preprocess request, as the Blender add-on sends
    it: POST /api/preprocess naming only the uploaded progressive JPEG, so
    every other parameter is the default (the saliency segmenter, prompt
    "object."), to a port ApiServer whose MoGe is phase 12's ViT-L on the
    card, polled to its end. The task must complete with objects. Returns
    its seconds."""
    import urllib.request

    from versecrafter_tpu_torch.serve import api_server as api_mod
    from versecrafter_tpu_torch.serve.http import make_server, serve_forever_in_thread

    server = api_mod.ApiServer(workdir=media)
    server._moge_cache = moge_params
    httpd = make_server(api_mod.build_router(server), "127.0.0.1", 0)
    serve_forever_in_thread(httpd)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        t1 = time.perf_counter()
        req = urllib.request.Request(f"{url}/api/preprocess", method="POST",
                                     data=json.dumps({"image": "upload/photo_prog.jpg"}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            task = json.loads(r.read())["task_id"]
        while True:
            with urllib.request.urlopen(f"{url}/api/status/{task}", timeout=60) as r:
                st = json.loads(r.read())
            if st["status"] in ("COMPLETED", "FAILED") or time.perf_counter() - t1 > 300:
                break
            time.sleep(0.05)
        seconds = time.perf_counter() - t1
    finally:
        httpd.shutdown()
        httpd.server_close()
    log(f"[pre] default preprocess request (saliency) on the uploaded progressive JPEG: "
        f"{st['status']} in {seconds:.3f} s, result {st.get('result')}, on {card} and its host "
        f"({host_cpu()})")
    if st["status"] != "COMPLETED" or st["result"]["num_objects"] <= 0:
        raise AssertionError(f"the default preprocess request did not find objects: {st}")
    return seconds


def chain_phase(fa, fab, ms, pipe, dev, card, scene, image, media, t0):
    """Phase 12 from its uploaded image on (preprocess_phase says what)."""
    from versecrafter_tpu_torch.geometry.coords import (
        CV2BLENDER, blender_c2w_to_opencv_w2c, denormalize_intrinsics)
    from versecrafter_tpu_torch.geometry import render as tr
    from versecrafter_tpu_torch.geometry.gaussians import fit_objects_from_depth
    from versecrafter_tpu_torch.geometry.morphology import erode
    from versecrafter_tpu_torch.geometry.pointcloud import build_background
    from versecrafter_tpu_torch.geometry.splat import TAB20
    from versecrafter_tpu_torch.perception import moge
    from versecrafter_tpu_torch.perception.segmenter import ImageSegmenter
    from versecrafter_tpu_torch.serve.model_server import run_loaded_request
    from versecrafter_tpu_torch.utils.video import read_image
    h, w, n = RENDER_SIZE
    labels = [t.strip() for t in PRE_PROMPT.split(".") if t.strip()]
    stages = {}
    moge_params, out, stages["depth"] = moge_check(dev, image, card)
    default_preprocess(moge_params, media, card)
    segmenter_check(dev, image, labels, card)

    t1 = time.perf_counter()
    seg = ImageSegmenter.build_neural(fresh_init=True, device=dev, **PRE_KNOBS)
    seg.tokenizer = _tokenizer()  # the smoke vocabulary, whatever the cache holds
    torch.cuda.synchronize()
    log(f"[pre] segmenter at full depth built in {time.perf_counter() - t1:.2f} s "
        f"(Grounding DINO Swin-T + BERT-base fp32, SAM 2.1 Hiera-L)")
    seg.detect(image, labels)  # warm-up of both models
    seg.masks_for_boxes(image, np.array([[10.0, 10.0, 200.0, 200.0]]))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    found, pix, _, _ = seg.detect(image, labels)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    seg.masks_for_boxes(image, pix)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    log(f"[pre] Grounding DINO {t2 - t1:.3f} s ({len(found)} boxes after NMS), SAM 2.1 "
        f"{t3 - t2:.3f} s ({PRE_KNOBS['max_objects'] * 2} prompts); peak "
        f"{peak_since(base):.3f} GiB above {base / 2**30:.2f} GiB, on {card}")

    t1 = time.perf_counter()
    dets = seg.segment_image(image, PRE_PROMPT)
    stages["segment"] = time.perf_counter() - t1
    log(f"[pre] segment_image: {len(dets)} detections (label, score, box, mask pixels) "
        f"{[(d.label, round(d.score, 3), tuple(int(v) for v in d.box), int(d.mask.sum())) for d in dets]}")
    if not dets:
        raise AssertionError("no detection at full depth")

    # the preprocess files, written and read back by the port
    t1 = time.perf_counter()
    moge.save_outputs(out, os.path.join(media, "estimated_depth"))
    paths = seg.save_results(image, dets, os.path.join(media, "object_mask"), stem="scene")
    depth = moge.replace_infs_with_max(out["depth"])
    back = {"depth_gray": (read_image(os.path.join(media, "estimated_depth", "depth_gray.png")),
                           moge.grayscale_depth(depth)),
            "depth_vis": (read_image(os.path.join(media, "estimated_depth", "depth_vis.png")),
                          moge.colorize_depth(depth))}
    files = sorted(k for k in paths if k.startswith("mask_"))
    for i, (k, d) in enumerate(zip(files, dets)):
        back[k] = (read_image(paths[k], gray=True), d.mask.astype(np.uint8) * 255)
    stages["files"] = time.perf_counter() - t1
    equal = {k: np.array_equal(a, b) for k, (a, b) in back.items()}
    log(f"[pre] depth and mask PNGs written and read back in {stages['files']:.2f} s, equal to "
        f"the arrays: {equal}")
    if len(files) != len(dets) or not all(equal.values()):
        raise AssertionError(f"preprocess files read back other arrays: {equal}")

    # the chain: depth + masks (from their files) -> Gaussians -> trajectories
    # -> maps -> video
    t1 = time.perf_counter()
    masks = {i + 1: (d.label, erode(back[k][0] > 127, 5))
             for i, (k, d) in enumerate(zip(files, dets))}
    fitted = fit_objects_from_depth(out["depth"], out["intrinsics"], masks)
    stages["gaussian"] = time.perf_counter() - t1
    if not fitted:
        raise AssertionError("no object fitted from the card's depth and masks")
    t1 = time.perf_counter()
    K = denormalize_intrinsics(out["intrinsics"], w, h)
    union = np.any([d.mask for d in dets], 0).astype(np.uint8)
    pts, cols = build_background(image, out["depth"], K, union)
    f = np.arange(n, dtype=np.float32) / (n - 1)
    ids = sorted(fitted)
    mean0 = np.array([fitted[i]["mean"] for i in ids], np.float32) @ CV2BLENDER.T
    cov0 = np.array([CV2BLENDER @ np.array(fitted[i]["cov"]) @ CV2BLENDER.T for i in ids],
                    np.float32)
    step = np.abs(mean0[:, 1:2]) * np.array([[0.3, 0.0, 0.0]], np.float32)  # sideways
    means = mean0[None] + f[:, None, None] * step[None]
    covs = np.broadcast_to(cov0[None], (n,) + cov0.shape).copy()
    present = np.ones((n, len(ids)), bool)
    args = (pts, cols, K, blender_c2w_to_opencv_w2c(scene["c2w_blender"]), means, covs,
            present, TAB20[np.arange(len(ids)) % 20], (h, w))
    stages["trajectories"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    maps = tr.render_control_maps(*args, device=dev)
    stages["render"] = time.perf_counter() - t1
    for name, v in maps.items():
        if v.shape != (n, h, w, 3) or v.dtype != np.uint8:
            raise AssertionError(f"{name}: {v.shape} {v.dtype}")
    drawn = int(maps["3D_gaussian_RGB"].any(-1).any((1, 2)).sum())
    log(f"[pre] fitted {len(fitted)} Gaussians "
        f"{ {i: (fitted[i]['label'], fitted[i]['num_points']) for i in ids} }; "
        f"{len(pts)} background points; Gaussian pixels drawn in {drawn} of {n} frames")
    controls, mask = maps_to_request(maps, image)
    del maps
    fa.reset_launch_counts()
    fab.reset_launch_counts()
    ms.reset_launch_counts()
    t1 = time.perf_counter()
    video = run_loaded_request(pipe, {"prompt": "a red car drives left", "negative_prompt":
                                      "blurry", "num_inference_steps": STEPS,
                                      "guidance_scale": 5.0, "seed": 17, "height": h,
                                      "width": w, "num_frames": n}, controls, mask)
    stages["generate"] = time.perf_counter() - t1
    counts = dict(fa.LAUNCHES)
    wall = sum(stages.values())
    log(f"[chain] image -> depth + masks -> Gaussians -> control maps -> video: "
        f"{ {k: round(v, 3) for k, v in stages.items()} } s, {wall:.2f} s from image to "
        f"video (models built beforehand); request "
        f"{ {k: round(v, 3) for k, v in pipe.last_wall_profile.items()} } launches {counts}; "
        f"output {video.shape} {video.dtype} on {card}")
    want = {"fused_rope_rms_attention": 45 * STEPS, "fused_rope_rms_attention_int8": 0,
            "fused_rms_cross_attention": 45 * STEPS, "flash_attention": 0}
    if counts != want or any(fab.LAUNCHES.values()) or any(ms.LAUNCHES.values()):
        raise AssertionError(f"launch counts {counts} {fab.LAUNCHES} {ms.LAUNCHES} != {want}")
    if video.shape != (1, n, h, w, 3) or video.dtype != np.uint8 or float(video.std()) == 0.0:
        raise AssertionError(f"bad output {video.shape} {video.dtype}")
    del video, seg, moge_params, controls, mask
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[pre] phase 12 {time.perf_counter() - t0:.1f} s")
    return counts


def check_kernel_720p(fa, name, ctx_len, dev):
    """Phase 13, part 1: one fused flavor at the 14B width at 720x1280x81
    CFG-2 ([2, 75,600, 40, 128]; the cross flavor against `ctx_len` keys),
    with the card empty, through check_kernel: a rerun bit-identical, the
    columns of heads HEADS_720P of both batch items held to the plain
    version on those heads (the far offsets of every TMA map and store),
    the time beside the bound and SDPA's. Returns the record's 720p keys
    (plain_ms is the two heads')."""
    rec = check_kernel(fa, name, 2, 21 * 45 * 80, ctx_len or 21 * 45 * 80, 40, dev,
                       timed=True, rerun=True, heads=HEADS_720P)
    rec["plain_2heads_ms"] = rec.pop("plain_ms")
    return {f"720p_{k}": v for k, v in rec.items()}


def render_720p(card):
    """Phase 13's controls: the seeded scene rendered at 720x1280x81 on the
    card, as a request's inputs; returns (controls, mask, render seconds)."""
    from versecrafter_tpu_torch.geometry import render as tr
    h, w, n = SIZE_720P
    scene, args = render_inputs(h, w, n, RENDER_SEED)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    maps = tr.render_control_maps(*args, device="cuda")
    render_s = time.perf_counter() - t0
    prof = tr.last_render_profile
    log(f"[720p] the seeded scene rendered at {h}x{w}x{n}: wall {render_s:.3f} s, device "
        f"{prof['device_s']:.4f} s ({prof['device_fps']:.1f} frames/s), peak "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB above the "
        f"{base / 2**30:.2f} allocated on {card}")
    controls, mask = maps_to_request(maps, scene["image"])
    if any(c.shape != (1, 3, n, h, w) for c in controls) or mask.shape != (1, 1, n, h, w):
        raise AssertionError(f"720p request inputs {[c.shape for c in controls]} {mask.shape}")
    return controls, mask, render_s


def resident_720p(pipe, controls, mask, card):
    """Phase 13, part 2, on phase 7's resident 14B pipeline: the 720x1280x81
    request's first denoise step (its noise from the request's seed, the
    prompt pair through the resident umT5, the rendered controls through the
    resident VAE, the first of STAGED_STEPS UniPC timesteps) as sequential
    CFG, timed, with its peak. The batched step runs only where the measured
    sequential peak plus the memory model's batched-over-sequential term
    stays under the model's bar. Returns the predictions on the host (the
    staged request's first step is held to them) and the numbers."""
    from versecrafter_tpu_torch.kernels.rope import grid_cos_sin
    from versecrafter_tpu_torch.sampling import staged
    from versecrafter_tpu_torch.sampling.schedulers import make_scheduler
    from versecrafter_tpu_torch.utils import prng
    dev, cfg = pipe.device, pipe.dit_cfg
    prompt, negative, seed = REQUEST_720P
    h, w, n = SIZE_720P
    t0 = time.perf_counter()
    ctx = pipe.encode_prompt(prompt, negative).to(torch.bfloat16)
    geo, _ = pipe.encode_controls(controls, mask, torch.bfloat16)
    f, hl, wl = geo.shape[2:]
    lat = prng.normal(prng.key(seed, dev), (1, pipe.vae_cfg.z_dim, f, hl, wl), torch.bfloat16)
    cos, sin = grid_cos_sin(pipe._angles, f, hl // 2, wl // 2, device=dev)
    t = float(np.float32(make_scheduler(pipe.scheduler_name, pipe.scheduler_cfg)
                         .set_timesteps(STAGED_STEPS, shift=16.0)[0]))
    torch.cuda.synchronize()
    tokens = cos.shape[0]
    log(f"[720p] resident step inputs ({tokens} tokens, t = {t}): prompt + controls encoded "
        f"in {time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated")
    out = {"t": t, "tokens": tokens}
    before = torch.cuda.memory_allocated() / 2**30
    t1 = time.perf_counter()
    seq, extra = sequential_step(pipe, lat, ctx, geo, cos, sin, "720p", card, reps=1, t=t)
    out["seq_s"] = time.perf_counter() - t1
    out["seq"], out["seq_peak"] = seq.float().cpu(), before + extra
    del seq
    est = {b: staged.estimate_denoise_gb(cfg, 0, tokens, b) for b in (1, 2)}
    predicted = out["seq_peak"] + est[2] - est[1]
    fits = predicted <= staged.CARD_MODEL.fits_gb
    log(f"[720p] resident sequential-CFG step peak {out['seq_peak']:.2f} GiB; a batched "
        f"step predicted at {predicted:.2f} GiB (+{est[2] - est[1]:.2f} from the memory "
        f"model), bar {staged.CARD_MODEL.fits_gb} GiB: "
        f"{'fits, timed' if fits else 'does not fit, not launched'}")
    out["batched"] = None
    if not fits and staged.auto_cfg_parallel(cfg, 0, tokens):
        # the staged request runs batched, held to this sequential step at
        # twice the noise floor (in correlation too, as phase 7 holds it)
        lat_p = (lat.float() * (1 + 2.0 ** -8)).to(lat.dtype)
        moved, _ = sequential_step(pipe, lat_p, ctx, geo, cos, sin, "720p", card, reps=1, t=t)
        out["floor"] = compare("720p sequential step at latents x (1 + 2^-8) vs the step "
                               "(noise floor)", moved.float().cpu(), out["seq"])
        out["corr_bar"] = min(0.999, 1.0 - 2.0 * (1.0 - correlation(moved.float().cpu(),
                                                                     out["seq"])))
        del lat_p, moved
    if fits:
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        pred = pipe.denoise_step(lat, t, ctx, geo, cos, sin, 5.0, 1.0, True)
        torch.cuda.synchronize()
        out["batched_s"] = time.perf_counter() - t1
        out["batched_peak"] = torch.cuda.max_memory_allocated() / 2**30
        out["batched"] = pred.float().cpu()
        log(f"[720p] resident batched CFG-2 step {out['batched_s'] * 1e3:.1f} ms, peak "
            f"{out['batched_peak']:.2f} GiB on {card}")
        del pred
    del lat, geo, ctx, cos, sin
    gc.collect()
    torch.cuda.empty_cache()
    return out


class StageMemory:
    """Wraps sampling/staged._free for one staged request: after each stage
    it records the stage's peak (torch.cuda.max_memory_allocated since the
    last stage) and the bytes still allocated once the weights are freed."""

    def __init__(self, staged):
        self.staged, self.free, self.rows = staged, staged._free, []

    def __enter__(self):
        torch.cuda.synchronize()
        self.base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def free(pipe, attr):
            peak = torch.cuda.max_memory_allocated()
            self.free(pipe, attr)
            self.rows.append((attr, peak, torch.cuda.memory_allocated()))
            torch.cuda.reset_peak_memory_stats()
        self.staged._free = free
        return self

    def __exit__(self, *exc):
        self.staged._free = self.free

    def check(self, tag, outputs):
        """`outputs`: bytes the stage outputs hold after each free, in order;
        allocated must be back within 64 MiB of base + outputs."""
        for (attr, peak, after), held in zip(self.rows, outputs):
            log(f"[{tag}] after freeing {attr}: peak {peak / 2**30:.2f} GiB, then "
                f"{(after - self.base) / 2**20:.1f} MiB above the "
                f"{self.base / 2**30:.2f} GiB allocated before the request (the stage "
                f"outputs {held / 2**20:.1f} MiB)")
            if after - self.base > held + (64 << 20):
                raise AssertionError(f"{tag}: freeing {attr} left "
                                     f"{(after - self.base) / 2**20:.1f} MiB allocated")
        if len(self.rows) != len(outputs):
            raise AssertionError(f"{tag}: {len(self.rows)} stages freed, expected "
                                 f"{len(outputs)}")


def staged_720p(fa, fab, ms, dev, card, controls, mask, render_s, resident):
    """Phase 13, parts 3-5, after phase 7's pipelines are gone: the 14B
    request at 720x1280x81 through generate_staged with
    fresh_init_factories("14b", bits=0) (phase 7's DiT bit for bit, its
    zero-init leaves made random as there), STAGED_STEPS UniPC steps, CFG 5,
    cfg_parallel from auto_cfg_parallel: each stage's seconds and peak,
    the bytes left after each free, the launches, the frames, and the first
    step's prediction against part 2's resident one; then the Wan2.2 swap
    under staged residency on the same request with two custom timesteps
    (the high expert from seed 1); then the record -> fit -> fire path at
    the 1.3B widths. Returns the 720p requests' launches."""
    from versecrafter_tpu_torch.sampling import pipeline as tp
    from versecrafter_tpu_torch.sampling import staged
    from versecrafter_tpu_torch.sampling import teacache as tc
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[720p] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the staged "
        f"requests")
    prompt, negative, seed = REQUEST_720P
    h, w, n = SIZE_720P
    factories, cfg, vae_cfg, t5_cfg = staged.fresh_init_factories("14b", bits=0, device=dev)

    def randomized(factory, seed_):
        def build():
            params = factory()
            randomize_zero_inits(params, dev, seed=7 + seed_)
            return params
        return build

    low = factories.dit = randomized(factories.dit, 0)
    tokens = staged.request_tokens(cfg, vae_cfg, h, w, n)
    batched = staged.auto_cfg_parallel(cfg, 0, tokens)
    evals = 1 if batched else 2
    blocks = cfg.num_layers + len(cfg.resolved_geoada_layers)
    mode = "batched" if batched else "sequential"
    log(f"[720p] auto_cfg_parallel: {mode} CFG (estimate "
        f"{staged.estimate_denoise_gb(cfg, 0, tokens, 2):.2f} GiB batched, "
        f"{staged.estimate_denoise_gb(cfg, 0, tokens, 1):.2f} sequential; bar "
        f"{staged.CARD_MODEL.fits_gb})")

    def shell():
        return tp.VerseCrafterPipeline(dit_params=None, dit_cfg=cfg, vae_params=None,
                                       vae_cfg=vae_cfg, t5_params=None, t5_cfg=t5_cfg,
                                       cfg_parallel=batched, device=dev)

    f_lat, hl, wl = (n - 1) // 4 + 1, h // 8, w // 8
    outputs = [2 * 512 * t5_cfg.dim * 2,  # the prompt pair's embedding, bf16
               2 * 512 * t5_cfg.dim * 2 + (4 * vae_cfg.z_dim + 64) * f_lat * hl * wl * 2,
               vae_cfg.z_dim * f_lat * hl * wl * 2, 0]  # the latents, then nothing
    counts_all = {}

    def launches():
        counts = {**fa.LAUNCHES, **fab.LAUNCHES, **ms.LAUNCHES}
        for k_, v in counts.items():
            counts_all[k_] = counts_all.get(k_, 0) + v
        return counts

    def want(counts, steps):
        return {**dict.fromkeys(counts, 0), "fused_rope_rms_attention": blocks * steps * evals,
                "fused_rms_cross_attention": blocks * steps * evals}

    # part 3: the staged request, its first step's prediction captured
    step, first = tp.Denoiser.step, []

    def capture(self, i, *a, **kw):
        pred = step(self, i, *a, **kw)
        if i == 0 and not first:
            first.append(pred.float().cpu())
        return pred

    pipe = shell()
    fa.reset_launch_counts()
    fab.reset_launch_counts()
    ms.reset_launch_counts()
    tp.Denoiser.step = capture
    t1 = time.perf_counter()
    try:
        with StageMemory(staged) as mem:
            video = staged.generate_staged(
                pipe, factories, prompt, negative, control_videos=controls, mask_video=mask,
                height=h, width=w, num_frames=n, num_inference_steps=STAGED_STEPS,
                guidance_scale=5.0, shift=16.0, seed=seed)
    finally:
        tp.Denoiser.step = step
    dt = time.perf_counter() - t1
    counts = launches()
    prof = pipe.last_stage_profile
    log(f"[720p] staged request {h}x{w}x{n}, {STAGED_STEPS} UniPC steps, CFG 5 {mode}: "
        f"{video.shape} {video.dtype} in {dt:.1f} s; render {render_s:.2f} s before it; "
        f"stages {prof}; launches {counts} on {card}")
    mem.check("720p", outputs)
    if counts != want(counts, STAGED_STEPS):
        raise AssertionError(f"staged 720p launches {counts} != {want(counts, STAGED_STEPS)}")
    if video.shape != (1, n, h, w, 3) or video.dtype != np.uint8 or float(video.std()) == 0.0:
        raise AssertionError(f"bad output {video.shape} {video.dtype}")
    del video
    ref = resident["batched" if batched else "seq"]
    if ref is not None:  # the same CFG mode on the same weights and inputs
        same = torch.equal(first[0], ref)
        compare(f"staged first step ({mode}) vs the resident one", first[0], ref)
        log(f"    bit-identical: {same}")
        if not same:
            raise AssertionError("the staged 720p step differs from the resident one")
    else:  # batched against the resident sequential step: twice the noise floor
        compare(f"staged first step ({mode}) vs the resident sequential one", first[0],
                resident["seq"], corr_bar=resident["corr_bar"], err_bar=2 * resident["floor"])

    # part 4: the Wan2.2 swap under staged residency, one step per expert
    high = randomized(staged.fresh_init_factories("14b", bits=0, seed=1, device=dev)[0].dit, 1)
    builds = []

    def swap(which):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t2 = time.perf_counter()
        params = (high if which == "high" else low)()
        torch.cuda.synchronize()
        builds.append((which, time.perf_counter() - t2, before))
        return params

    pipe = shell()
    pipe.expert_swap, pipe.moe_boundary = swap, MOE_BOUNDARY
    fa.reset_launch_counts()
    fab.reset_launch_counts()
    ms.reset_launch_counts()
    t1 = time.perf_counter()
    with StageMemory(staged) as mem:
        video = staged.generate_staged(
            pipe, factories, prompt, negative, control_videos=controls, mask_video=mask,
            height=h, width=w, num_frames=n, timesteps=list(MOE_TIMESTEPS),
            guidance_scale=5.0, seed=seed)
    dt = time.perf_counter() - t1
    counts = launches()
    for which, s_, before in builds:
        log(f"[720p-moe] expert_swap('{which}'): built in {s_:.1f} s with "
            f"{before / 2**30:.2f} GiB allocated just before")
    log(f"[720p-moe] staged expert swap at {h}x{w}x{n}, timesteps {MOE_TIMESTEPS} (boundary "
        f"{MOE_BOUNDARY}), CFG 5 {mode}: {video.shape} {video.dtype} in {dt:.1f} s; stages "
        f"{pipe.last_stage_profile}; launches {counts} on {card}")
    mem.check("720p-moe", outputs)
    if [b[0] for b in builds] != ["high", "low"]:
        raise AssertionError(f"swap calls {[b[0] for b in builds]} != ['high', 'low']")
    if builds[1][2] > builds[0][2] + (64 << 20):
        raise AssertionError("the high expert was not freed before the low one was built")
    if counts != want(counts, 2):
        raise AssertionError(f"staged swap launches {counts} != {want(counts, 2)}")
    if video.shape != (1, n, h, w, 3) or video.dtype != np.uint8 or float(video.std()) == 0.0:
        raise AssertionError(f"bad output {video.shape} {video.dtype}")
    del video, pipe, controls, mask
    gc.collect()

    # part 5: record -> fit -> fire at the 1.3B widths
    t1 = time.perf_counter()
    factories, cfg13, vae_cfg, t5_cfg = staged.fresh_init_factories("1.3b", bits=0, device=dev)
    factories.dit = randomized(factories.dit, 0)
    fh, fw, fn = FIT_SIZE
    fctl, fmask = synth_request(fn, fh, fw, 51)
    pipe = tp.VerseCrafterPipeline(dit_params=None, dit_cfg=cfg13, vae_params=None,
                                   vae_cfg=vae_cfg, t5_params=None, t5_cfg=t5_cfg, device=dev)
    kw = dict(control_videos=fctl, mask_video=fmask, height=fh, width=fw, num_frames=fn,
              num_inference_steps=FIT_STEPS, guidance_scale=5.0, seed=51)
    rel_e0, rel_res = staged.generate_staged(pipe, factories, "a harbour at dawn", "blurry",
                                             record_teacache=True, **kw)
    coeffs = tc.fit_teacache_coefficients(rel_e0, rel_res, degree=4)
    thresh = float(np.median(np.polyval(coeffs, rel_e0)) * 1.5)
    pipe.enable_teacache(max(thresh, 1e-6), 1, coefficients=coeffs)
    pipe.vae_params = factories.vae()
    recorded = pipe.decode_latents(pipe.last_record_latents, "uint8")
    pipe.last_record_latents = None
    staged._free(pipe, "vae_params")
    fa.reset_launch_counts()
    fired = staged.generate_staged(pipe, factories, "a harbour at dawn", "blurry", **kw)
    ran = fa.LAUNCHES["fused_rope_rms_attention"]
    log(f"[fit] record -> fit -> fire at {fh}x{fw}x{fn}, {FIT_STEPS} steps (1.3B widths): "
        f"rel_e0 {rel_e0.shape}, coefficients {[f'{c:.4g}' for c in coeffs]}, threshold "
        f"{thresh:.4g}; the recorded video {recorded.shape}, the fired one {fired.shape} with "
        f"{ran} self-attention launches ({45 * FIT_STEPS} without a skip); its stages "
        f"{pipe.last_stage_profile}; {time.perf_counter() - t1:.1f} s")
    if rel_e0.shape != (FIT_STEPS - 1, 2) or not np.all(np.isfinite(coeffs)):
        raise AssertionError(f"bad TeaCache record / fit {rel_e0.shape} {coeffs}")
    for v in (recorded, fired):
        if v.shape != (1, fn, fh, fw, 3) or v.dtype != np.uint8:
            raise AssertionError(f"bad output {v.shape} {v.dtype}")
    if not 0 < ran <= 45 * FIT_STEPS:
        raise AssertionError(f"the fired request launched {ran} self-attention kernels")
    log(f"[720p] phase 13's staged part {time.perf_counter() - t0:.1f} s")
    return counts_all


# phase 14: the reference's 8-GPU operating points, one rank's share
SP_RANKS = 8
ULYSSES_POINT = (2, 40, 21 * 45 * 80)  # 14B at 720x1280x81, CFG-2: B, heads, tokens
RING_POINT = (2, 12, 21 * 30 * 52)     # 1.3B at 480x832x81, CFG-2
RING_TRAIN_POINT = (1, 12, 21 * 30 * 52)  # its train step, batch 1
ULYSSES_HEADS = (0, 4)  # of the five a rank holds after the all_to_all


def free_tcp_port():
    import socket
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        return s_.getsockname()[1]


def nccl_world_of_one(dev):
    """Phase 14 (e): torchrun's environment for one rank, the port's own
    bootstrap (utils/cache.maybe_init_distributed: NCCL on the card) and
    make_mesh(MeshSpec()); one all_to_all_single (sharding's Ulysses
    collective) and one batch_isend_irecv (the ring's rotation) to itself on
    card tensors. Returns the mesh; the caller destroys the group."""
    from versecrafter_tpu_torch.core.mesh import MeshSpec, auto_mesh_spec, make_mesh
    from versecrafter_tpu_torch.kernels import ring_attention as ring
    from versecrafter_tpu_torch.parallel import sharding as shd
    from versecrafter_tpu_torch.serve.model_server import resolve_mesh
    from versecrafter_tpu_torch.utils.cache import maybe_init_distributed

    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(free_tcp_port()))
    t0 = time.perf_counter()
    if not maybe_init_distributed(dev):
        raise AssertionError("maybe_init_distributed did not initialise the world")
    if maybe_init_distributed(dev):
        raise AssertionError("maybe_init_distributed is not idempotent")
    mesh = make_mesh(MeshSpec(), dev)
    backend = torch.distributed.get_backend()
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(1, 2, 5, 4095, 128, generator=g, device=dev).to(torch.bfloat16)
    y = shd._AllToAll.apply(x, mesh.group("sp"))
    (z,) = ring._rotate((x[0],), mesh.group("sp"), mesh.global_ranks("sp"))
    torch.cuda.synchronize()
    ok = torch.equal(y, x) and torch.equal(z, x[0]) and y.is_cuda and z.is_cuda
    single = auto_mesh_spec(1) == MeshSpec() and resolve_mesh(None, True, 40, dev) is None
    log(f"  [nccl] world of one: backend {backend}, mesh {mesh.spec.shape}, "
        f"all_to_all_single and batch_isend_irecv to itself on {tuple(x.shape)} bf16 "
        f"{'equal' if ok else 'DIFFER'}; auto_mesh_spec(1) -> single device: {single} "
        f"({time.perf_counter() - t0:.1f} s)")
    if backend != "nccl" or not ok or not single:
        raise AssertionError("the NCCL world of one failed")
    return mesh


def ulysses_rank_local(fa, mesh, dev, card):
    """Phase 14 (a): one rank's attention after the Ulysses all_to_all at
    sp = 8 on the 14B 720x1280x81 CFG-2 point, [2, 5, 75,600, 128], through
    sharding.ulysses_attention (its kernel is row 4b); held to the plain
    version on two of the five heads. Returns (record, launches)."""
    from versecrafter_tpu_torch.parallel import sharding as shd
    B, N, S = ULYSSES_POINT
    n, D = N // SP_RANKS, fa.HEAD_DIM
    g = torch.Generator(device=dev).manual_seed(14)
    q = (2.0 * torch.randn(B, n, S, D, generator=g, device=dev)).to(torch.bfloat16)
    k, v = (torch.randn(B, n, S, D, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    fa.reset_launch_counts()
    with shd.mesh_context(mesh):
        out = shd.ulysses_attention(q, k, v)
    torch.cuda.synchronize()
    launches = fa.LAUNCHES["flash_attention"]
    heads = list(ULYSSES_HEADS)
    t0 = time.perf_counter()
    ref = fa.flash_attention_plain(q[:, heads], k[:, heads], v[:, heads])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    rec = {"max_abs_err": agree(f"Ulysses rank-local {tuple(q.shape)}, heads {heads}",
                                out[:, heads], ref)}
    del ref
    rec["ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v), 3)
    rec["plain_ms"] = plain_ms  # on two of the five heads (the whole would take ~3 s)
    rec["library_ms"] = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 3)
    rec["bound_ms"], rec["bound_by"] = bound(4 * B * n * S * S * D,
                                             (2 * q.numel() + k.numel() + v.numel()) * 2)
    log(f"  [ulysses] {rec['ms']:.3f} ms (bound {rec['bound_ms']:.3f} ms, "
        f"{rec['bound_by']}; {rec['ms'] / rec['bound_ms']:.2f}x), SDPA "
        f"{rec['library_ms']:.3f} ms, plain {plain_ms:.0f} ms for two heads; launches "
        f"{launches} on {card}")
    del q, k, v, out
    torch.cuda.empty_cache()
    return rec, launches


def ring_rank_local(fa, fab, dev, card):
    """Phase 14 (b): the ring where the dispatch takes it, 1.3B (12 heads,
    12 % 8 != 0) at 480x832x81 CFG-2 over sp = 8: the q shards of ranks 0
    and 7, [2, 12, 4,095, 128], against all eight K/V shards through
    ring_attention.attend_shard (row 4a + the merge), held to the full
    attention's rows of each shard. Returns (hop record, launches)."""
    from versecrafter_tpu_torch.kernels import ring_attention as ring
    from versecrafter_tpu_torch.parallel import sharding as shd
    B, N, S = RING_POINT
    n = S // SP_RANKS
    if N % SP_RANKS == 0:
        raise AssertionError("this point must take the ring")
    D = fa.HEAD_DIM
    # the stats flavor at the hop shape against its plain version, timed
    rec = check_flash(fa, fab, B, N, n, n, dev, timed=True, seed=8)["flash_attention"]
    g = torch.Generator(device=dev).manual_seed(15)
    q = (2.0 * torch.randn(B, N, S, D, generator=g, device=dev)).to(torch.bfloat16)
    k, v = (torch.randn(B, N, S, D, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    shards = [(k[:, :, j * n:(j + 1) * n].contiguous(), v[:, :, j * n:(j + 1) * n].contiguous())
              for j in range(SP_RANKS)]
    ranks = (0, SP_RANKS - 1)
    qs = {r: q[:, :, r * n:(r + 1) * n].contiguous() for r in ranks}

    def ring_rows(r):  # rank r's hops, in its ring order
        acc = None
        for hop in range(SP_RANKS):
            kb, vb = shards[(r - hop) % SP_RANKS]
            acc = ring.attend_shard(qs[r], kb, vb, acc)
        return acc

    fa.reset_launch_counts()
    got = {r: ring_rows(r)[0] for r in ranks}
    torch.cuda.synchronize()
    launches = fa.LAUNCHES["flash_attention"]
    for r in ranks:
        want = fa.flash_attention_plain(qs[r], k, v, stats=True)[0]
        rec["max_abs_err"] = max(rec["max_abs_err"], agree(
            f"ring rank {r}: 8 hops vs the full attention's rows", got[r], want))
        del want
    acc = ring.attend_shard(qs[0], *shards[0])
    rec["hop_ms"] = cuda_ms(lambda: ring.attend_shard(qs[0], *shards[1], acc), 10)
    rec["ring_ms"] = cuda_ms(lambda: ring_rows(0), 5)
    ring_bound = SP_RANKS * rec["bound_ms"]
    full_bound = bound(4 * B * N * S * S * D, 0)[0]
    log(f"  [ring] hop {rec['hop_ms']:.4f} ms (kernel alone {rec['ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms {rec['bound_by']}, SDPA {rec['library_ms']:.4f} ms); "
        f"eight hops {rec['ring_ms']:.3f} ms (bound {ring_bound:.3f} ms; the whole "
        f"sequence on one card: bound {full_bound:.2f} ms); launches {launches} on {card}")
    del q, k, v, shards, qs, got, acc
    torch.cuda.empty_cache()
    return rec, launches


def ring_backward_rank_local(fa, fab, dev, card):
    """Phase 14 (c): the ring's backward at the 1.3B training point
    (480x832x81, batch 1, 12 heads, sp = 8: [1, 12, 4,095, 128] shards),
    each hop through ring_attention.hop_backward (rows 5-6) against the
    merged stats. Shard 0's dq (its eight hops) and key shard 0's dk / dv
    (summed over the eight ranks whose q visits it) equal the full
    fa_backward's rows. Returns (dq record, dkv record, launches)."""
    from versecrafter_tpu_torch.kernels import ring_attention as ring
    B, N, S = RING_TRAIN_POINT
    n, D = S // SP_RANKS, fa.HEAD_DIM
    recs = check_flash(fa, fab, B, N, n, n, dev, timed=True, seed=9)
    g = torch.Generator(device=dev).manual_seed(16)
    q = (2.0 * torch.randn(B, N, S, D, generator=g, device=dev)).to(torch.bfloat16)
    k, v, do = (torch.randn(B, N, S, D, generator=g, device=dev).to(torch.bfloat16)
                for _ in range(3))
    o, m, l = fa._fa_forward(q, k, v, None, D ** -0.5, (-1, -1), True)
    full = fab.fa_backward(q, k, v, o, m, l, do)

    def part(t, r):
        return t[:, :, r * n:(r + 1) * n].contiguous()

    fa.reset_launch_counts()
    fab.reset_launch_counts()
    dq = dk = dv = 0.0
    for r in range(SP_RANKS):
        for j in range(SP_RANKS):
            if r != 0 and j != 0:
                continue  # only the hops of q shard 0 and of key shard 0
            gq, gk, gv = ring.hop_backward(part(q, r), part(k, j), part(v, j), part(o, r),
                                           part(m[..., None], r)[..., 0],
                                           part(l[..., None], r)[..., 0], part(do, r))
            if r == 0:
                dq = dq + gq.float()
            if j == 0:
                dk, dv = dk + gk.float(), dv + gv.float()
    torch.cuda.synchronize()
    launches = dict(fab.LAUNCHES)
    errs = [agree(f"ring backward shard 0 {what} vs the full fa_backward", got, part(ref, 0))
            for what, got, ref in (("dq", dq, full[0]), ("dk", dk, full[1]),
                                   ("dv", dv, full[2]))]
    recs["fa_backward_dq"]["max_abs_err"] = max(recs["fa_backward_dq"]["max_abs_err"], errs[0])
    recs["fa_backward_dkv"]["max_abs_err"] = max(recs["fa_backward_dkv"]["max_abs_err"],
                                                 *errs[1:])
    log(f"  [ring bwd] per hop dQ {recs['fa_backward_dq']['ms']:.4f} ms (bound "
        f"{recs['fa_backward_dq']['bound_ms']:.4f}), dK/dV {recs['fa_backward_dkv']['ms']:.4f} "
        f"ms (bound {recs['fa_backward_dkv']['bound_ms']:.4f}), SDPA backward "
        f"{recs['fa_backward_dq']['library_ms']:.4f} ms for both; launches {launches} "
        f"on {card}")
    del q, k, v, do, o, m, l, full, dq, dk, dv
    torch.cuda.empty_cache()
    return recs["fa_backward_dq"], recs["fa_backward_dkv"], launches


def collective_bytes():
    """Phase 14 (d): the bytes one rank sends per DiT layer at sp = 8 (bf16
    activations; computed, not timed: one card has no link). Ulysses: four
    all_to_alls (q, k, v in, the output back), each sending 7/8 of the
    rank's [B, N, S/8, 128]; the ring: seven hops of the K and V shards
    forward, and in training backward seven hops of K, V and the fp32 dK,
    dV, plus one hop that sends dK, dV home."""
    out = {}
    for label, (B, N, S) in (("14B 720p CFG-2", ULYSSES_POINT), ("1.3B 480p CFG-2", RING_POINT)):
        local = B * N * (S // SP_RANKS) * 128 * 2
        ulysses = 4 * local * (SP_RANKS - 1) // SP_RANKS
        ring_f = (SP_RANKS - 1) * 2 * local
        ring_b = (SP_RANKS - 1) * (2 * local + 2 * 2 * local) + 2 * 2 * local
        ok_u = N % SP_RANKS == 0
        out[label] = {"ulysses": ulysses if ok_u else None, "ring_forward": ring_f,
                      "ring_backward": ring_b}
        log(f"  [bytes] {label}, sp = {SP_RANKS}, per layer and rank: Ulysses "
            f"{(str(round(ulysses / 1e6, 1)) + ' MB') if ok_u else 'n/a (heads % sp != 0)'}, "
            f"ring forward {ring_f / 1e6:.1f} MB, ring backward {ring_b / 1e6:.1f} MB")
    return out


def parallel_phase(fa, fab, dev, card):
    """Phase 14: the parallel path's rank-local work on one card, (e) first
    (the NCCL world of one, its mesh used by (a)), then (a)-(d); returns the
    four records and their launches."""
    t0 = time.perf_counter()
    log("[parallel] phase 14: one rank's work at the reference's 8-GPU points")
    mesh = nccl_world_of_one(dev)
    try:
        uly, n_uly = ulysses_rank_local(fa, mesh, dev, card)
    finally:
        torch.distributed.destroy_process_group()
        for k_ in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(k_, None)
    hop, n_hop = ring_rank_local(fa, fab, dev, card)
    dq, dkv, n_bwd = ring_backward_rank_local(fa, fab, dev, card)
    collective_bytes()
    if n_uly != 1 or n_hop != 2 * SP_RANKS or n_bwd != {
            "fa_backward_dq": 2 * SP_RANKS - 1, "fa_backward_dkv": 2 * SP_RANKS - 1}:
        raise AssertionError(f"phase 14 launches {n_uly} {n_hop} {n_bwd}")
    log(f"[parallel] {time.perf_counter() - t0:.1f} s")
    records = {"flash_attention_inference_ulysses": uly, "flash_attention_ring_hop": hop,
               "fa_backward_dq_ring": dq, "fa_backward_dkv_ring": dkv}
    launches = {"flash_attention_inference_ulysses": n_uly,
                "flash_attention_ring_hop": n_hop,
                "fa_backward_dq_ring": n_bwd["fa_backward_dq"],
                "fa_backward_dkv_ring": n_bwd["fa_backward_dkv"]}
    return records, launches


# phase 15: the VAE's width over 8 ranks at phase 13's 720x1280x81 point
VAE_SHARDS = 8
VAE_SHARD_IDS = (0, 3, 7)  # both edges and an interior shard
VAE_LATENT_720P = (1, 16, 21, 90, 160)
VAE_EXACT_LATENT_FRAMES = 3  # the fp32 reference's length: 9 frames


class HaloRecorder:
    """A stand-in width shard (parallel/sharding.WidthShard's protocol) for
    a whole decode: halo() pads with zeros, the whole tensor's global edges,
    and keeps, call by call, the columns that shards `ids` of `count` would
    receive from their neighbours; gather() keeps the whole frame. Lives in
    the smoke only: one card cannot run the exchange."""

    def __init__(self, ids, count):
        self.ids, self.count, self.calls = ids, count, []

    def halo(self, x, left, right):
        ws = x.shape[4] // self.count
        cols = {}
        for s in self.ids:
            lo = x[..., s * ws - left:s * ws].clone() if s > 0 else None
            hi = x[..., (s + 1) * ws:(s + 1) * ws + right].clone() if s < self.count - 1 else None
            cols[s] = (lo, hi)
        self.calls.append(("halo", cols))
        return torch.nn.functional.pad(x, (left, right))

    def gather(self, x):
        self.calls.append(("gather", x.clone()))
        return x


class HaloReplay:
    """Shard `index` of `count` whose halo columns and gathered frames are a
    HaloRecorder's, call by call; `sent` counts the bytes the rank would
    send: its edge columns to each neighbour at every halo, its slice to
    each other rank at every gather."""

    def __init__(self, rec, index, count):
        self.calls, self.index, self.count, self.sent = iter(rec.calls), index, count, 0

    def halo(self, x, left, right):
        kind, cols = next(self.calls)
        if kind != "halo":
            raise AssertionError("the shard's decode calls differ from the whole one's")
        lo, hi = cols[self.index]
        col = x[..., :1].numel() * x.element_size()
        self.sent += col * ((right if self.index > 0 else 0)
                            + (left if self.index < self.count - 1 else 0))
        shape = list(x.shape[:4])
        lo = x.new_zeros(shape + [left]) if lo is None else lo
        hi = x.new_zeros(shape + [right]) if hi is None else hi
        return torch.cat([lo, x, hi], dim=4)

    def gather(self, x):
        kind, whole = next(self.calls)
        if kind != "gather":
            raise AssertionError("the shard's decode calls differ from the whole one's")
        self.sent += (self.count - 1) * x.numel() * x.element_size()
        return whole


def vae_width_phase(dev, card):
    """Phase 15 (a): one rank's share of the width-sharded VAE decode at
    720x1280x81 over 8 ranks, shards VAE_SHARD_IDS, against the whole
    decode (module docstring). Returns the per-shard records."""
    from versecrafter_tpu_torch.core.config import VAEConfig
    from versecrafter_tpu_torch.models.vae import init_vae
    from versecrafter_tpu_torch.models.vae_stream import vae_decode_chunked
    cfg = VAEConfig()
    params = init_vae(cfg, torch.Generator(device=dev).manual_seed(15), torch.bfloat16)
    z = torch.randn(VAE_LATENT_720P, generator=torch.Generator(device=dev).manual_seed(16),
                    device=dev).to(torch.bfloat16)
    n = VAE_SHARDS
    ws = z.shape[4] // n
    px = ws * cfg.spatial_compression_ratio

    def run(zz, width=None):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        y = vae_decode_chunked(params, cfg, zz, width=width)
        torch.cuda.synchronize()
        return (y, (time.perf_counter() - t1) * 1e3,
                (torch.cuda.max_memory_allocated() - base) / 2**30)

    whole, whole_ms, whole_gib = run(z)
    log(f"  [vae] whole streaming decode {tuple(z.shape)} -> {tuple(whole.shape)} bf16: "
        f"{whole_ms:.1f} ms, peak +{whole_gib:.2f} GiB on {card}")
    rec = HaloRecorder(VAE_SHARD_IDS, n)
    recorded = run(z, rec)[0]
    log(f"  [vae] the recording pass ({len(rec.calls)} halo / gather calls) equals the "
        f"plain whole decode bit for bit: {torch.equal(recorded, whole)}, max_abs_err "
        f"{(recorded.float() - whole.float()).abs().max().item():.4g}")
    del recorded
    k = VAE_EXACT_LATENT_FRAMES
    exact = vae_decode_chunked(params, cfg, z[:, :, :k].float())
    nf = exact.shape[2]
    out = {}
    for s in VAE_SHARD_IDS:
        replay = HaloReplay(rec, s, n)
        y, ms_, gib = run(z[..., s * ws:(s + 1) * ws].contiguous(), replay)
        sl = slice(s * px, (s + 1) * px)
        ref = whole[..., sl]
        if y.shape != ref.shape or not torch.isfinite(y).all():
            raise AssertionError(f"shard {s}: {tuple(y.shape)} != {tuple(ref.shape)} or "
                                 f"not finite")
        err = (y.float() - ref.float()).abs().max().item()
        mx = ref.float().abs().max().item()
        ex = exact[..., sl]
        emx = ex.abs().max().item()
        err_shard = (y[:, :, :nf].float() - ex).abs().max().item()
        err_whole = (ref[:, :, :nf].float() - ex).abs().max().item()
        # a bf16 decode is within err_whole + 2*2^-8*max of the exact one, so
        # two of them within twice that of each other
        bar = err_whole + BF16_BAR * emx
        ok = err_shard <= bar and err <= 2 * bar
        out[s] = {"ms": ms_, "peak_gib": gib, "sent_bytes": replay.sent,
                  "max_abs_err": err}
        log(f"  [vae] shard {s} of {n} {tuple(y.shape)}: {ms_:.1f} ms ({whole_ms / ms_:.2f}x "
            f"faster than whole), peak +{gib:.2f} GiB ({whole_gib / gib:.2f}x below whole); "
            f"against the whole decode's slice max_abs_err {err:.4g} = {err / mx:.4g} of max "
            f"(bar {2 * bar:.4g}), correlation {correlation(y, ref):.6f}, bit-identical "
            f"{torch.equal(y, ref)}; first {nf} frames against fp32: shard {err_shard:.4g}, "
            f"whole {err_whole:.4g} (bar {bar:.4g}); sends {replay.sent / 1e6:.1f} MB a "
            f"decode {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the width-sharded decode's shard {s} disagrees")
        del y, ref, ex
    del whole, exact, rec, params, z
    gc.collect()
    torch.cuda.empty_cache()
    return {"whole_ms": whole_ms, "whole_peak_gib": whole_gib, "shards": out}


def xla_train_step(fa, fab, dev, card):
    """Phase 15 (b): one --tiny step of the train CLI with --attn_impl xla
    on the card (the reference math: no kernel launched) against the
    default step on the CPU (the kernels' plain versions), from the same
    weights (the CLI's init drawn on the CPU: a CUDA generator draws
    others), data and keys; the losses within 1e-4 * |loss|, fp32 with TF32
    off."""
    import tempfile

    from versecrafter_tpu_torch.cli import train as tcli
    flags = ["--tiny", "--synthetic", "2", "--steps", "1", "--sample_size", "64,64",
             "--video_length", "9"]
    build = tcli.build_model
    cfg, params, _ = build(tcli.parse_args(flags + ["--device", "cpu"]), torch.device("cpu"))
    tcli.build_model = lambda args, dev_: (cfg, tree_to(params, dev_), None)
    with tempfile.TemporaryDirectory() as d:
        fa.reset_launch_counts()
        fab.reset_launch_counts()
        t1 = time.perf_counter()
        got = tcli.run(tcli.parse_args(flags + ["--attn_impl", "xla", "--device", "cuda",
                                                "--output_dir", os.path.join(d, "xla")]))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        launched = {k_: v for k_, v in {**fa.LAUNCHES, **fab.LAUNCHES}.items() if v}
        want = tcli.run(tcli.parse_args(flags + ["--device", "cpu",
                                                 "--output_dir", os.path.join(d, "cpu")]))
    tcli.build_model = build
    loss, ref = got["losses"][0], want["losses"][0]
    ok = math.isfinite(loss) and abs(loss - ref) <= 1e-4 * abs(ref) and not launched
    log(f"  [xla] --tiny --attn_impl xla train step on the card: loss {loss:.7g} in "
        f"{dt:.1f} s (launches {launched or 'none'}); the default step on the CPU "
        f"{ref:.7g}; |difference| {abs(loss - ref):.3g} (bar {1e-4 * abs(ref):.3g}) on "
        f"{card} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the --attn_impl xla train step disagrees or launched a kernel")


def vae_phase(fa, fab, dev, card):
    """Phase 15: the width-sharded VAE's per-rank decode and the xla train
    step."""
    t0 = time.perf_counter()
    log(f"[vae-width] phase 15: one rank's share of the VAE decode over {VAE_SHARDS} width "
        f"shards at 720x1280x81")
    res = vae_width_phase(dev, card)
    xla_train_step(fa, fab, dev, card)
    log(f"[vae-width] {time.perf_counter() - t0:.1f} s")
    return res


# phase 16: one rank's share of tensor parallelism over 8 ranks at the 14B's
# 480x832x81 CFG-2 point
TP_RANKS = 8
TP_ROWS = (2, 21 * 30 * 52)  # CFG-2 batch, 32,760 tokens: 65,520 rows


class TpShardMesh:
    """Shard `index` of a tp group of `count` as parallel/sharding.py sees a
    mesh (shape, coord, size, group); the groups are names only: the
    collectives are AllReduceReplay's."""

    def __init__(self, index, count):
        self.shape = {"dp": 1, "fsdp": 1, "sp": 1, "tp": count}
        self.coord = {"dp": 0, "fsdp": 0, "sp": 0, "tp": index}
        self.size = count

    def group(self, axis):
        return ("replayed", axis)


class AllReduceReplay:
    """torch.distributed.all_reduce for `count` tp shards run one after
    another on one card (smoke only: one card has no tp group). run(fn)
    runs fn(i) for every shard, round after round: call j of a shard takes
    the reduction of the shards' call j once a round has gathered it, so
    round r knows the first r calls' results and gathers the next; the last
    round, which gathers nothing, is every shard's exact work. `calls`
    keeps each call's tensor bytes."""

    def __init__(self, count):
        self.count, self.results, self.calls = count, [], []

    def all_reduce(self, t, op=torch.distributed.ReduceOp.SUM, group=None, async_op=False):
        j = self.call
        self.call += 1
        if j < len(self.results):
            t.copy_(self.results[j])
        elif j == len(self.results):
            if self.acc is None:
                self.acc = t.clone()
                self.calls.append(t.numel() * t.element_size())
            elif op == torch.distributed.ReduceOp.MAX:
                torch.maximum(self.acc, t, out=self.acc)
            else:
                self.acc += t

    def shard(self, fn, i):
        """fn(i) with this replay's collectives, mesh queries and group
        sizes in place of torch.distributed's."""
        dist = torch.distributed
        saved = (dist.all_reduce, dist.get_world_size, dist.get_rank)
        dist.all_reduce = self.all_reduce
        dist.get_world_size = lambda group=None: self.count
        dist.get_rank = lambda group=None: i
        self.call = 0
        try:
            return fn(i)
        finally:
            dist.all_reduce, dist.get_world_size, dist.get_rank = saved

    def run(self, fn):
        while True:
            self.acc = None
            outs = [self.shard(fn, i) for i in range(self.count)]
            if self.acc is None:
                return outs
            self.results.append(self.acc)
            del outs


def ring_sent(call_bytes, n):
    """Bytes one rank sends for ring all-reduces of these sizes over n."""
    return sum(2 * (n - 1) * b // n for b in call_bytes)


def tp_ffn_products(dev, card):
    """Phase 16 (a): the 14B FFN pair at 65,520 rows in W8A8 and W4A8, whole
    and as 8 tp shards (AllReduceReplay): the column shards' outputs
    concatenated, the summed s32 partials and every shard's output against
    the whole, bit for bit; times and peaks."""
    from versecrafter_tpu_torch.core.config import versecrafter_14b
    from versecrafter_tpu_torch.parallel import sharding as shd
    from versecrafter_tpu_torch.utils import quantize as qz
    cfg = versecrafter_14b()
    M, D, F = TP_ROWS[0] * TP_ROWS[1], cfg.dim, cfg.ffn_dim
    g = torch.Generator(device=dev).manual_seed(160)
    x = torch.randn(M, D, generator=g, device=dev).to(torch.bfloat16)
    out = {}
    for label, bits in (("W8A8", 8), ("W4A8", 4)):
        blk = {}
        for name, (k, n) in (("ffn_in", (D, F)), ("ffn_out", (F, D))):
            lim = math.sqrt(6.0 / (k + n))
            blk[name] = {"kernel": ((torch.rand(k, n, generator=g, device=dev) * 2 - 1)
                                    * lim).to(torch.bfloat16)}
        blk = qz.quantize_dit_block(blk, "blocks", 0, cfg.num_layers, bits, True)
        w_in, w_out = blk["ffn_in"]["kernel"], blk["ffn_out"]["kernel"]

        def whole():
            return qz.int8_compute_dot(w_out, torch.nn.functional.gelu(
                qz.int8_compute_dot(w_in, x), approximate="tanh"))

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y_whole = whole()
        torch.cuda.synchronize()
        whole_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
        whole_ms = cuda_ms(whole, 3)
        h_whole = torch.nn.functional.gelu(qz.int8_compute_dot(w_in, x), approximate="tanh")
        a, hq = qz._quantize_rows(h_whole, None)
        y32 = qz._int_mm(hq, qz._product_weight(w_out))
        del a, hq
        shards = [shd.shard_dit_params(blk, TpShardMesh(i, TP_RANKS), ("blocks", 0))
                  for i in range(TP_RANKS)]
        hs = []

        @torch.no_grad()
        def shard_ffn(i):
            mesh = TpShardMesh(i, TP_RANKS)
            with shd.mesh_context(mesh):
                h = torch.nn.functional.gelu(shd.tp_linear(shards[i]["ffn_in"], x, "col"),
                                             approximate="tanh")
                if len(hs) < TP_RANKS:
                    hs.append(h)
                return shd.tp_linear(shards[i]["ffn_out"], h, "row")

        replay = AllReduceReplay(TP_RANKS)
        ys = replay.run(shard_ffn)
        col_equal = torch.equal(torch.cat(hs, dim=1), h_whole)
        hs[:] = [None] * TP_RANKS  # kept no longer (the list stays full)
        del h_whole
        s32_equal = replay.results[-1].dtype == torch.int32 and torch.equal(
            replay.results[-1], y32)
        out_equal = all(torch.equal(y, y_whole) for y in ys)
        del ys, y32
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        replay.shard(shard_ffn, 0)
        torch.cuda.synchronize()
        shard_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
        shard_ms = cuda_ms(lambda: replay.shard(shard_ffn, 0), 3)
        codes = qz.codes(shards[0]["ffn_out"]["kernel"])
        log(f"  [tp] {label} FFN pair [{M}, {D}] -> {F} -> {D} over tp = {TP_RANKS}: "
            f"ffn_in's column shards concatenated equal the whole {col_equal}; ffn_out's "
            f"s32 partials ({tuple(codes.shape)} {codes.dtype} codes a shard) summed "
            f"equal the whole s32 product {s32_equal}; every shard's output equals the "
            f"whole int8_compute_dot {out_equal}; shard {shard_ms:.3f} ms (collectives "
            f"replayed from memory) against whole {whole_ms:.3f} ms; peak +{shard_gib:.2f} "
            f"against +{whole_gib:.2f} GiB; all_reduce calls {replay.calls} B on {card}")
        if not (col_equal and s32_equal and out_equal):
            raise AssertionError(f"the {label} tp products differ from the whole ones")
        out[label] = {"shard_ms": shard_ms, "whole_ms": whole_ms, "shard_peak_gib": shard_gib,
                      "whole_peak_gib": whole_gib}
        del shards, blk, y_whole, w_in, w_out
        gc.collect()
        torch.cuda.empty_cache()
    del x
    return out


def tp_block(fa, dev, card):
    """Phase 16 (b): one Wan2.1-T2V-14B + GeoAdapter block in W8A8 (dynamic
    per-row scales) at 65,520 rows: the whole block (rows 1-2 at 40 heads)
    and tp shard 0 of 8 through the port's mesh path (rows 1-2 at 5 heads
    with the whole rows' q / k statistics, the row products' s32 partials
    summed), its collectives replayed by AllReduceReplay; held to the
    whole block within twice the bf16 noise floor; times, peaks, launches
    and the bytes a rank sends per block."""
    from versecrafter_tpu_torch.core.config import versecrafter_14b
    from versecrafter_tpu_torch.kernels.rope import grid_cos_sin, rope_3d_angles
    from versecrafter_tpu_torch.models import wan_dit as twan
    from versecrafter_tpu_torch.parallel import sharding as shd
    from versecrafter_tpu_torch.utils import quantize as qz
    cfg = versecrafter_14b()
    B, S = TP_ROWS
    g = torch.Generator(device=dev).manual_seed(161)
    blk = twan._init_block(g, cfg, torch.bfloat16, dev)
    blk = qz.quantize_dit_block(blk, "blocks", 0, cfg.num_layers, 8, True)
    x = torch.randn(B, S, cfg.dim, generator=g, device=dev).to(torch.bfloat16)
    ctx = torch.randn(B, cfg.text_len, cfg.dim, generator=g, device=dev).to(torch.bfloat16)
    e0 = torch.randn(B, 6, cfg.dim, generator=g, device=dev) * 0.05
    cos, sin = grid_cos_sin(rope_3d_angles(cfg.head_dim), 21, 30, 52, device=dev)
    rope_i = fa.prepare_fused_rope_tables(cos, sin)

    @torch.no_grad()
    def whole(xx=x):
        return twan.wan_block_forward(blk, cfg, xx, e0, cos, sin, ctx, rope_i)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ref = whole()
    torch.cuda.synchronize()
    whole_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    whole_ms = cuda_ms(whole, 2)
    floor = compare("whole block at x (1 + 2^-8) vs whole block (noise floor)",
                    whole((x.float() * (1 + 2.0 ** -8)).to(x.dtype)), ref)
    shards = [shd.shard_dit_params(blk, TpShardMesh(i, TP_RANKS), ("blocks", 0))
              for i in range(TP_RANKS)]

    @torch.no_grad()
    def shard_block(i):
        with shd.mesh_context(TpShardMesh(i, TP_RANKS)):
            return twan.wan_block_forward(shards[i], cfg, x, e0, cos, sin, ctx, rope_i)

    replay = AllReduceReplay(TP_RANKS)
    ys = replay.run(shard_block)
    same = all(torch.equal(y, ys[0]) for y in ys)
    got = ys[0]
    del ys
    compare(f"tp shard 0 of {TP_RANKS} block vs whole block", got, ref,
            corr_bar=0.999, err_bar=2 * floor)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    replay.shard(shard_block, 0)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    shard_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    shard_ms = cuda_ms(lambda: replay.shard(shard_block, 0), 2)
    want = {**dict.fromkeys(launches, 0), "fused_rope_rms_attention": 1,
            "fused_rms_cross_attention": 1}
    # a bf16 tp path sends each row product's output in bf16, and no row
    # absmax before it
    calls, s32 = replay.calls, B * S * cfg.dim * 4
    bf16_calls = [B * S * cfg.dim * 2 if b == s32 else b for j, b in enumerate(calls)
                  if not (j + 1 < len(calls) and calls[j + 1] == s32)]
    sent, sent_bf16 = ring_sent(replay.calls, TP_RANKS), ring_sent(bf16_calls, TP_RANKS)
    log(f"  [tp] 14B W8A8 block, shard 0 of {TP_RANKS} ({cfg.num_heads // TP_RANKS} heads, "
        f"the rows' statistics and s32 partials replayed): {shard_ms:.1f} ms, peak +{shard_gib:.2f} GiB, against the "
        f"whole block {whole_ms:.1f} ms, peak +{whole_gib:.2f} GiB; shards' outputs "
        f"bit-identical to each other {same}; launches {launches}; all_reduce calls "
        f"{replay.calls} B -> a rank sends {sent / 1e9:.3f} GB a block (ring, computed; "
        f"a bf16 tp path: {sent_bf16 / 1e9:.3f} GB) on {card}")
    if launches != want or not same:
        raise AssertionError(f"the tp block's launches {launches} != {want} or its "
                             f"shards differ")
    del shards, blk, x, ref, got
    gc.collect()
    torch.cuda.empty_cache()
    return {"shard_ms": shard_ms, "whole_ms": whole_ms, "shard_peak_gib": shard_gib,
            "whole_peak_gib": whole_gib, "sent_bytes": sent, "sent_bytes_bf16": sent_bf16,
            "launches": launches}


def tp_phase(fa, dev, card):
    """Phase 16: quantized tensor parallelism over 8 ranks, one rank's share
    (module docstring); returns the records of rows 1-2 at the shard's
    shapes and their launches in the shard's block."""
    t0 = time.perf_counter()
    log(f"[tp] phase 16: one rank's share of the 14B in W8A8 / W4A8 at tp = {TP_RANKS}, "
        f"480x832x81 CFG-2")
    tp_ffn_products(dev, card)
    blk = tp_block(fa, dev, card)
    from versecrafter_tpu_torch.core.config import versecrafter_14b
    B, S = TP_ROWS
    heads = versecrafter_14b().num_heads // TP_RANKS
    records = {"fused_rope_rms_attention_tp8": check_kernel(
        fa, "fused_rope_rms_attention", B, S, S, heads, dev, timed=True),
        "fused_rms_cross_attention_tp8": check_kernel(
        fa, "fused_rms_cross_attention", B, S, 512, heads, dev, timed=True)}
    launches = {k + "_tp8": blk["launches"][k] for k in ("fused_rope_rms_attention",
                                                        "fused_rms_cross_attention")}
    log(f"[tp] {time.perf_counter() - t0:.1f} s")
    return records, launches


def host_cpu():
    """The host's CPU model (the first /proc/cpuinfo model name) and core count."""
    import platform
    name = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith(("model name", "cpu model")):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{name}, {os.cpu_count()} cores"


def saliency_on_host(record, card):
    """Phase 17's saliency segmentation: the record's image read by the port,
    its seeded 480x832 depth (geometry/synthetic.bump_depth), the default
    ImageSegmenter on one fresh host thread (OpenCV's generator state in a
    new thread). Returns (detections as label, score, box, mask SHA-256,
    seconds)."""
    import threading

    from versecrafter_tpu_torch.geometry.synthetic import bump_depth
    from versecrafter_tpu_torch.perception.segmenter import ImageSegmenter
    from versecrafter_tpu_torch.utils.video import read_image

    img = read_image(os.path.join(MEDIA_DIR, record["image"]))
    depth = bump_depth(img.shape[0], img.shape[1], record["depth_seed"])
    out = {}

    def run():
        try:
            t1 = time.perf_counter()
            dets = ImageSegmenter().segment_image(img, record["text_prompt"], depth=depth)
            out["seconds"] = time.perf_counter() - t1
            out["rows"] = [[d.label, d.score, [int(v) for v in d.box],
                            hashlib.sha256(d.mask.tobytes()).hexdigest()] for d in dets]
        except Exception as e:  # noqa: BLE001 — re-raised in the caller
            out["error"] = e
    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    if "error" in out:
        raise out["error"]
    log(f"[media] saliency segmentation of {record['image']} {img.shape} with its seeded depth: "
        f"{out['seconds']:.3f} s on one host thread ({host_cpu()}) of {card}; "
        f"{len(out['rows'])} detections "
        f"{[(r[0], r[2]) for r in out['rows']]}, equal to the JAX package's: "
        f"{out['rows'] == record['detections']}")
    return out["rows"], out["seconds"]


def media_phase(card):
    """Phase 17: the port's host code on the card's host. Each fixture
    (tests/data/media: an OpenCV mp4v clip, three baseline and four
    progressive JPEGs, one of them CMYK, two PNGs) decoded by load_video /
    load_image to the array whose SHA-256 the JAX package's OpenCV reads
    gave (digests.json); the saliency segmenter's detections on the 480x832
    progressive fixture equal to the JAX package's (saliency_on_host); then
    a 480x832x81 clip encoded by save_video and decoded by load_video, each
    timed on one host thread, with the file's size and PSNR."""
    import tempfile

    from versecrafter_tpu_torch.utils import mp4, mpeg4
    from versecrafter_tpu_torch.utils.video import load_image, load_video, save_video

    t0 = time.perf_counter()
    with open(os.path.join(MEDIA_DIR, "digests.json")) as f:
        want = json.load(f)
    record = want.pop("saliency")
    seconds, bad = {}, []
    for name in sorted(want):
        path = os.path.join(MEDIA_DIR, name)
        t1 = time.perf_counter()
        arr = load_video(path) if name.endswith(".mp4") else load_image(path)
        seconds[name] = round(time.perf_counter() - t1, 4)
        if hashlib.sha256(arr.tobytes()).hexdigest() != want[name]:
            bad.append(name)
    log(f"[media] {len(want)} fixtures decoded, digests {'equal' if not bad else 'DIFFER: ' + str(bad)}"
        f" to the JAX package's OpenCV reads; seconds {seconds} on the host of {card}")
    rows, _ = saliency_on_host(record, card)
    if rows != record["detections"]:
        bad.append("saliency")
    h, w, n = RENDER_SIZE
    yy = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    xx = np.linspace(0, 1 + 4 * n / w, w + 4 * n, dtype=np.float32)[None, :, None]
    pan = (np.clip(0.5 + 0.35 * np.sin(2 * np.pi * (1.5 * xx + 0.7 * yy
                                                    + np.float32([0, 0.3, 0.6]))), 0, 1)
           * 255).astype(np.uint8)
    frames = np.stack([pan[:, 4 * i:4 * i + w] for i in range(n)])  # a pan, 4 px a frame
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "clip.mp4")
        t1 = time.perf_counter()
        save_video(frames, path, fps=16)
        enc_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        back = load_video(path)
        dec_s = time.perf_counter() - t1
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            data = f.read()
        t1 = time.perf_counter()
        mpeg4.decode(data, mp4.parse(data))
        raw_s = time.perf_counter() - t1
    err = psnr_db(back[0, :, ::8].transpose(1, 2, 3, 0), frames[::8] / 255.0)
    log(f"[media] {h}x{w}x{n}: save_video {enc_s:.3f} s ({size} bytes), load_video "
        f"{dec_s:.3f} s (the decode alone {raw_s:.3f} s), PSNR {err:.2f} dB (every 8th frame), "
        f"one host thread, "
        f"on the host of {card}; phase 17 {time.perf_counter() - t0:.1f} s")
    if bad or back.shape != (1, 3, n, h, w) or err < WRITER_PSNR_DB:
        raise AssertionError(f"media phase: digests {bad}, shape {back.shape}, PSNR {err}")


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
    with ThreadPoolExecutor(max_workers=4 + len(_build.host_sources())) as pool:
        # beside the builds' own nvccs: ptxas reports and the host codecs
        reports = {src: pool.submit(_build.ptxas_report, src)
                   for src in sorted({src for src, _ in PTXAS_KERNELS.values()})}
        hosts = [pool.submit(_build.build_host, src) for src in _build.host_sources()]
        _build.build_all(_build.kernel_sources())
        reports = {src: r.result() for src, r in reports.items()}
        for r in hosts:
            r.result()
    log(f"[build] {_build.kernel_sources()} and host {_build.host_sources()} built in "
        f"{time.perf_counter() - t0:.1f} s")
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
    # phase 9 rebuilds this pipeline from the same seeds and holds its step
    # to this one
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
    p13 = {}
    counts = flagship_phase(fa, fab, ms, dev, card, records, p13)
    for name in ("fused_rope_rms_attention", "fused_rms_cross_attention"):
        launches_main[name + "_14b"] = counts[name]

    # -- 13. 720p at 14B: the staged request, the staged swap, record -> fit
    t0 = time.perf_counter()
    counts = staged_720p(fa, fab, ms, dev, card, p13.pop("controls"), p13.pop("mask"),
                         p13["render_s"], p13.pop("resident"))
    for name in ("fused_rope_rms_attention", "fused_rms_cross_attention"):
        launches_main[name + "_14b"] += counts[name]
        records[name + "_14b"]["720p_launches"] = counts[name]
    log(f"[720p] phase 13 after phase 7 {time.perf_counter() - t0:.1f} s")

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
    counts, carry = workflow_phase(fa, fab, ms, dev, card)
    for k_, v in counts.items():
        launches_main[k_] = launches_main.get(k_, 0) + v

    # -- 11. the conditioning extras: video=, then the i2v + camera point --
    pipe = carry.pop("pipe")
    first = [c[:, :, :FRAMES_E2E] for c in carry["controls"]]
    for k_, v in masked_init_request(fa, fab, ms, pipe, first,
                                     carry["mask"][:, :, :FRAMES_E2E], card).items():
        launches_main[k_] = launches_main.get(k_, 0) + v

    # -- 12. preprocessing and the whole chain, on the same pipeline ----------
    for k_, v in preprocess_phase(fa, fab, ms, pipe, dev, card).items():
        launches_main[k_] = launches_main.get(k_, 0) + v
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    counts = extras_phase(fa, fab, ms, dev, card, records, **carry)
    del carry
    launches_main["flash_attention_inference"] = counts.pop("flash_attention")
    for k_, v in counts.items():
        launches_main[k_] = launches_main.get(k_, 0) + v

    # -- 14. parallelism: one rank's work, and an NCCL world of one --------
    recs, counts = parallel_phase(fa, fab, dev, card)
    records.update(recs)
    launches_main.update(counts)

    # -- 15. the VAE's width over 8 ranks, one rank's share; --attn_impl xla
    vae_phase(fa, fab, dev, card)

    # -- 16. quantized tensor parallelism over 8 ranks, one rank's share ---
    recs, counts = tp_phase(fa, dev, card)
    records.update(recs)
    launches_main.update(counts)

    # -- 17. the media codecs on the card's host ---------------------------
    media_phase(card)

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
               if k_.startswith(("cross_", "cross257_", "720p_"))
               or k_ in ("inference_ms", "inference_plain_ms", "library_note",
                         "library_gemm_ms", "hop_ms", "ring_ms")}})
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
