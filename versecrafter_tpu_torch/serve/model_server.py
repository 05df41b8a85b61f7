"""Serving subset: the random-init pipeline factory, the request-to-pipeline
mapping and the per-request toggles (int8 attention, TeaCache, cfg-skip) of
a request whose control videos are already loaded. The HTTP tier and mp4
request loading wait for a later slice (they need cv2, which a GPU
deployment may lack)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from versecrafter_tpu_torch import resolve_device
from versecrafter_tpu_torch.core.config import (
    T5Config, VAEConfig, WAN21_1_3B, WanDiTConfig, versecrafter_14b)


def pipeline_configs(scale: str):
    """(dit_cfg, vae_cfg, t5_cfg) of a factory scale: '14b' is
    Wan2.1-T2V-14B + GeoAdapter (40 layers, dim 5120, 40 heads, the
    GeoAdapter every 2nd layer with 128 control channels), '1.3b'
    Wan2.1-1.3B + GeoAdapter (15 blocks), both with the full umT5-xxl and
    the Wan VAE; 'tiny' the wiring-smoke widths (head_dim 16, so it runs on
    the CPU only, where attention takes the kernel's plain version)."""
    if scale == "14b":
        return versecrafter_14b(), VAEConfig(), T5Config()
    if scale == "1.3b":
        t5_cfg = T5Config()
        return (dataclasses.replace(WAN21_1_3B, geoada_layers=(), geoada_in_dim=128,
                                    text_dim=t5_cfg.dim), VAEConfig(), t5_cfg)
    if scale == "tiny":
        t5_cfg = T5Config(num_layers=2, dim=512, dim_attn=512, dim_ffn=1024,
                          num_heads=8, vocab=1024)
        return (WanDiTConfig(dim=128, ffn_dim=256, num_heads=8, num_layers=4,
                             geoada_layers=(), geoada_in_dim=128, text_dim=t5_cfg.dim),
                VAEConfig(), t5_cfg)
    raise ValueError(f"unknown scale {scale!r}")


def default_pipeline_factory(model_path: Optional[str] = None,
                             dtype_name: str = "bfloat16",
                             scale: str = "1.3b", device=None, seed: int = 0):
    """Build the pipeline of `scale` (pipeline_configs) from random weights
    made from `seed` on the device: the DiT from seed, the VAE (fp32) from
    seed + 1, umT5 from seed + 2. Checkpoint loading (model_path) is not
    ported yet."""
    if model_path:
        raise NotImplementedError("checkpoint loading is not ported yet")
    cfg, vae_cfg, t5_cfg = pipeline_configs(scale)

    def factory():
        from versecrafter_tpu_torch.models.t5 import init_t5
        from versecrafter_tpu_torch.models.vae import init_vae
        from versecrafter_tpu_torch.models.wan_dit import init_wan_dit
        from versecrafter_tpu_torch.sampling.pipeline import VerseCrafterPipeline

        dev = resolve_device(device)
        dtype = getattr(torch, dtype_name)

        def gen(offset):
            return torch.Generator(device=dev).manual_seed(seed + offset)

        return VerseCrafterPipeline(
            dit_params=init_wan_dit(cfg, gen(0), dtype),
            dit_cfg=cfg,
            vae_params=init_vae(vae_cfg, gen(1), torch.float32),
            vae_cfg=vae_cfg,
            t5_params=init_t5(t5_cfg, gen(2), dtype),
            t5_cfg=t5_cfg,
            device=dev,
        )
    return factory


def _call_pipe(pipe, params, controls, mask, h, w, n, progress):
    """One generate request's parameters -> a pipeline call (uint8 frames,
    quantized on the device)."""
    return pipe(
        params.get("prompt", ""),
        negative_prompt=params.get("negative_prompt", ""),
        control_videos=controls,
        mask_video=mask,
        height=h, width=w, num_frames=n,
        num_inference_steps=int(params.get("num_inference_steps", 30)),
        guidance_scale=float(params.get("guidance_scale", 5.0)),
        shift=float(params.get("shift", 16.0)),
        seed=int(params.get("seed", 2025)),
        progress=progress,
        output_type="uint8",
    )


def run_loaded_request(pipe, params: dict, controls, mask, progress=None):
    """One generate request whose control videos and mask are loaded: the
    per-request toggles of the JAX server's run_generate_request, then the
    pipeline call (uint8 frames [B, T, H, W, 3]). `int8_attention` sets
    int8 QK^T scoring, `teacache_threshold` (with `teacache_skip_start`,
    default 5, and `teacache_coefficients`, default the pipeline's) TeaCache
    and `cfg_skip_ratio` cfg-skip for this request; the previous settings
    are restored afterwards, also when the request raises. Quantization
    params (as the JAX server reads them) raise NotImplementedError."""
    from versecrafter_tpu_torch.models import wan_dit

    h = int(params.get("height", 480))
    w = int(params.get("width", 832))
    n = int(params.get("num_frames", 81))
    saved = (pipe.teacache_threshold, pipe.teacache_skip_start,
             pipe.teacache_coefficients, pipe.cfg_skip_ratio)
    saved_int8_attn = wan_dit.INT8_QK_SCORE
    try:
        if "int8_attention" in params:
            pipe.enable_int8_attention(bool(params["int8_attention"]))
        if "teacache_threshold" in params:
            pipe.enable_teacache(float(params["teacache_threshold"]),
                                 int(params.get("teacache_skip_start", 5)),
                                 coefficients=params.get("teacache_coefficients",
                                                         pipe.teacache_coefficients))
        if "cfg_skip_ratio" in params:
            pipe.enable_cfg_skip(float(params["cfg_skip_ratio"]))
        if params.get("quantize_int8") or params.get("int8_compute") or "quantize_bits" in params:
            raise NotImplementedError(
                "request param 'quantization' is not ported to versecrafter_tpu_torch yet")
        return _call_pipe(pipe, params, controls, mask, h, w, n, progress)
    finally:
        (pipe.teacache_threshold, pipe.teacache_skip_start,
         pipe.teacache_coefficients, pipe.cfg_skip_ratio) = saved
        wan_dit.INT8_QK_SCORE = saved_int8_attn
