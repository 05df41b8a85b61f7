"""Serving subset: the random-init pipeline factory, the request-to-pipeline
mapping and the per-request toggles of a request whose control videos are
already loaded. The HTTP tier and mp4 request loading wait for a later
slice (they need cv2, which a GPU deployment may lack)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from versecrafter_tpu_torch import resolve_device
from versecrafter_tpu_torch.core.config import (
    T5Config, VAEConfig, WAN21_1_3B, WanDiTConfig)


def default_pipeline_factory(model_path: Optional[str] = None,
                             dtype_name: str = "bfloat16",
                             scale: str = "1.3b", device=None, seed: int = 0):
    """Build the flagship pipeline from random weights made from `seed`.

    scale '1.3b': Wan2.1-1.3B + GeoAdapter (15 blocks, 128 control
    channels) at full width with the full umT5-xxl and Wan VAE; 'tiny': the
    wiring-smoke widths (head_dim 16, so it runs on the CPU only, where
    attention takes the kernel's plain version). Checkpoint loading
    (model_path) is not ported yet."""
    if model_path:
        raise NotImplementedError("checkpoint loading is not ported yet")
    if scale not in ("1.3b", "tiny"):
        raise ValueError(f"unknown scale {scale!r}")

    def factory():
        from versecrafter_tpu_torch.models.t5 import init_t5
        from versecrafter_tpu_torch.models.vae import init_vae
        from versecrafter_tpu_torch.models.wan_dit import init_wan_dit
        from versecrafter_tpu_torch.sampling.pipeline import VerseCrafterPipeline

        dev = resolve_device(device)
        dtype = getattr(torch, dtype_name)
        if scale == "tiny":
            t5_cfg = T5Config(num_layers=2, dim=512, dim_attn=512, dim_ffn=1024,
                              num_heads=8, vocab=1024)
            cfg = WanDiTConfig(dim=128, ffn_dim=256, num_heads=8, num_layers=4,
                               geoada_layers=(), geoada_in_dim=128,
                               text_dim=t5_cfg.dim)
        else:
            t5_cfg = T5Config()
            cfg = dataclasses.replace(WAN21_1_3B, geoada_layers=(),
                                      geoada_in_dim=128, text_dim=t5_cfg.dim)

        def gen(offset):
            return torch.Generator(device=dev).manual_seed(seed + offset)

        return VerseCrafterPipeline(
            dit_params=init_wan_dit(cfg, gen(0), dtype),
            dit_cfg=cfg,
            vae_params=init_vae(VAEConfig(), gen(1), torch.float32),
            vae_cfg=VAEConfig(),
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


def _unported_request_feature(params: dict) -> Optional[str]:
    """The first request toggle whose feature is not ported yet, if any:
    TeaCache, cfg-skip, or weight quantization (asked for as the JAX server
    reads it)."""
    for name in ("teacache_threshold", "cfg_skip_ratio"):
        if name in params:
            return name
    if params.get("quantize_int8") or params.get("int8_compute") or "quantize_bits" in params:
        return "quantization"
    return None


def run_loaded_request(pipe, params: dict, controls, mask, progress=None):
    """One generate request whose control videos and mask are loaded: the
    per-request toggles of the JAX server's run_generate_request, then the
    pipeline call (uint8 frames [B, T, H, W, 3]). `int8_attention` sets
    int8 QK^T scoring for this request; the previous setting is restored
    afterwards, also when the request raises. TeaCache, cfg-skip and
    quantization params raise NotImplementedError."""
    from versecrafter_tpu_torch.models import wan_dit

    h = int(params.get("height", 480))
    w = int(params.get("width", 832))
    n = int(params.get("num_frames", 81))
    saved_int8_attn = wan_dit.INT8_QK_SCORE
    try:
        if "int8_attention" in params:
            pipe.enable_int8_attention(bool(params["int8_attention"]))
        unported = _unported_request_feature(params)
        if unported:
            raise NotImplementedError(
                f"request param {unported!r} is not ported to versecrafter_tpu_torch yet")
        return _call_pipe(pipe, params, controls, mask, h, w, n, progress)
    finally:
        wan_dit.INT8_QK_SCORE = saved_int8_attn
