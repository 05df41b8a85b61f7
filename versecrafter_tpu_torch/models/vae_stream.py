"""Streaming (temporally chunked) Wan VAE encode and decode with exact conv
caches.

Every temporal op of the VAE is causal, so a video can go through it in
chunks of [1, 4, 4, ...] input frames (the 4x temporal compression), each
temporal conv carrying a cache of its trailing input frames. The result
equals the full-sequence path of models/vae.py up to the convolutions'
summation order, and the working set is a few frames instead of the whole
clip: under torch.no_grad() nothing of a finished chunk stays alive but its
cache and its output.

Cache rules (from the causal pad-2 / stride geometry):
- a stride-1 k3 conv keeps the last 2 input frames (zeros before the start);
- the stride-2 k3 temporal downsample keeps the last 1 input frame: steady
  chunks start at odd global offsets, so that is the phase the full
  sequence has; the first chunk takes the plain causal pad;
- the temporal upsample drops the duplicated first output frame of the
  first chunk.
Caches are a plain dict tree of tensors.

Under a width shard (models/vae.py, parallel/sharding.shard_vae_io) each
chunk exchanges the halo of its new frames only: a conv's cache keeps its
trailing input frames with their halo columns, local to the shard.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import torch
import torch.nn.functional as F

from versecrafter_tpu_torch.core.config import VAEConfig
from versecrafter_tpu_torch.models.vae import (
    WAN21_LATENT_MEAN, WAN21_LATENT_STD, _attn_block, _stat, causal_conv3d,
    channel_rms_norm, conv, conv2d_spatial, pad_w, up_spatial)

Params = Dict[str, Any]
Cache = Dict[str, Any]


def _cconv_stream(x, p, cache, stride_t: int = 1, width=None):
    """Cached causal conv3d; cache None is the first chunk (zero pad).
    Returns (y, the cache for the next chunk)."""
    kernel, bias = p["kernel"], p["bias"]
    kt, kh, kw = kernel.shape[2:]
    if kt == 1:
        return causal_conv3d(x, kernel, bias, (stride_t, 1, 1), width), None
    keep = 2 if stride_t == 1 else 1
    pw = kw // 2
    if width is not None:  # the new frames' halo; the cache holds its own
        x, pw = pad_w(x, pw, pw, width), 0
    xx = x if cache is None else torch.cat([cache.to(x.dtype), x], dim=2)
    xp = F.pad(xx, (pw, pw, kh // 2, kh // 2, 2 * (kt // 2) if cache is None else 0, 0))
    y = conv(F.conv3d, xp, kernel, bias, stride=(stride_t, 1, 1))
    # a copy, so the cache does not keep the whole chunk's storage alive
    new_cache = xx[:, :, -keep:].clone()
    if cache is None and new_cache.shape[2] < keep:
        new_cache = F.pad(new_cache, (0, 0, 0, 0, keep - new_cache.shape[2], 0))
    return y, new_cache


def _res_stream(p, x, cache: Optional[Cache], width=None):
    c = cache or {}
    h = channel_rms_norm(x, p["norm1"]["gamma"])
    h, c1 = _cconv_stream(F.silu(h), p["conv1"], c.get("conv1"), width=width)
    h = channel_rms_norm(h, p["norm2"]["gamma"])
    h, c2 = _cconv_stream(F.silu(h), p["conv2"], c.get("conv2"), width=width)
    if "shortcut" in p:
        x = causal_conv3d(x, p["shortcut"]["kernel"], p["shortcut"]["bias"])
    return x + h, {"conv1": c1, "conv2": c2}


def _down_stream(p, x, cache: Optional[Cache], temporal: bool, width=None):
    c = cache or {}
    x = conv2d_spatial(x, p["conv"]["kernel"], p["conv"]["bias"], stride=2,
                       asym_pad=True, width=width)
    out_cache: Cache = {}
    if temporal:
        x, out_cache["time_conv"] = _cconv_stream(x, p["time_conv"], c.get("time_conv"),
                                                  stride_t=2)
    return x, out_cache


def _up_stream(p, x, cache: Optional[Cache], temporal: bool, first: bool, width=None):
    c = cache or {}
    out_cache: Cache = {}
    if temporal:
        b, ch, t, h, w = x.shape
        y, out_cache["time_conv"] = _cconv_stream(x, p["time_conv"], c.get("time_conv"))
        x = y.reshape(b, 2, ch, t, h, w).permute(0, 2, 3, 1, 4, 5).reshape(b, ch, 2 * t, h, w)
        if first:
            x = x[:, :, 1:]  # drop the duplicated first frame
    return up_spatial(p, x, width), out_cache


def _encode_chunk(params: Params, cfg: VAEConfig, x, caches: Optional[Cache], width=None):
    """One chunk through the encoder -> (latent frames, the next caches)."""
    p = params["encoder"]
    cc = caches or {}
    new: Cache = {}
    h, new["conv_in"] = _cconv_stream(x, p["conv_in"], cc.get("conv_in"), width=width)
    for i, st in enumerate(p["stages"]):
        sc = cc.get(f"s{i}", {})
        nsc: Cache = {}
        for j, rp in enumerate(st["res"]):
            h, nsc[f"res{j}"] = _res_stream(rp, h, sc.get(f"res{j}"), width)
        if "down" in st:
            h, nsc["down"] = _down_stream(st["down"], h, sc.get("down"),
                                          temporal="time_conv" in st["down"], width=width)
        new[f"s{i}"] = nsc
    h, new["mid1"] = _res_stream(p["mid"]["res1"], h, cc.get("mid1"), width)
    h = _attn_block(p["mid"]["attn"], h, width)
    h, new["mid2"] = _res_stream(p["mid"]["res2"], h, cc.get("mid2"), width)
    h = channel_rms_norm(h, p["norm_out"]["gamma"])
    h, new["conv_out"] = _cconv_stream(F.silu(h), p["conv_out"], cc.get("conv_out"),
                                       width=width)
    h = causal_conv3d(h, p["quant_conv"]["kernel"], p["quant_conv"]["bias"])
    mean = h[:, : h.shape[1] // 2]
    if cfg.use_latent_stats:
        mean = (mean - _stat(WAN21_LATENT_MEAN, mean)) / _stat(WAN21_LATENT_STD, mean)
    return mean, new


def _decode_chunk(params: Params, cfg: VAEConfig, z, caches: Optional[Cache],
                  first: bool, width=None):
    """One latent chunk through the decoder -> (frames, the next caches)."""
    p = params["decoder"]
    cc = caches or {}
    new: Cache = {}
    if cfg.use_latent_stats:
        z = z * _stat(WAN21_LATENT_STD, z) + _stat(WAN21_LATENT_MEAN, z)
    h = causal_conv3d(z, p["post_quant_conv"]["kernel"], p["post_quant_conv"]["bias"])
    h, new["conv_in"] = _cconv_stream(h, p["conv_in"], cc.get("conv_in"), width=width)
    h, new["mid1"] = _res_stream(p["mid"]["res1"], h, cc.get("mid1"), width)
    h = _attn_block(p["mid"]["attn"], h, width)
    h, new["mid2"] = _res_stream(p["mid"]["res2"], h, cc.get("mid2"), width)
    t_up = cfg.temporal_downsample[::-1]
    for i, st in enumerate(p["stages"]):
        sc = cc.get(f"s{i}", {})
        nsc: Cache = {}
        for j, rp in enumerate(st["res"]):
            h, nsc[f"res{j}"] = _res_stream(rp, h, sc.get(f"res{j}"), width)
        if "up" in st:
            temporal = (i < len(t_up) and t_up[i]) and "time_conv" in st["up"]
            h, nsc["up"] = _up_stream(st["up"], h, sc.get("up"), temporal=temporal,
                                      first=first, width=width)
        new[f"s{i}"] = nsc
    h = channel_rms_norm(h, p["norm_out"]["gamma"])
    h, new["conv_out"] = _cconv_stream(F.silu(h), p["conv_out"], cc.get("conv_out"),
                                       width=width)
    return h, new


@torch.no_grad()
def vae_encode_chunked(params: Params, cfg: VAEConfig, x: torch.Tensor,
                       frame_chunk: int = 4, width=None) -> torch.Tensor:
    """Streaming encode: [B, 3, T, H, W] (T = 1 + 4k) -> latents, in chunks
    of [1, frame_chunk, frame_chunk, ...] frames; width as in
    models/vae.vae_encode."""
    if frame_chunk % cfg.temporal_compression_ratio:
        raise ValueError(f"frame_chunk {frame_chunk} is not a multiple of the temporal "
                         f"ratio {cfg.temporal_compression_ratio}")
    z, caches = _encode_chunk(params, cfg, x[:, :, :1], None, width)
    outs = [z]
    for s in range(1, x.shape[2], frame_chunk):
        z, caches = _encode_chunk(params, cfg, x[:, :, s:s + frame_chunk], caches, width)
        outs.append(z)
    return torch.cat(outs, dim=2)


@torch.no_grad()
def vae_decode_stream(params: Params, cfg: VAEConfig, z: torch.Tensor,
                      latent_chunk: int = 1, width=None) -> Iterator[torch.Tensor]:
    """Yield the decoded frames chunk by chunk, in temporal order: 1 frame
    for the first latent frame, then 4 per latent frame (the caller can move
    chunk N to the host while chunk N+1 decodes); width as in
    models/vae.vae_decode."""
    y, caches = _decode_chunk(params, cfg, z[:, :, :1], None, True, width)
    yield y
    for s in range(1, z.shape[2], latent_chunk):
        y, caches = _decode_chunk(params, cfg, z[:, :, s:s + latent_chunk], caches, False,
                                  width)
        yield y


def vae_decode_chunked(params: Params, cfg: VAEConfig, z: torch.Tensor,
                       latent_chunk: int = 1, width=None) -> torch.Tensor:
    """Streaming decode: latents [B, z, T', h, w] -> video [B, 3, 4(T'-1)+1, H, W]."""
    return torch.cat(list(vae_decode_stream(params, cfg, z, latent_chunk, width)), dim=2)
