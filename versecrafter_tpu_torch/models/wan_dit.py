"""Wan video DiT backbone + GeoAdapter control branch.

Parameters are nested dicts of tensors in the JAX package's layout: linear
kernels are [in, out], norm scales and modulation tables fp32, and each
block is one dict in the list ``params["blocks"]`` (and
``params["geoada_blocks"]``). Self- and cross-attention go through the
fused functions of kernels/flash_attention.py (the CUDA kernels on the card,
their plain versions on the CPU): the fused inference kernel, or, when an
input needs a gradient, the unfused math over the differentiable flash
attention. Two opt-in module flags, read at call time, change that path:
INT8_QK_SCORE and PROJ_STAT_FUSION (below). GeoAdapter hints are computed
interleaved: geoada block i runs right before base block stride*i, and its
hint after_proj(c)*scale is added right after that base block. Training calls wan_dit_embed, wan_dit_blocks
(remat=True) and wan_dit_head directly; wan_dit_forward is inference only.

A linear kernel may be a quantized leaf (utils/quantize.py): a
compute-tagged one runs the W8A8 product, a storage-only one is dequantized
to the activations' dtype first. calibrate=True records each block's
per-tensor activation absmax at every W8A8 site (the stats fit_act_scales
takes). A LoRA (utils/lora.py) enters wan_dit_blocks as per-block factors
whose effective kernels are formed inside each (rematerialised) block.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from versecrafter_tpu_torch.core.config import WanDiTConfig
from versecrafter_tpu_torch.kernels.flash_attention import (
    fused_rms_cross_attention, fused_rope_rms_attention,
    prepare_fused_rope_tables)
from versecrafter_tpu_torch.kernels.matmul_stat import linear_rstat
from versecrafter_tpu_torch.kernels.norms import layer_norm
from versecrafter_tpu_torch.utils import quantize as qz
from versecrafter_tpu_torch.utils.lora import block_factors, lora_block

Params = Dict[str, Any]

# Score self-attention's QK^T on per-(row, head) int8 codes of q~/k~ inside
# the fused kernel (PV stays bf16): an opt-in inference approximation, set
# through VerseCrafterPipeline.enable_int8_attention() or a generate
# request's `int8_attention`. Read at call time; a no-op under grad.
INT8_QK_SCORE = False

# Compute the qk-RMSNorm row statistics in the q/k projections' matmul
# epilogue (kernels/matmul_stat.linear_rstat) instead of reducing over the
# projection outputs again. Opt-in; read at call time. Applies to plain
# tensor kernels only.
PROJ_STAT_FUSION = False


# Run the block FFN over row chunks of an eighth of this above it (rows are
# independent through linear -> gelu -> linear: the same result up to the
# GEMMs' summation order), so the [rows, ffn_dim] hidden never exists whole. 65,520 rows (480x832x81
# at CFG-2) is the largest shape whose unchunked 14B step was measured on
# the card (PERF.md).
FFN_CHUNK_ROWS = 65_520


def _linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    k = p["kernel"]
    if not isinstance(k, dict):
        y = torch.matmul(x, k.to(x.dtype))
    elif qz.is_compute_tagged(k):
        y = qz.int8_compute_dot(k, x)
    else:  # storage-only: weight-only dequant to the activations' dtype
        y = torch.matmul(x, qz.dequantize_leaf(k, x.dtype))
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _ffn(p: Params, x: torch.Tensor) -> torch.Tensor:
    return _linear(p["ffn_out"], _gelu_tanh(_linear(p["ffn_in"], x)))


def _ffn_chunked(p: Params, x: torch.Tensor) -> torch.Tensor:
    """_ffn over row chunks written into one output (differentiable)."""
    b, s, d = x.shape
    rows = b * s
    n = -(-rows // max(1, FFN_CHUNK_ROWS // 8))
    ch = -(-rows // n)
    x2 = x.reshape(rows, d)
    out = x2.new_empty((rows, d))
    for i in range(0, rows, ch):
        out[i:i + ch] = _ffn(p, x2[i:i + ch])
    return out.reshape(b, s, d)


def _amax(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor activation absmax (fp32 scalar): the calibration
    statistic behind static W8A8 scales."""
    return x.float().abs().amax()


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """[cos | sin] sinusoid table, fp32."""
    half = dim // 2
    pos = position.float()
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32,
                                             device=pos.device) / half)
    ang = torch.outer(pos, freqs)
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def patchify(x: torch.Tensor, patch_size: Tuple[int, int, int]) -> torch.Tensor:
    """[B, C, F, H, W] -> [B, S, C*pt*ph*pw], patch channels ordered
    (c, pt, ph, pw)."""
    b, c, f, h, w = x.shape
    pt, ph, pw = patch_size
    x = x.reshape(b, c, f // pt, pt, h // ph, ph, w // pw, pw)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, (f // pt) * (h // ph) * (w // pw), c * pt * ph * pw)


def unpatchify(x: torch.Tensor, grid, patch_size, out_dim: int) -> torch.Tensor:
    """[B, S, out_dim*prod(patch)] -> [B, C_out, F, H, W]."""
    b = x.shape[0]
    f, h, w = grid
    pt, ph, pw = patch_size
    x = x.reshape(b, f, h, w, pt, ph, pw, out_dim)
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, out_dim, f * pt, h * ph, w * pw)


# ---------------------------------------------------------------------------
# init (same tree, shapes and dtypes as the JAX package's init_wan_dit)
# ---------------------------------------------------------------------------

def _init_linear(gen, d_in, d_out, dtype, device, init="xavier", zero=False,
                 bias=True):
    kernel = torch.empty((d_in, d_out), dtype=dtype, device=device)
    if zero:
        kernel.zero_()
    elif init == "normal02":
        kernel.normal_(0.0, 0.02, generator=gen)
    else:
        lim = math.sqrt(6.0 / (d_in + d_out))
        kernel.uniform_(-lim, lim, generator=gen)
    p = {"kernel": kernel}
    if bias:
        p["bias"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def _ones(n, device):
    return torch.ones((n,), dtype=torch.float32, device=device)


def _init_attn(gen, dim, dtype, device, qk_norm=True):
    p = {name: _init_linear(gen, dim, dim, dtype, device) for name in "qkvo"}
    if qk_norm:
        p["norm_q"] = {"scale": _ones(dim, device)}
        p["norm_k"] = {"scale": _ones(dim, device)}
    return p


def _init_block(gen, cfg: WanDiTConfig, dtype, device, geoada=False):
    mod = torch.empty((6, cfg.dim), dtype=torch.float32, device=device)
    p = {
        "self_attn": _init_attn(gen, cfg.dim, dtype, device, cfg.qk_norm),
        "cross_attn": _init_attn(gen, cfg.dim, dtype, device, cfg.qk_norm),
        "ffn_in": _init_linear(gen, cfg.dim, cfg.ffn_dim, dtype, device),
        "ffn_out": _init_linear(gen, cfg.ffn_dim, cfg.dim, dtype, device),
        "modulation": mod.normal_(generator=gen) / math.sqrt(cfg.dim),
    }
    if cfg.cross_attn_norm:
        p["norm3"] = {"scale": _ones(cfg.dim, device),
                      "bias": torch.zeros((cfg.dim,), dtype=torch.float32,
                                          device=device)}
    if geoada:
        p["after_proj"] = _init_linear(gen, cfg.dim, cfg.dim, dtype, device, zero=True)
    return p


def check_supported(cfg: WanDiTConfig):
    """Raise for the config branches the port does not have yet."""
    if cfg.model_type == "i2v" or cfg.add_img_emb:
        raise NotImplementedError("the i2v img_emb branch is not ported yet")
    if cfg.add_control_adapter:
        raise NotImplementedError("simple_adapter is not ported yet")


def init_wan_dit(cfg: WanDiTConfig, generator: torch.Generator,
                 dtype=torch.bfloat16) -> Params:
    """Random init from `generator`, on the generator's device; the head
    projection is zero, as in the reference."""
    check_supported(cfg)
    device = generator.device
    pt, ph, pw = cfg.patch_size
    g = generator
    head_mod = torch.empty((2, cfg.dim), dtype=torch.float32, device=device)
    params: Params = {
        "patch_embedding": _init_linear(g, cfg.in_dim * pt * ph * pw, cfg.dim,
                                        dtype, device),
        "text_embedding": {
            "fc1": _init_linear(g, cfg.text_dim, cfg.dim, dtype, device, "normal02"),
            "fc2": _init_linear(g, cfg.dim, cfg.dim, dtype, device, "normal02"),
        },
        "time_embedding": {
            "fc1": _init_linear(g, cfg.freq_dim, cfg.dim, torch.float32, device,
                                "normal02"),
            "fc2": _init_linear(g, cfg.dim, cfg.dim, torch.float32, device,
                                "normal02"),
        },
        "time_projection": _init_linear(g, cfg.dim, cfg.dim * 6, torch.float32,
                                        device),
        "head": {
            "head": _init_linear(g, cfg.dim, math.prod(cfg.patch_size) * cfg.out_dim,
                                 dtype, device, zero=True),
            "modulation": head_mod.normal_(generator=g) / math.sqrt(cfg.dim),
        },
        "blocks": [_init_block(g, cfg, dtype, device)
                   for _ in range(cfg.num_layers)],
    }
    if cfg.has_geoadapter:
        params["geoada_blocks"] = [
            _init_block(g, cfg, dtype, device, geoada=True)
            for _ in cfg.resolved_geoada_layers]
        params["geoada_before_proj"] = _init_linear(g, cfg.dim, cfg.dim, dtype,
                                                    device, zero=True)
        params["geoada_patch_embedding"] = _init_linear(
            g, cfg.resolved_geoada_in_dim * pt * ph * pw, cfg.dim, dtype, device)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _plain_kernel(p: Params) -> bool:
    return isinstance(p["kernel"], torch.Tensor)


def _self_attention(p: Params, x, cos, sin, rope_i, cfg: WanDiTConfig, calib=None):
    if calib is not None:
        calib["self_attn/q/kernel"] = calib["self_attn/k/kernel"] = \
            calib["self_attn/v/kernel"] = _amax(x)
    rstats = None
    if (cfg.qk_norm and PROJ_STAT_FUSION and _plain_kernel(p["q"])
            and _plain_kernel(p["k"])):
        # the q/k projections emit their row statistics in the epilogue
        q, rq = linear_rstat(p["q"], x, cfg.eps)
        k, rk = linear_rstat(p["k"], x, cfg.eps)
        rstats = (rq, rk)
    else:
        q = _linear(p["q"], x)
        k = _linear(p["k"], x)
    v = _linear(p["v"], x)
    out = fused_rope_rms_attention(
        q, k, v, cos, sin,
        p["norm_q"]["scale"] if cfg.qk_norm else None,
        p["norm_k"]["scale"] if cfg.qk_norm else None,
        num_heads=cfg.num_heads, eps=cfg.eps, window_size=cfg.window_size,
        tables_i=rope_i, rstats=rstats, int8_score=INT8_QK_SCORE)
    if calib is not None:
        calib["self_attn/o/kernel"] = _amax(out)
    return _linear(p["o"], out)


def _cross_attention(p: Params, x, context, cfg: WanDiTConfig, calib=None):
    if calib is not None:
        calib["cross_attn/q/kernel"] = _amax(x)
        calib["cross_attn/k/kernel"] = calib["cross_attn/v/kernel"] = _amax(context)
    rq = None
    if cfg.qk_norm and PROJ_STAT_FUSION and _plain_kernel(p["q"]):
        # the q statistic comes from the projection; the k statistic spans
        # only the context tokens
        q, rq = linear_rstat(p["q"], x, cfg.eps)
    else:
        q = _linear(p["q"], x)
    k = _linear(p["k"], context)
    v = _linear(p["v"], context)
    out = fused_rms_cross_attention(
        q, k, v,
        p["norm_q"]["scale"] if cfg.qk_norm else None,
        p["norm_k"]["scale"] if cfg.qk_norm else None,
        num_heads=cfg.num_heads, eps=cfg.eps, rq=rq)
    if calib is not None:
        calib["cross_attn/o/kernel"] = _amax(out)
    return _linear(p["o"], out)


def wan_block_forward(p: Params, cfg: WanDiTConfig, x, e0, cos, sin, context,
                      rope_i=None, calib=None, lora=None):
    """One Wan attention block. x [B, S, D]; e0 [B, 6, D] fp32 modulation;
    cos/sin the half-width RoPE tables (the differentiable attention path
    uses them) and rope_i the interleaved tables from
    prepare_fused_rope_tables (the fused inference kernel uses them).
    calib: a dict that receives the absmax at each W8A8 site (keys as in
    utils/quantize.COMPUTE_SITES). lora: (this block's factors, scale), whose
    effective kernels are formed here, inside any rematerialisation."""
    if lora is not None:
        p = lora_block(p, *lora)
    dtype = x.dtype
    e = p["modulation"][None].float() + e0
    tmp = layer_norm(x, eps=cfg.eps).float()
    tmp = (tmp * (1.0 + e[:, 1][:, None]) + e[:, 0][:, None]).to(dtype)
    y = _self_attention(p["self_attn"], tmp, cos, sin, rope_i, cfg, calib)
    x = (x.float() + y.float() * e[:, 2][:, None]).to(dtype)

    xn = (layer_norm(x, p["norm3"]["scale"], p["norm3"]["bias"], eps=cfg.eps)
          if cfg.cross_attn_norm else x)
    x = x + _cross_attention(p["cross_attn"], xn, context, cfg, calib)

    tmp = layer_norm(x, eps=cfg.eps).float()
    tmp = (tmp * (1.0 + e[:, 4][:, None]) + e[:, 3][:, None]).to(dtype)
    if calib is None and tmp.shape[0] * tmp.shape[1] > FFN_CHUNK_ROWS:
        y = _ffn_chunked(p, tmp)
    else:
        h = _gelu_tanh(_linear(p["ffn_in"], tmp))
        if calib is not None:
            calib["ffn_in/kernel"] = _amax(tmp)
            calib["ffn_out/kernel"] = _amax(h)
        y = _linear(p["ffn_out"], h)
        # the [rows, ffn_dim] hidden (1.69 GiB at the 14B's 65,520 rows)
        # must not stay alive through the fp32 residual below
        del h
    return (x.float() + y.float() * e[:, 5][:, None]).to(dtype)


def wan_dit_e0(params: Params, cfg: WanDiTConfig, t: torch.Tensor):
    """(e [B, D], e0 [B, 6, D]) fp32 time embeddings of timesteps t [B]
    (quantized kernels dequantized to their recorded dtype, fp32)."""
    te = qz.dequantize_tree(params["time_embedding"])
    e = sinusoidal_embedding_1d(cfg.freq_dim, t)
    e = _linear(te["fc2"], F.silu(_linear(te["fc1"], e).float())).float()
    e0 = _linear(qz.dequantize_tree(params["time_projection"]), F.silu(e))
    return e, e0.reshape(t.shape[0], 6, cfg.dim).float()


def wan_dit_embed(params: Params, cfg: WanDiTConfig, x, t, context):
    """Patch-embed latents + time / text embeddings -> (tokens [B, S, D],
    e [B, D], e0 [B, 6, D], ctx [B, text_len, D], grid)."""
    pt, ph, pw = cfg.patch_size
    grid = (x.shape[2] // pt, x.shape[3] // ph, x.shape[4] // pw)
    tokens = _linear(params["patch_embedding"], patchify(x, cfg.patch_size))
    e, e0 = wan_dit_e0(params, cfg, t)
    tee = params["text_embedding"]
    ctx = _linear(tee["fc2"], _gelu_tanh(_linear(tee["fc1"], context.to(tokens.dtype))))
    return tokens, e, e0, ctx, grid


def geoada_patch_embedding(params: Params, cfg: WanDiTConfig, geoada_context):
    return _linear(params["geoada_patch_embedding"],
                   patchify(geoada_context, cfg.patch_size))


def _block(remat: bool, p: Params, cfg: WanDiTConfig, x, e0, cos, sin, context,
           rope_i, calib=None, lora=None):
    """wan_block_forward, rematerialised in the backward pass when `remat`
    and grad is enabled (the counterpart of jax.checkpoint on the block)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(wan_block_forward, p, cfg, x, e0, cos, sin, context,
                          rope_i, None, lora, use_reentrant=False)
    return wan_block_forward(p, cfg, x, e0, cos, sin, context, rope_i, calib, lora)


def _stack_stats(cals):
    return {site: torch.stack([c[site] for c in cals]) for site in cals[0]}


def wan_dit_blocks(params: Params, cfg: WanDiTConfig, x, e0, cos, sin, context,
                   geoada_tokens: Optional[torch.Tensor] = None,
                   geoada_scale: float = 1.0, remat: bool = False,
                   calibrate: bool = False, lora=None):
    """All transformer blocks, with the GeoAdapter superstep when present.
    cos/sin: half-width RoPE tables [S, head_dim/2]. remat: recompute each
    block (and each GeoAdapter block) in the backward pass instead of
    keeping its activations, so only the block inputs stay alive.
    calibrate: also return the activation absmax stats
    {"blocks": {site: [L]}, "geoada_blocks": {site: [G]}} (inference only).
    lora: (factors of utils/lora.init_lora, scale), applied block by block."""
    if calibrate and remat:
        raise ValueError("calibrate is inference-only (stats escape remat)")
    rope_i = prepare_fused_rope_tables(cos, sin)
    blocks = params["blocks"]
    bcals = [{} if calibrate else None for _ in blocks]
    if not cfg.has_geoadapter or geoada_tokens is None:
        for i, bp in enumerate(blocks):
            x = _block(remat, bp, cfg, x, e0, cos, sin, context, rope_i, bcals[i],
                       block_factors(lora, "blocks", i))
        return (x, {"blocks": _stack_stats(bcals)}) if calibrate else x
    L = cfg.num_layers
    glayers = cfg.resolved_geoada_layers
    stride = glayers[1] - glayers[0] if len(glayers) > 1 else L
    if not (glayers == tuple(range(0, L, stride)) and L % stride == 0):
        raise NotImplementedError(f"non-uniform geoada_layers {glayers}")
    c = _linear(params["geoada_before_proj"], geoada_tokens) + x
    gcals = [{} if calibrate else None for _ in params["geoada_blocks"]]
    for i, gp in enumerate(params["geoada_blocks"]):
        c = _block(remat, gp, cfg, c, e0, cos, sin, context, rope_i, gcals[i],
                   block_factors(lora, "geoada_blocks", i))
        for j in range(stride):
            b = stride * i + j
            x = _block(remat, blocks[b], cfg, x, e0, cos, sin, context, rope_i, bcals[b],
                       block_factors(lora, "blocks", b))
            if j == 0:
                hint = _linear(gp["after_proj"], c)
                x = x + (hint * geoada_scale).to(x.dtype)
    if calibrate:
        return x, {"blocks": _stack_stats(bcals), "geoada_blocks": _stack_stats(gcals)}
    return x


def wan_dit_head(params: Params, cfg: WanDiTConfig, x, e, grid):
    """Final AdaLN head + unpatchify."""
    hp = params["head"]
    em = hp["modulation"][None].float() + e[:, None].float()
    xn = layer_norm(x, eps=cfg.eps).float()
    xn = (xn * (1.0 + em[:, 1][:, None]) + em[:, 0][:, None]).to(x.dtype)
    return unpatchify(_linear(hp["head"], xn), grid, cfg.patch_size, cfg.out_dim)


@torch.no_grad()
def wan_dit_forward(params: Params, cfg: WanDiTConfig, x, t, context, cos, sin,
                    geoada_context=None, geoada_scale: float = 1.0, y=None,
                    clip_fea=None, y_camera=None, calibrate: bool = False):
    """Full denoiser forward: x [B, C_in, F, H, W] latents, t [B] timesteps,
    context [B, text_len, text_dim], cos/sin [S, head_dim/2] RoPE tables,
    geoada_context [B, geoada_in_dim, F, H, W] -> velocity [B, C_out, F, H, W];
    with calibrate, (velocity, the activation absmax stats of
    wan_dit_blocks)."""
    check_supported(cfg)
    if y is not None or clip_fea is not None or y_camera is not None:
        raise NotImplementedError(
            "i2v y / clip_fea and y_camera conditioning are not ported yet")
    tokens, e, e0, ctx, grid = wan_dit_embed(params, cfg, x, t, context)
    gtokens = None
    if geoada_context is not None and cfg.has_geoadapter:
        gtokens = geoada_patch_embedding(params, cfg, geoada_context)
    tokens = wan_dit_blocks(params, cfg, tokens, e0, cos.to(x.device),
                            sin.to(x.device), ctx,
                            geoada_tokens=gtokens, geoada_scale=geoada_scale,
                            calibrate=calibrate)
    if calibrate:
        tokens, stats = tokens
        return wan_dit_head(params, cfg, tokens, e, grid), stats
    return wan_dit_head(params, cfg, tokens, e, grid)
