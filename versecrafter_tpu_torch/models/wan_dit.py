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
hint after_proj(c)*scale is added right after that base block (the same
result as the reference's all-hints-first order, with one hint alive at a
time). Training calls wan_dit_embed, wan_dit_blocks (remat=True) and
wan_dit_head directly; wan_dit_forward is inference only.

The base-Wan conditioning: an i2v model (model_type "i2v") concatenates
its `y` latents on channels, embeds CLIP image tokens through `img_emb`
(LayerNorm -> fc1 -> exact GELU -> fc2 -> LayerNorm) and gives its base
blocks a second cross-attention over them (k_img / v_img), which runs the
plain path: q and k RMS-normed, relaid head-major, the plain flash-attention
kernel over the text keys and again over the image keys, the two added.
The SimpleAdapter (`control_adapter`) turns camera-pose maps `y_camera`
into tokens added to the patch embeddings.

A linear kernel may be a quantized leaf (utils/quantize.py): a
compute-tagged one runs the W8A8 product, a storage-only one is dequantized
to the activations' dtype first. calibrate=True records each block's
per-tensor activation absmax at every W8A8 site (the stats fit_act_scales
takes). A LoRA (utils/lora.py) enters wan_dit_blocks as per-block factors
whose effective kernels are formed inside each (rematerialised) block.

Under a mesh (parallel/sharding.mesh_context with more than one rank) the
blocks take this rank's [B/dp, S/sp, D] token slice and the head gathers
the whole prediction back. Attention then takes the JAX package's
sequence-parallel path (`attn_impl == "sp"`): separate q/k RMSNorm and RoPE
passes, then sharding.sequence_parallel_attention (Ulysses or the ring) and
sp_cross_attention over the plain flash kernel, never the fused kernel. The
projections are tensor-parallel over tp and gathered over fsdp
(sharding.tp_linear), the q/k norm statistic summed over tp.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from versecrafter_tpu_torch.core.config import WanDiTConfig
from versecrafter_tpu_torch.kernels.flash_attention import (
    _heads, _merge_heads, flash_attention, fused_rms_cross_attention,
    fused_rope_rms_attention, prepare_fused_rope_tables)
from versecrafter_tpu_torch.kernels.matmul_stat import linear_rstat
from versecrafter_tpu_torch.kernels.norms import layer_norm, rms_norm
from versecrafter_tpu_torch.kernels.rope import apply_rope
from versecrafter_tpu_torch.parallel import sharding as shd
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
        y = torch.matmul(x, shd.gathered(k).to(x.dtype))
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
    if shd.active_mesh() is not None:  # ffn_in column-, ffn_out row-parallel over tp
        return shd.tp_linear(p["ffn_out"], _gelu_tanh(shd.tp_linear(p["ffn_in"], x, "col")),
                             "row")
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
    if cfg.model_type == "i2v" and not geoada:
        ca = p["cross_attn"]
        ca["k_img"] = _init_linear(gen, cfg.dim, cfg.dim, dtype, device)
        ca["v_img"] = _init_linear(gen, cfg.dim, cfg.dim, dtype, device)
        ca["norm_k_img"] = {"scale": _ones(cfg.dim, device)}
    if geoada:
        p["after_proj"] = _init_linear(gen, cfg.dim, cfg.dim, dtype, device, zero=True)
    return p


def init_simple_adapter(gen, cfg: WanDiTConfig, dtype, device) -> Params:
    """The SimpleAdapter's tree: the strided patch conv as a matmul kernel
    [C*ds*ds*ph*pw, D], and residual blocks of two 3x3 convs with HWIO
    kernels [3, 3, D, D] (the JAX package's layout)."""
    d = cfg.downscale_factor_control_adapter
    ph, pw = cfg.patch_size[1:]
    p: Params = {"conv": _init_linear(gen, cfg.in_dim_control_adapter * d * d * ph * pw,
                                      cfg.dim, dtype, device)}
    lim = math.sqrt(6.0 / (2 * 9 * cfg.dim))

    def conv3():
        k = torch.empty((3, 3, cfg.dim, cfg.dim), dtype=dtype, device=device)
        return {"kernel": k.uniform_(-lim, lim, generator=gen),
                "bias": torch.zeros((cfg.dim,), dtype=dtype, device=device)}

    p["res"] = [{"conv1": conv3(), "conv2": conv3()}
                for _ in range(cfg.control_adapter_residual_blocks)]
    return p


def _init_parts(cfg: WanDiTConfig, g: torch.Generator, dtype):
    """The DiT's parts in the order init_wan_dit draws them: (None, None,
    a dict of top-level entries) or (list name, index, one block)."""
    device = g.device
    pt, ph, pw = cfg.patch_size
    head_mod = torch.empty((2, cfg.dim), dtype=torch.float32, device=device)
    yield None, None, {
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
        # the block lists, filled by the parts that follow
        "blocks": [],
        **({"geoada_blocks": []} if cfg.has_geoadapter else {}),
    }
    for i in range(cfg.num_layers):
        yield "blocks", i, _init_block(g, cfg, dtype, device)
    if cfg.has_geoadapter:
        for i in range(len(cfg.resolved_geoada_layers)):
            yield "geoada_blocks", i, _init_block(g, cfg, dtype, device, geoada=True)
        yield None, None, {
            "geoada_before_proj": _init_linear(g, cfg.dim, cfg.dim, dtype, device,
                                               zero=True),
            "geoada_patch_embedding": _init_linear(
                g, cfg.resolved_geoada_in_dim * pt * ph * pw, cfg.dim, dtype, device)}
    if cfg.add_control_adapter:
        yield None, None, {"control_adapter": init_simple_adapter(g, cfg, dtype, device)}
    if cfg.model_type == "i2v" and cfg.add_img_emb:
        e_in = cfg.img_emb_dim
        yield None, None, {"img_emb": {
            "norm_in": {"scale": _ones(e_in, device),
                        "bias": torch.zeros((e_in,), dtype=torch.float32, device=device)},
            "fc1": _init_linear(g, e_in, e_in, dtype, device),
            "fc2": _init_linear(g, e_in, cfg.dim, dtype, device),
            "norm_out": {"scale": _ones(cfg.dim, device),
                         "bias": torch.zeros((cfg.dim,), dtype=torch.float32,
                                             device=device)},
        }}


def _assemble(parts) -> Params:
    params: Params = {}
    for group, _, part in parts:
        if group is None:
            params.update(part)
        else:
            params[group].append(part)
    return params


def init_wan_dit(cfg: WanDiTConfig, generator: torch.Generator,
                 dtype=torch.bfloat16) -> Params:
    """Random init from `generator`, on the generator's device; the head
    projection is zero, as in the reference. The tree is the JAX init's,
    the i2v and SimpleAdapter parts included, drawn in its order."""
    return _assemble(_init_parts(cfg, generator, dtype))


def init_wan_dit_quantized(cfg: WanDiTConfig, generator: torch.Generator,
                           dtype=torch.bfloat16, bits: int = 8,
                           int8_compute: bool = False, act_scales=None) -> Params:
    """init_wan_dit's tree quantized as it is drawn (the JAX package's
    init_wan_dit_quantized): each block is quantized
    (utils/quantize.quantize_dit_block) before the next is drawn, so at most
    one block exists unquantized and the whole unquantized tree (41 GiB at
    14B + GeoAdapter in bf16) never does. Equal, bit for bit, to
    quantize_dit(init_wan_dit(cfg, generator, dtype), bits, int8_compute,
    act_scales) from a generator in the same state."""
    def quantized():
        for group, i, part in _init_parts(cfg, generator, dtype):
            if group is None:
                out = qz.quantize_dit_top(part, bits, int8_compute, act_scales)
            else:
                n = cfg.num_layers if group == "blocks" else len(cfg.resolved_geoada_layers)
                out = qz.quantize_dit_block(part, group, i, n, bits, int8_compute, act_scales)
            del part  # before the next part is drawn
            yield group, i, out
    return _assemble(quantized())


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _plain_kernel(p: Params) -> bool:
    return isinstance(p["kernel"], torch.Tensor)


def _heads_local(x, hd: int):
    """[B, S, n*hd] (this rank's heads) -> head-major [B, n, S, hd]."""
    return _heads(x, x.shape[-1] // hd)


def _sp_self_attention(p: Params, x, cos, sin, cfg: WanDiTConfig):
    """The sequence-parallel self-attention of this rank's token slice
    and tp slice of heads: separate norm and RoPE passes (cos / sin are the
    slice's rows), then Ulysses or the ring."""
    hd = cfg.head_dim
    q = shd.tp_linear(p["q"], x, "col")
    k = shd.tp_linear(p["k"], x, "col")
    v = shd.tp_linear(p["v"], x, "col")
    if cfg.qk_norm:
        q = shd.tp_rms_norm(q, p["norm_q"]["scale"], cfg.eps, cfg.dim)
        k = shd.tp_rms_norm(k, p["norm_k"]["scale"], cfg.eps, cfg.dim)
    b, s, _ = q.shape
    q = apply_rope(q.reshape(b, s, -1, hd), cos, sin).transpose(1, 2).contiguous()
    k = apply_rope(k.reshape(b, s, -1, hd), cos, sin).transpose(1, 2).contiguous()
    out = shd.sequence_parallel_attention(q, k, _heads_local(v, hd),
                                          window_size=cfg.window_size)
    return shd.tp_linear(p["o"], _merge_heads(out), "row")


def _sp_cross_attention(p: Params, x, context, cfg: WanDiTConfig, context_img=None):
    """The sequence-parallel cross-attention: each token slice against the
    whole context (and the i2v image tokens), tp slices of heads."""
    hd = cfg.head_dim
    q = shd.tp_linear(p["q"], x, "col")
    k = shd.tp_linear(p["k"], context, "col")
    v = shd.tp_linear(p["v"], context, "col")
    if cfg.qk_norm:
        q = shd.tp_rms_norm(q, p["norm_q"]["scale"], cfg.eps, cfg.dim)
        k = shd.tp_rms_norm(k, p["norm_k"]["scale"], cfg.eps, cfg.dim)
    qh = _heads_local(q, hd)
    out = shd.sp_cross_attention(qh, _heads_local(k, hd), _heads_local(v, hd))
    if context_img is not None:
        k_img = shd.tp_linear(p["k_img"], context_img, "col")
        if cfg.qk_norm:
            k_img = shd.tp_rms_norm(k_img, p["norm_k_img"]["scale"], cfg.eps, cfg.dim)
        v_img = shd.tp_linear(p["v_img"], context_img, "col")
        out = out + shd.sp_cross_attention(qh, _heads_local(k_img, hd),
                                           _heads_local(v_img, hd))
    return shd.tp_linear(p["o"], _merge_heads(out), "row")


def _self_attention(p: Params, x, cos, sin, rope_i, cfg: WanDiTConfig, calib=None):
    if shd.active_mesh() is not None:
        return _sp_self_attention(p, x, cos, sin, cfg)
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


def _cross_attention(p: Params, x, context, cfg: WanDiTConfig, calib=None,
                     context_img=None):
    if shd.active_mesh() is not None:
        return _sp_cross_attention(p, x, context, cfg, context_img)
    if calib is not None:
        calib["cross_attn/q/kernel"] = _amax(x)
        calib["cross_attn/k/kernel"] = calib["cross_attn/v/kernel"] = _amax(context)
    rq = None
    if (context_img is None and cfg.qk_norm and PROJ_STAT_FUSION
            and _plain_kernel(p["q"])):
        # the q statistic comes from the projection; the k statistic spans
        # only the context tokens
        q, rq = linear_rstat(p["q"], x, cfg.eps)
    else:
        q = _linear(p["q"], x)
    k = _linear(p["k"], context)
    v = _linear(p["v"], context)
    if context_img is None:
        out = fused_rms_cross_attention(
            q, k, v,
            p["norm_q"]["scale"] if cfg.qk_norm else None,
            p["norm_k"]["scale"] if cfg.qk_norm else None,
            num_heads=cfg.num_heads, eps=cfg.eps, rq=rq)
    else:
        # i2v: the plain path, as the JAX package runs it (its fused cross
        # kernel takes one key set): separate norm passes, head-major
        # relayouts, the plain kernel over the text keys and again over the
        # image keys, the two outputs added
        n = cfg.num_heads
        if cfg.qk_norm:
            q = rms_norm(q, p["norm_q"]["scale"], cfg.eps)
            k = rms_norm(k, p["norm_k"]["scale"], cfg.eps)
        qh = _heads(q, n)
        out = flash_attention(qh, _heads(k, n), _heads(v, n))
        if calib is not None:
            calib["cross_attn/k_img/kernel"] = calib["cross_attn/v_img/kernel"] = \
                _amax(context_img)
        k_img = _linear(p["k_img"], context_img)
        if cfg.qk_norm:
            k_img = rms_norm(k_img, p["norm_k_img"]["scale"], cfg.eps)
        v_img = _linear(p["v_img"], context_img)
        out = _merge_heads(out + flash_attention(qh, _heads(k_img, n), _heads(v_img, n)))
    if calib is not None:
        calib["cross_attn/o/kernel"] = _amax(out)
    return _linear(p["o"], out)


def wan_block_forward(p: Params, cfg: WanDiTConfig, x, e0, cos, sin, context,
                      rope_i=None, calib=None, lora=None, context_img=None):
    """One Wan attention block. x [B, S, D]; e0 [B, 6, D] fp32 modulation;
    cos/sin the half-width RoPE tables (the differentiable attention path
    uses them) and rope_i the interleaved tables from
    prepare_fused_rope_tables (the fused inference kernel uses them).
    calib: a dict that receives the absmax at each W8A8 site (keys as in
    utils/quantize.COMPUTE_SITES). lora: (this block's factors, scale), whose
    effective kernels are formed here, inside any rematerialisation.
    context_img: the i2v image tokens [B, N_img, D] of a base block."""
    mesh = shd.active_mesh()
    if lora is not None:
        # the LoRA delta applies to the whole kernels
        p = lora_block(_gathered_tree(p) if mesh is not None else p, *lora)
    dtype = x.dtype
    e = p["modulation"][None].float() + e0
    tmp = layer_norm(x, eps=cfg.eps).float()
    tmp = (tmp * (1.0 + e[:, 1][:, None]) + e[:, 0][:, None]).to(dtype)
    y = _self_attention(p["self_attn"], tmp, cos, sin, rope_i, cfg, calib)
    x = (x.float() + y.float() * e[:, 2][:, None]).to(dtype)

    xn = (layer_norm(x, p["norm3"]["scale"], p["norm3"]["bias"], eps=cfg.eps)
          if cfg.cross_attn_norm else x)
    x = x + _cross_attention(p["cross_attn"], xn, context, cfg, calib, context_img)

    tmp = layer_norm(x, eps=cfg.eps).float()
    tmp = (tmp * (1.0 + e[:, 4][:, None]) + e[:, 3][:, None]).to(dtype)
    if calib is None and tmp.shape[0] * tmp.shape[1] > FFN_CHUNK_ROWS:
        y = _ffn_chunked(p, tmp)
    elif calib is None:
        y = _ffn(p, tmp)
    else:
        h = _gelu_tanh(_linear(p["ffn_in"], tmp))
        calib["ffn_in/kernel"] = _amax(tmp)
        calib["ffn_out/kernel"] = _amax(h)
        y = _linear(p["ffn_out"], h)
        # the [rows, ffn_dim] hidden (1.69 GiB at the 14B's 65,520 rows)
        # must not stay alive through the fp32 residual below
        del h
    return (x.float() + y.float() * e[:, 5][:, None]).to(dtype)


def _gathered_tree(p):
    if isinstance(p, dict):
        return {k: _gathered_tree(v) for k, v in p.items()}
    return shd.gathered(p)


def wan_dit_e0(params: Params, cfg: WanDiTConfig, t: torch.Tensor):
    """(e [B, D], e0 [B, 6, D]) fp32 time embeddings of timesteps t [B]
    (quantized kernels dequantized to their recorded dtype, fp32)."""
    te = qz.dequantize_tree(params["time_embedding"])
    e = sinusoidal_embedding_1d(cfg.freq_dim, t)
    e = _linear(te["fc2"], F.silu(_linear(te["fc1"], e).float())).float()
    e0 = _linear(qz.dequantize_tree(params["time_projection"]), F.silu(e))
    return e, e0.reshape(t.shape[0], 6, cfg.dim).float()


class _NoTF32Conv:
    """cuDNN convolutions without TF32 inside the block (fp32 inputs keep
    their full precision, as the JAX package's convolutions do)."""

    def __enter__(self):
        self.saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32 = self.saved


def simple_adapter(p: Params, y_camera: torch.Tensor, patch_size=(2, 2),
                   downscale: int = 8) -> torch.Tensor:
    """The camera-pose SimpleAdapter: per-frame pixel-unshuffle by
    `downscale` into channels, the strided patch conv as a matmul, then
    ReLU-conv3x3 residual blocks on the per-frame token grid (NCHW, the HWIO
    kernels permuted to OIHW). y_camera [B, C, F, H, W] -> tokens [B, S, D]
    in patchify's (f, h, w) order."""
    b, c, f, h, w = y_camera.shape
    d = downscale
    ph, pw = patch_size
    x = y_camera.reshape(b, c, f, h // d, d, w // d, d)
    x = x.permute(0, 1, 4, 6, 2, 3, 5).reshape(b, c * d * d, f, h // d, w // d)
    tok = _linear(p["conv"], patchify(x, (1, ph, pw)))
    gh, gw = h // d // ph, w // d // pw
    if p.get("res"):
        dim = tok.shape[-1]
        z = tok.reshape(b * f, gh, gw, dim).permute(0, 3, 1, 2)
        with _NoTF32Conv():
            for blk in p["res"]:
                y = z
                for cv in (blk["conv1"], blk["conv2"]):
                    y = F.conv2d(F.relu(y), cv["kernel"].permute(3, 2, 0, 1).to(y.dtype),
                                 padding=1)
                    y = y + cv["bias"].to(y.dtype)[:, None, None]
                z = z + y
        tok = z.permute(0, 2, 3, 1).reshape(b, f * gh * gw, dim)
    return tok


def img_embedding(params: Params, clip_fea: torch.Tensor, dtype) -> torch.Tensor:
    """CLIP image tokens [B, N_img, img_emb_dim] -> [B, N_img, D] in
    `dtype`: LayerNorm -> fc1 -> exact (erf) GELU -> fc2 -> LayerNorm."""
    ie = params["img_emb"]
    h = layer_norm(clip_fea, ie["norm_in"]["scale"], ie["norm_in"]["bias"])
    h = _linear(ie["fc2"], F.gelu(_linear(ie["fc1"], h.to(dtype)), approximate="none"))
    return layer_norm(h, ie["norm_out"]["scale"], ie["norm_out"]["bias"]).to(dtype)


def wan_dit_embed(params: Params, cfg: WanDiTConfig, x, t, context,
                  clip_fea=None, y_camera=None):
    """Patch-embed latents + time / text embeddings -> (tokens [B, S, D],
    e [B, D], e0 [B, 6, D], ctx [B, text_len, D], ctx_img [B, N_img, D] or
    None, grid). y_camera [B, C_cam, F*pt, H_lat*ds, W_lat*ds]: camera maps
    through the SimpleAdapter, added to the patch embeddings; clip_fea
    [B, N_img, img_emb_dim]: CLIP tokens through img_emb (when the tree has
    one)."""
    pt, ph, pw = cfg.patch_size
    grid = (x.shape[2] // pt, x.shape[3] // ph, x.shape[4] // pw)
    tokens = _linear(params["patch_embedding"], patchify(x, cfg.patch_size))
    if y_camera is not None:
        if "control_adapter" not in params:
            raise ValueError(
                "y_camera conditioning passed but params have no "
                "'control_adapter' entry — the checkpoint was built without "
                "a SimpleAdapter (add_control_adapter=False), so the maps "
                "would be silently ignored")
        tokens = tokens + simple_adapter(
            params["control_adapter"], y_camera, cfg.patch_size[1:],
            cfg.downscale_factor_control_adapter).to(tokens.dtype)
    e, e0 = wan_dit_e0(params, cfg, t)
    tee = params["text_embedding"]
    ctx = _linear(tee["fc2"], _gelu_tanh(_linear(tee["fc1"], context.to(tokens.dtype))))
    ctx_img = None
    if clip_fea is not None and "img_emb" in params:
        ctx_img = img_embedding(params, clip_fea, tokens.dtype)
    return tokens, e, e0, ctx, ctx_img, grid


def geoada_patch_embedding(params: Params, cfg: WanDiTConfig, geoada_context):
    return _linear(params["geoada_patch_embedding"],
                   patchify(geoada_context, cfg.patch_size))


def _block(remat: bool, p: Params, cfg: WanDiTConfig, x, e0, cos, sin, context,
           rope_i, calib=None, lora=None, context_img=None):
    """wan_block_forward, rematerialised in the backward pass when `remat`
    and grad is enabled (the counterpart of jax.checkpoint on the block)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(wan_block_forward, p, cfg, x, e0, cos, sin, context,
                          rope_i, None, lora, context_img, use_reentrant=False)
    return wan_block_forward(p, cfg, x, e0, cos, sin, context, rope_i, calib, lora,
                             context_img)


def _stack_stats(cals):
    return {site: torch.stack([c[site] for c in cals]) for site in cals[0]}


def wan_dit_blocks(params: Params, cfg: WanDiTConfig, x, e0, cos, sin, context,
                   geoada_tokens: Optional[torch.Tensor] = None,
                   geoada_scale: float = 1.0, remat: bool = False,
                   calibrate: bool = False, lora=None, context_img=None):
    """All transformer blocks, with the GeoAdapter superstep when present.
    cos/sin: half-width RoPE tables [S, head_dim/2]. remat: recompute each
    block (and each GeoAdapter block) in the backward pass instead of
    keeping its activations, so only the block inputs stay alive.
    calibrate: also return the activation absmax stats
    {"blocks": {site: [L]}, "geoada_blocks": {site: [G]}} (inference only).
    lora: (factors of utils/lora.init_lora, scale), applied block by block.
    context_img: the i2v image tokens, which only the base blocks attend
    to."""
    if calibrate and remat:
        raise ValueError("calibrate is inference-only (stats escape remat)")
    if shd.active_mesh() is not None:
        # x is this rank's token slice: the per-row inputs and the RoPE
        # tables follow it
        if calibrate:
            raise ValueError("calibrate runs on one rank, not under a mesh")
        e0, context, context_img = (shd.local_rows(t) for t in (e0, context, context_img))
        cos, sin = shd.local_seq(cos), shd.local_seq(sin)
        rope_i = None
    else:
        rope_i = prepare_fused_rope_tables(cos, sin)
    blocks = params["blocks"]
    bcals = [{} if calibrate else None for _ in blocks]

    def base(b, x):
        return _block(remat, blocks[b], cfg, x, e0, cos, sin, context, rope_i, bcals[b],
                      block_factors(lora, "blocks", b), context_img)

    if not cfg.has_geoadapter or geoada_tokens is None:
        for i in range(len(blocks)):
            x = base(i, x)
        return (x, {"blocks": _stack_stats(bcals)}) if calibrate else x
    L = cfg.num_layers
    glayers = cfg.resolved_geoada_layers
    stride = glayers[1] - glayers[0] if len(glayers) > 1 else L
    if not (glayers == tuple(range(0, L, stride)) and L % stride == 0
            and len(glayers) == L // stride):
        raise NotImplementedError(
            f"non-uniform geoada_layers {glayers} (reference default is every "
            f"2nd layer; add a python-loop path if ever needed)")
    c = _linear(params["geoada_before_proj"], geoada_tokens) + x
    gcals = [{} if calibrate else None for _ in params["geoada_blocks"]]
    for i, gp in enumerate(params["geoada_blocks"]):
        c = _block(remat, gp, cfg, c, e0, cos, sin, context, rope_i, gcals[i],
                   block_factors(lora, "geoada_blocks", i))
        for j in range(stride):
            x = base(stride * i + j, x)
            if j == 0:
                hint = _linear(gp["after_proj"], c)
                x = x + (hint * geoada_scale).to(x.dtype)
    if calibrate:
        return x, {"blocks": _stack_stats(bcals), "geoada_blocks": _stack_stats(gcals)}
    return x


def wan_dit_head(params: Params, cfg: WanDiTConfig, x, e, grid):
    """Final AdaLN head + unpatchify. Under a mesh x is this rank's token
    slice: the head runs on it and its output is gathered whole."""
    hp = params["head"]
    em = hp["modulation"][None].float() + shd.local_rows(e)[:, None].float()
    xn = layer_norm(x, eps=cfg.eps).float()
    xn = (xn * (1.0 + em[:, 1][:, None]) + em[:, 0][:, None]).to(x.dtype)
    out = shd.gather_tokens(_linear(hp["head"], xn))
    return unpatchify(out, grid, cfg.patch_size, cfg.out_dim)


@torch.no_grad()
def wan_dit_forward(params: Params, cfg: WanDiTConfig, x, t, context, cos, sin,
                    geoada_context=None, geoada_scale: float = 1.0, y=None,
                    clip_fea=None, y_camera=None, calibrate: bool = False):
    """Full denoiser forward: x [B, C_in, F, H, W] latents, t [B] timesteps,
    context [B, text_len, text_dim], cos/sin [S, head_dim/2] RoPE tables,
    geoada_context [B, geoada_in_dim, F, H, W]; y [B, C_y, F, H, W] i2v
    latents concatenated on channels, clip_fea and y_camera as in
    wan_dit_embed -> velocity [B, C_out, F, H, W]; with calibrate,
    (velocity, the activation absmax stats of wan_dit_blocks)."""
    if y is not None:
        x = torch.cat([x, y.to(x.dtype)], dim=1)
    tokens, e, e0, ctx, ctx_img, grid = wan_dit_embed(params, cfg, x, t, context,
                                                      clip_fea, y_camera)
    gtokens = None
    if geoada_context is not None and cfg.has_geoadapter:
        gtokens = shd.constrain_tokens(geoada_patch_embedding(params, cfg, geoada_context))
    tokens = shd.constrain_tokens(tokens)
    tokens = wan_dit_blocks(params, cfg, tokens, e0, cos.to(x.device),
                            sin.to(x.device), ctx,
                            geoada_tokens=gtokens, geoada_scale=geoada_scale,
                            calibrate=calibrate, context_img=ctx_img)
    if calibrate:
        tokens, stats = tokens
        return wan_dit_head(params, cfg, tokens, e, grid), stats
    return wan_dit_head(params, cfg, tokens, e, grid)
