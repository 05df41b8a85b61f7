"""Wan 3D causal video VAE, full-sequence encode/decode.

video [B, 3, T, H, W] in [-1, 1] -> latents [B, 16, (T-1)/4+1, H/8, W/8]
with causal temporal padding (frame t's latent depends on frames <= t),
mode() semantics and the Wan2.1 per-channel latent statistics; the decoder
mirrors it with temporal upsampling to 2t-1 frames per stage. Parameters use
the JAX package's tree with OIDHW / OIHW conv kernels; weights are cast to
the activation dtype at use. A bf16 convolution on the CPU runs in fp32 on
the bf16 operands and rounds once (conv): PyTorch's CPU bf16 convolution
reads values from outside its input at small spatial sizes
(scripts/check_torch_cpu_bf16_conv.py).

Every op takes `width`: None for a whole tensor, or a width shard
(parallel/sharding.WidthShard) when the tensor is this rank's slice of the
width under a mesh (sharding.shard_vae_io). Then each conv wider than one
column pads its slice with the neighbours' edge columns (width.halo, zeros
only past the global edges) instead of zeros, the attention block's keys
and values come from the whole frame (width.gather), and the rest (norms,
SiLU, 1x1 convs, the temporal convs and padding) is per column and runs on
the slice as it is.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from versecrafter_tpu_torch.core.config import VAEConfig

Params = Dict[str, Any]

WAN21_LATENT_MEAN = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921)
WAN21_LATENT_STD = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160)


def _stat(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=like.device).to(
        like.dtype)[None, :, None, None, None]


def conv(fn, x, kernel, bias: Optional[torch.Tensor], **kw):
    """fn (F.conv2d / F.conv3d) of x with kernel and bias cast to x's
    dtype; for a bf16 x on the CPU the same bf16 operands convolved in fp32,
    rounded once to bf16 (see the module docstring)."""
    kernel = kernel.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    if x.dtype != torch.bfloat16 or x.device.type != "cpu":
        return fn(x, kernel, bias, **kw)
    return fn(x.float(), kernel.float(), None if bias is None else bias.float(),
              **kw).to(x.dtype)


def pad_w(x, left: int, right: int, width=None):
    """[B, C, T, H, W] with `left` / `right` columns on its width: zeros, or
    under a width shard the neighbours' edge columns."""
    if left == right == 0:
        return x
    if width is None:
        return F.pad(x, (left, right))
    return width.halo(x, left, right)


def causal_conv3d(x, kernel, bias: Optional[torch.Tensor], stride=(1, 1, 1),
                  width=None):
    """Conv3d NCDHW with causal temporal padding (2*(kT//2) frames on the
    past side only) and symmetric spatial padding (the width's from the
    neighbours under a width shard)."""
    kt, kh, kw = kernel.shape[2:]
    if width is None:
        x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, 2 * (kt // 2), 0))
    else:
        x = F.pad(pad_w(x, kw // 2, kw // 2, width), (0, 0, kh // 2, kh // 2, 2 * (kt // 2), 0))
    return conv(F.conv3d, x, kernel, bias, stride=stride)


def conv2d_spatial(x, kernel, bias: Optional[torch.Tensor], stride: int = 1,
                   asym_pad: bool = False, width=None):
    """Per-frame 2D conv on [B, C, T, H, W]; asym_pad zero-pads (0,1,0,1)
    before a stride-2 downsample (under a width shard the right column is
    the right neighbour's first)."""
    kh, kw = kernel.shape[2:]
    if asym_pad:
        lw, rw, hpad = 0, 1, (0, 1)
    else:
        lw, rw, hpad = kw // 2, kw // 2, (kh // 2, kh // 2)
    if width is not None:
        x, lw, rw = pad_w(x, lw, rw, width), 0, 0
    b, c, t, h, w = x.shape
    xb = F.pad(x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w), (lw, rw, *hpad))
    y = conv(F.conv2d, xb, kernel, bias, stride=stride)
    _, co, ho, wo = y.shape
    return y.reshape(b, t, co, ho, wo).permute(0, 2, 1, 3, 4)


def channel_rms_norm(x, gamma):
    """RMS norm over the channel axis of NCDHW, fp32 math."""
    xf = x.float()
    scale = torch.rsqrt(xf.square().mean(1, keepdim=True) + 1e-12)
    return (xf * scale * gamma.float()[None, :, None, None, None]).to(x.dtype)


def _res_block(p: Params, x, width=None):
    h = channel_rms_norm(x, p["norm1"]["gamma"])
    h = causal_conv3d(F.silu(h), p["conv1"]["kernel"], p["conv1"]["bias"], width=width)
    h = channel_rms_norm(h, p["norm2"]["gamma"])
    h = causal_conv3d(F.silu(h), p["conv2"]["kernel"], p["conv2"]["bias"], width=width)
    if "shortcut" in p:
        x = causal_conv3d(x, p["shortcut"]["kernel"], p["shortcut"]["bias"])
    return x + h


def _positions(x):
    """[B, C, T, H, W] -> [B*T, H*W, C]."""
    b, c, t, h, w = x.shape
    return x.permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c)


def _attn_block(p: Params, x, width=None):
    """Single-head self-attention over spatial positions, per frame. Under
    a width shard the queries are this slice's positions and the keys and
    values the whole frame's (the normed activations gathered)."""
    b, c, t, h, w = x.shape
    xn = channel_rms_norm(x, p["norm"]["gamma"])
    flat = _positions(xn)
    kernel, bias = p["qkv"]["kernel"].to(flat.dtype), p["qkv"]["bias"].to(flat.dtype)
    if width is None:
        q, k, v = (torch.matmul(flat, kernel) + bias).chunk(3, dim=-1)
    else:
        q = torch.matmul(flat, kernel[:, :c]) + bias[:c]
        k, v = (torch.matmul(_positions(width.gather(xn)), kernel[:, c:])
                + bias[c:]).chunk(2, dim=-1)
    s = torch.einsum("bqc,bkc->bqk", q.float(), k.float())
    s = torch.softmax(s / math.sqrt(c), dim=-1)
    o = torch.einsum("bqk,bkc->bqc", s, v.float()).to(flat.dtype)
    o = torch.matmul(o, p["proj"]["kernel"].to(o.dtype)) + p["proj"]["bias"].to(o.dtype)
    return x + o.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)


def _downsample(p: Params, x, temporal: bool, width=None):
    x = conv2d_spatial(x, p["conv"]["kernel"], p["conv"]["bias"], stride=2,
                       asym_pad=True, width=width)
    if temporal:
        x = causal_conv3d(x, p["time_conv"]["kernel"], p["time_conv"]["bias"],
                          stride=(2, 1, 1))
    return x


def up_spatial(p: Params, x, width=None):
    """Nearest-2x spatial + the 3x3 conv that halves the channels (its halo
    the neighbours' edge columns after the repeat)."""
    x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
    return conv2d_spatial(x, p["conv"]["kernel"], p["conv"]["bias"], width=width)


def _upsample(p: Params, x, temporal: bool, width=None):
    """Temporal interleave (T -> 2T-1) then nearest-2x spatial + a conv that
    halves the channels."""
    if temporal:
        b, c, t, h, w = x.shape
        y = causal_conv3d(x, p["time_conv"]["kernel"], p["time_conv"]["bias"])
        y = y.reshape(b, 2, c, t, h, w).permute(0, 2, 3, 1, 4, 5).reshape(b, c, 2 * t, h, w)
        x = y[:, :, 1:]
    return up_spatial(p, x, width)


# ---------------------------------------------------------------------------
# init (same tree, shapes and dtypes as the JAX package's init_vae)
# ---------------------------------------------------------------------------

def init_vae(cfg: VAEConfig, generator: torch.Generator,
             dtype=torch.float32) -> Params:
    """Random init (N(0, 1/fan_in) kernels, zero biases, unit gammas) from
    `generator` on its device."""
    device = generator.device

    def conv(cin, cout, k: Tuple[int, ...]):
        w = torch.empty((cout, cin, *k), dtype=torch.float32, device=device)
        w.normal_(generator=generator).mul_(1.0 / math.sqrt(cin * math.prod(k)))
        return {"kernel": w.to(dtype),
                "bias": torch.zeros((cout,), dtype=dtype, device=device)}

    def dense(cin, cout):
        w = torch.empty((cin, cout), dtype=torch.float32, device=device)
        w.normal_(generator=generator).mul_(1.0 / math.sqrt(cin))
        return {"kernel": w.to(dtype),
                "bias": torch.zeros((cout,), dtype=dtype, device=device)}

    def gamma(c):
        return {"gamma": torch.ones((c,), dtype=torch.float32, device=device)}

    def res(cin, cout):
        p = {"norm1": gamma(cin), "conv1": conv(cin, cout, (3, 3, 3)),
             "norm2": gamma(cout), "conv2": conv(cout, cout, (3, 3, 3))}
        if cin != cout:
            p["shortcut"] = conv(cin, cout, (1, 1, 1))
        return p

    def attn(c):
        return {"norm": gamma(c), "qkv": dense(c, 3 * c), "proj": dense(c, c)}

    dims = [cfg.base_dim * m for m in cfg.dim_mult]
    enc: Params = {"conv_in": conv(3, dims[0], (3, 3, 3))}
    cin = dims[0]
    stages = []
    for i, d in enumerate(dims):
        st: Params = {"res": []}
        for _ in range(cfg.num_res_blocks):
            st["res"].append(res(cin, d))
            cin = d
        if i != len(dims) - 1:
            st["down"] = {"conv": conv(d, d, (3, 3))}
            if cfg.temporal_downsample[i]:
                st["down"]["time_conv"] = conv(d, d, (3, 1, 1))
        stages.append(st)
    enc["stages"] = stages
    enc["mid"] = {"res1": res(cin, cin), "attn": attn(cin), "res2": res(cin, cin)}
    enc["norm_out"] = gamma(cin)
    enc["conv_out"] = conv(cin, 2 * cfg.z_dim, (3, 3, 3))
    enc["quant_conv"] = conv(2 * cfg.z_dim, 2 * cfg.z_dim, (1, 1, 1))

    rdims = [cfg.base_dim * m for m in ([cfg.dim_mult[-1]] + list(cfg.dim_mult[::-1]))]
    dec: Params = {
        "post_quant_conv": conv(cfg.z_dim, cfg.z_dim, (1, 1, 1)),
        "conv_in": conv(cfg.z_dim, rdims[0], (3, 3, 3)),
        "mid": {"res1": res(rdims[0], rdims[0]), "attn": attn(rdims[0]),
                "res2": res(rdims[0], rdims[0])},
    }
    t_up = cfg.temporal_downsample[::-1]
    n_stage = len(rdims) - 1
    ustages = []
    for i in range(n_stage):
        cin = rdims[i] if i == 0 else rdims[i] // 2
        out = rdims[i + 1]
        st = {"res": []}
        for _ in range(cfg.num_res_blocks + 1):
            st["res"].append(res(cin, out))
            cin = out
        if i != n_stage - 1:
            st["up"] = {"conv": conv(out, out // 2, (3, 3))}
            if i < len(t_up) and t_up[i]:
                st["up"]["time_conv"] = conv(out, 2 * out, (3, 1, 1))
        ustages.append(st)
    dec["stages"] = ustages
    dec["norm_out"] = gamma(rdims[-1])
    dec["conv_out"] = conv(rdims[-1], 3, (3, 3, 3))
    return {"encoder": enc, "decoder": dec}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@torch.no_grad()
def vae_encode(params: Params, cfg: VAEConfig, x: torch.Tensor, width=None) -> torch.Tensor:
    """[B, 3, T, H, W] in [-1, 1] -> the distribution mean (mode()),
    standardized by the Wan latent statistics when cfg says so. width: x is
    that shard's slice of the width (its latents' slice comes back)."""
    p = params["encoder"]
    h = causal_conv3d(x, p["conv_in"]["kernel"], p["conv_in"]["bias"], width=width)
    for st in p["stages"]:
        for rp in st["res"]:
            h = _res_block(rp, h, width)
        if "down" in st:
            h = _downsample(st["down"], h, temporal="time_conv" in st["down"], width=width)
    h = _res_block(p["mid"]["res1"], h, width)
    h = _attn_block(p["mid"]["attn"], h, width)
    h = _res_block(p["mid"]["res2"], h, width)
    h = channel_rms_norm(h, p["norm_out"]["gamma"])
    h = causal_conv3d(F.silu(h), p["conv_out"]["kernel"], p["conv_out"]["bias"], width=width)
    h = causal_conv3d(h, p["quant_conv"]["kernel"], p["quant_conv"]["bias"])
    mean = h[:, : h.shape[1] // 2]
    if cfg.use_latent_stats:
        mean = (mean - _stat(WAN21_LATENT_MEAN, mean)) / _stat(WAN21_LATENT_STD, mean)
    return mean


@torch.no_grad()
def vae_decode(params: Params, cfg: VAEConfig, z: torch.Tensor, width=None) -> torch.Tensor:
    """latents [B, z, T', H', W'] -> video [B, 3, 4*(T'-1)+1, 8H', 8W']
    (linear output head; the pipeline maps it to [0, 1]). width: z is that
    shard's slice of the width (its frames' slice comes back)."""
    p = params["decoder"]
    if cfg.use_latent_stats:
        z = z * _stat(WAN21_LATENT_STD, z) + _stat(WAN21_LATENT_MEAN, z)
    h = causal_conv3d(z, p["post_quant_conv"]["kernel"], p["post_quant_conv"]["bias"])
    h = causal_conv3d(h, p["conv_in"]["kernel"], p["conv_in"]["bias"], width=width)
    h = _res_block(p["mid"]["res1"], h, width)
    h = _attn_block(p["mid"]["attn"], h, width)
    h = _res_block(p["mid"]["res2"], h, width)
    for st in p["stages"]:
        for rp in st["res"]:
            h = _res_block(rp, h, width)
        if "up" in st:
            h = _upsample(st["up"], h, temporal="time_conv" in st["up"], width=width)
    h = channel_rms_norm(h, p["norm_out"]["gamma"])
    return causal_conv3d(F.silu(h), p["conv_out"]["kernel"], p["conv_out"]["bias"],
                         width=width)


def latent_frames(num_frames: int, cfg: VAEConfig = VAEConfig()) -> int:
    return (num_frames - 1) // cfg.temporal_compression_ratio + 1
