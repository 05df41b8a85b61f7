"""DINOv2 ViT backbone (the port's counterpart of
``versecrafter_tpu.perception.dinov2``), the image backbone of MoGe for
converted weights: 14x14 patch embedding, cls token, position embeddings
resized by bicubic matrices (F.interpolate's, align_corners=False), pre-norm
blocks with LayerScale on both residual branches, final LayerNorm.
Converters from the HuggingFace Dinov2Model and the original
facebookresearch layouts give the JAX converters' trees."""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from versecrafter_tpu_torch.perception._ops import attention, lin, ln, normal, ones, zeros

Params = Dict[str, Any]

VIT_L14 = dict(hidden=1024, depth=24, heads=16, patch=14, mlp_ratio=4)
TEST_TINY = dict(hidden=32, depth=2, heads=2, patch=14, mlp_ratio=2)


@lru_cache(maxsize=64)
def _bicubic_weights(n_out: int, n_in: int, a: float = -0.75) -> np.ndarray:
    """Torch F.interpolate(mode='bicubic', align_corners=False,
    antialias=False) as an [n_out, n_in] float32 matrix: half-pixel
    coordinate map, cubic-convolution kernel A=-0.75, index clamping at the
    borders."""
    w = np.zeros((n_out, n_in), np.float64)
    scale = n_in / n_out
    for o in range(n_out):
        x = (o + 0.5) * scale - 0.5
        i0 = math.floor(x)
        for k in range(-1, 3):
            t = abs(x - (i0 + k))
            if t <= 1.0:
                c = (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1
            elif t < 2.0:
                c = a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a
            else:
                c = 0.0
            w[o, min(max(i0 + k, 0), n_in - 1)] += c
    return w.astype(np.float32)


def _interp_pos(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    cls, grid = pos[:, :1], pos[:, 1:]
    side = int(math.sqrt(grid.shape[1]))
    if (gh, gw) == (side, side):
        return pos
    grid = grid.reshape(1, side, side, -1).float()
    wh = torch.from_numpy(_bicubic_weights(gh, side)).to(grid.device)
    ww = torch.from_numpy(_bicubic_weights(gw, side)).to(grid.device)
    grid = torch.einsum("oh,bhwc->bowc", wh, grid)
    grid = torch.einsum("ow,bhwc->bhoc", ww, grid)
    return torch.cat([cls.float(), grid.reshape(1, gh * gw, -1)], 1).to(pos.dtype)


@torch.no_grad()
def dinov2_forward(params: Params, cfg: dict, pixels: torch.Tensor,
                   out_layers: Optional[Sequence[int]] = None, norm_taps: bool = False):
    """pixels [B, 3, H, W] (normalized) -> final tokens [B, 1+N, D]; with
    out_layers also the tapped per-layer tokens (norm_taps applies the final
    LayerNorm to each, dinov2 get_intermediate_layers(norm=True))."""
    b, _, H, W = pixels.shape
    ps = cfg["patch"]
    x = pixels.permute(0, 2, 3, 1)
    x = x.reshape(b, H // ps, ps, W // ps, ps, 3).permute(0, 1, 3, 5, 2, 4)
    x = lin(params["patch_embed"], x.reshape(b, (H // ps) * (W // ps), 3 * ps * ps))
    cls = params["cls_token"].to(x.dtype).expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], 1)
    x = x + _interp_pos(params["pos_embed"], H // ps, W // ps).to(x.dtype)

    heads = cfg["heads"]
    want = set(out_layers or [])
    tapped = {}
    for i, blk in enumerate(params["layers"]):
        h = ln(x, blk["norm1"])
        o = attention(lin(blk["q"], h), lin(blk["k"], h), lin(blk["v"], h), heads)
        x = x + blk["ls1"].to(x.dtype) * lin(blk["proj"], o)
        h = lin(blk["fc2"], F.gelu(lin(blk["fc1"], ln(x, blk["norm2"]))))
        x = x + blk["ls2"].to(x.dtype) * h
        if i in want:
            tapped[i] = x
    x = ln(x, params["norm"])
    if out_layers is not None:
        taps = [tapped[i] for i in out_layers]
        if norm_taps:
            taps = [ln(t, params["norm"]) for t in taps]
        return x, taps
    return x


def _getter(state_dict, prefix=""):
    def g(name):
        t = state_dict[prefix + name]
        return torch.as_tensor(np.asarray(t.detach().cpu().float().numpy()
                                          if hasattr(t, "detach") else t))
    return g


def convert_hf_dinov2(state_dict, cfg: dict, dtype=torch.float32) -> Params:
    """A HuggingFace Dinov2Model state dict -> the JAX converter's tree."""
    g = _getter(state_dict)

    def linp(prefix):
        return {"weight": g(f"{prefix}.weight").T.contiguous().to(dtype),
                "bias": g(f"{prefix}.bias").to(dtype)}

    def lnp(prefix):
        return {"weight": g(f"{prefix}.weight"), "bias": g(f"{prefix}.bias")}

    pw = g("embeddings.patch_embeddings.projection.weight")  # [D, 3, ps, ps]
    params: Params = {
        "patch_embed": {"weight": pw.reshape(pw.shape[0], -1).T.contiguous().to(dtype),
                        "bias": g("embeddings.patch_embeddings.projection.bias").to(dtype)},
        "cls_token": g("embeddings.cls_token").to(dtype)[0],
        "pos_embed": g("embeddings.position_embeddings").to(dtype),
        "norm": lnp("layernorm"),
        "layers": [],
    }
    i = 0
    while f"encoder.layer.{i}.norm1.weight" in state_dict:
        pre = f"encoder.layer.{i}"
        params["layers"].append({
            "norm1": lnp(f"{pre}.norm1"),
            "q": linp(f"{pre}.attention.attention.query"),
            "k": linp(f"{pre}.attention.attention.key"),
            "v": linp(f"{pre}.attention.attention.value"),
            "proj": linp(f"{pre}.attention.output.dense"),
            "ls1": g(f"{pre}.layer_scale1.lambda1").to(dtype),
            "norm2": lnp(f"{pre}.norm2"),
            "fc1": linp(f"{pre}.mlp.fc1"),
            "fc2": linp(f"{pre}.mlp.fc2"),
            "ls2": g(f"{pre}.layer_scale2.lambda1").to(dtype),
        })
        i += 1
    return params


def convert_fb_dinov2(state_dict, prefix: str = "", dtype=torch.float32) -> Params:
    """An original facebookresearch/dinov2 state dict (the layout inside
    MoGe checkpoints under `backbone.*`: fused attn.qkv, ls1.gamma,
    patch_embed.proj) -> the same tree."""
    g = _getter(state_dict, prefix)

    def lnp(name):
        return {"weight": g(f"{name}.weight"), "bias": g(f"{name}.bias")}

    def linp(name):
        return {"weight": g(f"{name}.weight").T.contiguous().to(dtype),
                "bias": g(f"{name}.bias").to(dtype)}

    pw = g("patch_embed.proj.weight")
    d = pw.shape[0]
    params: Params = {
        "patch_embed": {"weight": pw.reshape(d, -1).T.contiguous().to(dtype),
                        "bias": g("patch_embed.proj.bias").to(dtype)},
        "cls_token": g("cls_token").to(dtype)[0],
        "pos_embed": g("pos_embed").to(dtype),
        "norm": lnp("norm"),
        "layers": [],
    }
    i = 0
    while prefix + f"blocks.{i}.norm1.weight" in state_dict:
        pre = f"blocks.{i}"
        qw, kw, vw = g(f"{pre}.attn.qkv.weight").chunk(3, 0)
        qb, kb, vb = g(f"{pre}.attn.qkv.bias").chunk(3, 0)
        params["layers"].append({
            "norm1": lnp(f"{pre}.norm1"),
            "q": {"weight": qw.T.contiguous().to(dtype), "bias": qb.contiguous().to(dtype)},
            "k": {"weight": kw.T.contiguous().to(dtype), "bias": kb.contiguous().to(dtype)},
            "v": {"weight": vw.T.contiguous().to(dtype), "bias": vb.contiguous().to(dtype)},
            "proj": linp(f"{pre}.attn.proj"),
            "ls1": g(f"{pre}.ls1.gamma").to(dtype),
            "norm2": lnp(f"{pre}.norm2"),
            "fc1": linp(f"{pre}.mlp.fc1"),
            "fc2": linp(f"{pre}.mlp.fc2"),
            "ls2": g(f"{pre}.ls2.gamma").to(dtype),
        })
        i += 1
    return params


def init_dinov2(generator: torch.Generator, cfg: dict, dtype=torch.float32) -> Params:
    """Random init from `generator` on its device with the converted tree's
    structure, shapes, dtypes and scales."""
    gen = generator
    d, ps = cfg["hidden"], cfg["patch"]
    mlp = int(d * cfg.get("mlp_ratio", 4))

    def dense(cin, cout):
        return {"weight": normal(gen, (cin, cout), (2.0 / (cin + cout)) ** 0.5, dtype),
                "bias": zeros((cout,), dtype, gen)}

    def lnp():
        return {"weight": ones((d,), torch.float32, gen), "bias": zeros((d,), torch.float32, gen)}

    return {
        "patch_embed": dense(3 * ps * ps, d),
        "cls_token": normal(gen, (1, d), 0.02, dtype),
        "pos_embed": normal(gen, (1, 1 + 16 * 16, d), 0.02, dtype),
        "norm": lnp(),
        "layers": [{
            "norm1": lnp(), "q": dense(d, d), "k": dense(d, d), "v": dense(d, d),
            "proj": dense(d, d), "ls1": torch.full((d,), 1e-5, dtype=dtype, device=gen.device),
            "norm2": lnp(), "fc1": dense(d, mlp), "fc2": dense(mlp, d),
            "ls2": torch.full((d,), 1e-5, dtype=dtype, device=gen.device),
        } for _ in range(cfg["depth"])],
    }
