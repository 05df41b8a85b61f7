"""Generic pre-norm ViT encoder (the port's counterpart of
``versecrafter_tpu.perception.vit``): the patch embedding as a matmul,
learned position embeddings resized as jax.image.resize "bilinear" does
(antialiased when the grid shrinks), MHSA + tanh-GELU MLP blocks, and taps
of intermediate layers for DPT-style heads. The blocks are a list of
per-block dicts (the JAX tree stacks them on a leading axis;
core.convert.params_from_jax unstacks them)."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch

from versecrafter_tpu_torch.kernels.norms import layer_norm
import torch.nn.functional as F

from versecrafter_tpu_torch.perception._ops import (
    attention, lin, normal, ones, resize_bilinear, zeros)

Params = Dict[str, Any]


def _dense(gen, cin, cout, dtype):
    return {"kernel": normal(gen, (cin, cout), (2.0 / (cin + cout)) ** 0.5, dtype),
            "bias": zeros((cout,), dtype, gen)}


def _ln_p(dim, gen):
    return {"scale": ones((dim,), torch.float32, gen), "bias": zeros((dim,), torch.float32, gen)}


def init_vit(generator: torch.Generator, *, patch: int = 14, dim: int = 1024,
             depth: int = 24, heads: int = 16, mlp_ratio: float = 4.0, in_ch: int = 3,
             num_registers: int = 0, dtype=torch.float32) -> Params:
    """Random init from `generator` on its device: the JAX init's tree
    (blocks as a list), shapes, dtypes and scales."""
    g = generator
    mlp = int(dim * mlp_ratio)
    return {
        "patch_embed": _dense(g, in_ch * patch * patch, dim, dtype),
        "cls_token": zeros((1, 1 + num_registers, dim), dtype, g),
        "pos_embed": normal(g, (1, 1 + 37 * 37, dim), 0.02, dtype),
        "blocks": [{
            "norm1": _ln_p(dim, g),
            "qkv": _dense(g, dim, 3 * dim, dtype),
            "proj": _dense(g, dim, dim, dtype),
            "norm2": _ln_p(dim, g),
            "fc1": _dense(g, dim, mlp, dtype),
            "fc2": _dense(g, mlp, dim, dtype),
        } for _ in range(depth)],
        "norm": _ln_p(dim, g),
    }


def _mhsa(p, x, heads):
    qkv = lin(p["qkv"], x, "kernel")
    q, k, v = qkv.chunk(3, dim=-1)
    return lin(p["proj"], attention(q, k, v, heads), "kernel")


def _interp_pos(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """The grid part of the position embeddings resized to (gh, gw) as
    jax.image.resize "bilinear" does; the cls row kept."""
    side = int(math.sqrt(pos.shape[1] - 1))
    cls, grid = pos[:, :1], pos[:, 1:].reshape(1, side, side, -1)
    grid = resize_bilinear(grid, gh, gw)
    return torch.cat([cls, grid.reshape(1, gh * gw, -1)], 1)


@torch.no_grad()
def vit_forward(params: Params, x: torch.Tensor, *, patch: int = 14, heads: int = 16,
                out_layers: Optional[Sequence[int]] = None):
    """x [B, H, W, 3] -> final tokens [B, 1+N, D]; with out_layers, also the
    post-block tokens of those layers."""
    b, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    xp = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 5, 2, 4)
    xp = xp.reshape(b, gh * gw, c * patch * patch)
    tok = lin(params["patch_embed"], xp, "kernel")
    cls = params["cls_token"].to(tok.dtype).expand(b, params["cls_token"].shape[1], -1)
    tok = torch.cat([cls, tok], 1)
    pos = _interp_pos(params["pos_embed"], gh, gw).to(tok.dtype)
    npos = min(pos.shape[1], tok.shape[1])
    if tok.shape[1] != pos.shape[1]:
        tok = torch.cat([tok[:, :npos] + pos[:, :npos], tok[:, npos:]], 1)
    else:
        tok = tok + pos

    want = set(out_layers or [])
    tapped = {}
    for i, bp in enumerate(params["blocks"]):
        hln = layer_norm(tok, bp["norm1"]["scale"], bp["norm1"]["bias"])
        tok = tok + _mhsa(bp, hln, heads)
        hln = layer_norm(tok, bp["norm2"]["scale"], bp["norm2"]["bias"])
        tok = tok + lin(bp["fc2"], F.gelu(lin(bp["fc1"], hln, "kernel"), approximate="tanh"),
                       "kernel")  # jax.nn.gelu's default, the tanh form
        if i in want:
            tapped[i] = tok
    tok = layer_norm(tok, params["norm"]["scale"], params["norm"]["bias"])
    if out_layers is not None:
        return tok, [tapped[i] for i in out_layers]
    return tok
