"""MoGe convolutional geometry head (the port's counterpart of
``versecrafter_tpu.perception.moge_head``): one 1x1 projection per backbone
tap, summed; per level a view-plane UV concat, ConvTranspose2d(2, 2) and a
replicate-padded 3x3 conv, then residual conv blocks (GroupNorm -> ReLU ->
conv3x3, twice, identity or 1x1 skip); an output block. NHWC activations,
torch-layout kernels (Conv2d [O, I, kh, kw], ConvTranspose2d [I, O, 2, 2])."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from versecrafter_tpu_torch.perception._ops import (
    conv, conv_transpose2x2 as _ct2, normal, ones, zeros)

Params = Dict[str, Any]


def normalized_view_plane_uv(h: int, w: int, aspect: Optional[float] = None) -> np.ndarray:
    """UV map [h, w, 2] on the unit-diagonal view plane at pixel centres
    (MoGe geometry_torch.normalized_view_plane_uv)."""
    if aspect is None:
        aspect = w / h
    span_x = aspect / (1.0 + aspect * aspect) ** 0.5
    span_y = 1.0 / (1.0 + aspect * aspect) ** 0.5
    u = np.linspace(-span_x * (w - 1) / w, span_x * (w - 1) / w, w, dtype=np.float32)
    v = np.linspace(-span_y * (h - 1) / h, span_y * (h - 1) / h, h, dtype=np.float32)
    uu, vv = np.meshgrid(u, v)
    return np.stack([uu, vv], axis=-1)


def conv2d(p: Params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Conv2d with replicate padding of kernel // 2, torch [O, I, kh, kw]
    kernel, NHWC activations."""
    return conv(p, x, stride, p["weight"].shape[2] // 2, "replicate")


def conv_transpose2x2(p: Params, x: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d(kernel=2, stride=2), torch weight [I, O, 2, 2]."""
    return _ct2(p, x)


def group_norm(p: Params, x: torch.Tensor, groups: int, eps: float = 1e-5) -> torch.Tensor:
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h, w, groups, c // groups)
    mu = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = (xf - mu).square().mean(dim=(1, 2, 4), keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (y * p["weight"].float() + p["bias"].float()).to(x.dtype)


def _gn_groups(channels: int) -> int:
    """The hidden norm of a residual block: 32-channel groups when they
    divide, else one group."""
    return channels // 32 if channels % 32 == 0 and channels >= 32 else 1


def residual_conv_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = conv2d(p["conv1"], torch.relu(group_norm(p["gn1"], x, groups=1)))
    h = torch.relu(group_norm(p["gn2"], h, groups=_gn_groups(h.shape[-1])))
    h = conv2d(p["conv2"], h)
    return h + (conv2d(p["skip"], x) if "skip" in p else x)


@torch.no_grad()
def head_forward(head: Params, feats: Sequence[torch.Tensor], gh: int, gw: int,
                 aspect: Optional[float] = None) -> torch.Tensor:
    """feats: per-tap patch tokens [B, gh*gw, D] (cls removed) ->
    [B, gh*8, gw*8, dim_out]."""
    b = feats[0].shape[0]
    if aspect is None:
        aspect = gw / gh
    x = None
    for proj, f in zip(head["projects"], feats):
        g = conv2d(proj, f.reshape(b, gh, gw, f.shape[-1]))
        x = g if x is None else x + g

    def cat_uv(x):
        uv = torch.from_numpy(normalized_view_plane_uv(x.shape[1], x.shape[2], aspect))
        uv = uv.to(x.device, x.dtype)[None].expand(b, -1, -1, -1)
        return torch.cat([x, uv], -1)

    for blk in head["upsample_blocks"]:
        x = conv2d(blk["up_conv"], conv_transpose2x2(blk["up_ct"], cat_uv(x)))
        for rb in blk["res_blocks"]:
            x = residual_conv_block(rb, x)
    ob = head["output_block"]
    x = conv2d(ob["conv_in"], cat_uv(x))
    for rb in ob["res_blocks"]:
        x = residual_conv_block(rb, x)
    return conv2d(ob["conv_out"], torch.relu(x))


def init_head(generator: torch.Generator, dim_in: int, num_features: int = 4,
              dim_out: int = 4, dim_proj: int = 512,
              dim_upsample: Tuple[int, ...] = (256, 128, 64), num_res_blocks: int = 2,
              last_res_blocks: int = 0, last_conv_channels: int = 32,
              last_conv_size: int = 1, dtype=torch.float32) -> Params:
    """Random init from `generator` on its device: the JAX init's tree and
    scales."""
    gen = generator

    def convp(cin, cout, k):
        return {"weight": normal(gen, (cout, cin, k, k), 1 / math.sqrt(cin * k * k), dtype),
                "bias": zeros((cout,), dtype, gen)}

    def ct(cin, cout):
        return {"weight": normal(gen, (cin, cout, 2, 2), 1 / math.sqrt(cin * 4), dtype),
                "bias": zeros((cout,), dtype, gen)}

    def gn(c):
        return {"weight": ones((c,), torch.float32, gen), "bias": zeros((c,), torch.float32, gen)}

    def res_block(cin, cout=None):
        cout = cout or cin
        p = {"gn1": gn(cin), "conv1": convp(cin, cin, 3), "gn2": gn(cin),
             "conv2": convp(cin, cout, 3)}
        if cin != cout:
            p["skip"] = convp(cin, cout, 1)
        return p

    ups: List[Params] = []
    chain = (dim_proj,) + tuple(dim_upsample)
    for cin, cout in zip(chain[:-1], chain[1:]):
        ups.append({"up_ct": ct(cin + 2, cout), "up_conv": convp(cout, cout, 3),
                    "res_blocks": [res_block(cout) for _ in range(num_res_blocks)]})
    return {
        "projects": [convp(dim_in, dim_proj, 1) for _ in range(num_features)],
        "upsample_blocks": ups,
        "output_block": {
            "conv_in": convp(dim_upsample[-1] + 2, last_conv_channels, 3),
            "res_blocks": [res_block(last_conv_channels) for _ in range(last_res_blocks)],
            "conv_out": convp(last_conv_channels, dim_out, last_conv_size),
        },
    }


def convert_head(state_dict, prefix: str = "head.", dtype=torch.float32) -> Params:
    """The torch MoGe Head state dict -> the JAX converter's tree; the
    counts of taps, levels and residual blocks come from the keys."""
    def g(name):
        t = state_dict[prefix + name]
        return torch.as_tensor(np.asarray(t.detach().cpu().float().numpy()
                                          if hasattr(t, "detach") else t)).to(dtype)

    def has(name):
        return prefix + name in state_dict

    def convp(name):
        return {"weight": g(f"{name}.weight"), "bias": g(f"{name}.bias")}

    def gn(name):
        return {"weight": g(f"{name}.weight").float(), "bias": g(f"{name}.bias").float()}

    def res_block(name):
        p = {"gn1": gn(f"{name}.layers.0"), "conv1": convp(f"{name}.layers.2"),
             "gn2": gn(f"{name}.layers.3"), "conv2": convp(f"{name}.layers.5")}
        if has(f"{name}.skip_connection.weight"):
            p["skip"] = convp(f"{name}.skip_connection")
        return p

    projects = []
    while has(f"projects.{len(projects)}.weight"):
        projects.append(convp(f"projects.{len(projects)}"))
    ups = []
    i = 0
    while has(f"upsample_blocks.{i}.0.0.weight"):
        blk = {"up_ct": convp(f"upsample_blocks.{i}.0.0"),
               "up_conv": convp(f"upsample_blocks.{i}.0.1"), "res_blocks": []}
        j = 1
        while has(f"upsample_blocks.{i}.{j}.layers.0.weight"):
            blk["res_blocks"].append(res_block(f"upsample_blocks.{i}.{j}"))
            j += 1
        ups.append(blk)
        i += 1
    out_idx = sorted({int(k[len(prefix) + len("output_block."):].split(".")[0])
                      for k in state_dict if k.startswith(prefix + "output_block.")})
    ob: Params = {"conv_in": convp("output_block.0"),
                  "res_blocks": [res_block(f"output_block.{j}") for j in out_idx[1:-1]],
                  "conv_out": convp(f"output_block.{out_idx[-1]}")}
    return {"projects": projects, "upsample_blocks": ups, "output_block": ob}
