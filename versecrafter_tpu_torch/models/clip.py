"""CLIP ViT vision tower for i2v conditioning (the port's counterpart of
``versecrafter_tpu.models.clip``).

A pre-norm CLIP ViT: the patch conv as a matmul, a class token, learned
positions, QuickGELU MLP blocks and a final LayerNorm over all tokens
(cls + patches: 257 at ViT-H/14, 224 px). The attention is the JAX
module's einsum -> fp32 softmax -> einsum in the token dtype, at the same
rounding points; no kernel of the port is involved. `encode_image` resizes
with `utils/imgproc.resize_linear`, a numpy copy of OpenCV's bilinear
`cv2.resize` (the GPU machine has no OpenCV), so the tower runs in fp32 on
the same pixels in both packages.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from versecrafter_tpu_torch.kernels.norms import layer_norm
from versecrafter_tpu_torch.utils.imgproc import resize_linear

Params = Dict[str, Any]

VIT_HUGE_14 = dict(patch=14, dim=1280, depth=32, heads=16, img_size=224)
TEST_TINY = dict(patch=14, dim=32, depth=2, heads=2, img_size=56)

# CLIP normalization constants
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _normal(gen, shape, std, dtype, device):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return (t.normal_(generator=gen) * std).to(dtype)


def _dense(gen, cin, cout, dtype, device):
    return {"kernel": _normal(gen, (cin, cout), (2.0 / (cin + cout)) ** 0.5, dtype, device),
            "bias": torch.zeros((cout,), dtype=dtype, device=device)}


def _mk_ln(dim, device):
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device),
            "bias": torch.zeros((dim,), dtype=torch.float32, device=device)}


def init_clip_vision(cfg: dict, generator: torch.Generator,
                     dtype=torch.float32) -> Params:
    """Random init from `generator` on its device: the JAX init's tree,
    shapes, dtypes and scales."""
    g, dev = generator, generator.device
    d = cfg["dim"]
    n_tok = (cfg["img_size"] // cfg["patch"]) ** 2 + 1
    return {
        "patch_embed": {"kernel": _normal(g, (3 * cfg["patch"] ** 2, d), d ** -0.5,
                                          dtype, dev)},
        "cls": _normal(g, (1, 1, d), 0.02, dtype, dev),
        "pos": _normal(g, (1, n_tok, d), 0.02, dtype, dev),
        "pre_norm": _mk_ln(d, dev),
        "blocks": [{
            "norm1": _mk_ln(d, dev),
            "attn": {k: _dense(g, d, d, dtype, dev) for k in "qkvo"},
            "norm2": _mk_ln(d, dev),
            "fc1": _dense(g, d, 4 * d, dtype, dev),
            "fc2": _dense(g, 4 * d, d, dtype, dev),
        } for _ in range(cfg["depth"])],
        "post_norm": _mk_ln(d, dev),
    }


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _dense_fwd(p, x):
    return torch.matmul(x, p["kernel"].to(x.dtype)) + p["bias"].to(x.dtype)


@torch.no_grad()
def clip_vision_forward(params: Params, cfg: dict, image: torch.Tensor) -> torch.Tensor:
    """image [B, H, W, 3] CLIP-normalized -> tokens [B, 1 + N, D], cls
    first, in the image's dtype (weights cast to it). cfg["post_norm"]
    (default True) applies the final LayerNorm to every token; cfg["ln_eps"]
    defaults to 1e-5."""
    eps = cfg.get("ln_eps", 1e-5)
    b, h, w, _ = image.shape
    p = cfg["patch"]
    x = image.reshape(b, h // p, p, w // p, p, 3).permute(0, 1, 3, 5, 2, 4)
    x = x.reshape(b, (h // p) * (w // p), 3 * p * p)
    tok = torch.matmul(x, params["patch_embed"]["kernel"].to(x.dtype))
    cls = params["cls"].to(tok.dtype).expand(b, 1, tok.shape[-1])
    tok = torch.cat([cls, tok], 1)
    tok = tok + params["pos"][:, :tok.shape[1]].to(tok.dtype)
    tok = layer_norm(tok, params["pre_norm"]["scale"], params["pre_norm"]["bias"], eps=eps)

    heads = cfg["heads"]
    d = tok.shape[-1]
    hd = d // heads
    for blk in params["blocks"]:
        xn = layer_norm(tok, blk["norm1"]["scale"], blk["norm1"]["bias"], eps=eps)
        q, k, v = (_dense_fwd(blk["attn"][n], xn).reshape(b, -1, heads, hd).transpose(1, 2)
                   for n in "qkv")
        s = torch.einsum("bnqd,bnkd->bnqk", q, k) / math.sqrt(hd)
        a = F.softmax(s.float(), -1).to(tok.dtype)
        o = torch.einsum("bnqk,bnkd->bnqd", a, v).transpose(1, 2).reshape(b, -1, d)
        tok = tok + torch.matmul(o, blk["attn"]["o"]["kernel"].to(o.dtype)) \
            + blk["attn"]["o"]["bias"].to(o.dtype)
        xn = layer_norm(tok, blk["norm2"]["scale"], blk["norm2"]["bias"], eps=eps)
        tok = tok + _dense_fwd(blk["fc2"], _quick_gelu(_dense_fwd(blk["fc1"], xn)))
    if not cfg.get("post_norm", True):
        return tok
    return layer_norm(tok, params["post_norm"]["scale"], params["post_norm"]["bias"], eps=eps)


def encode_image(params: Params, cfg: dict, image: np.ndarray) -> torch.Tensor:
    """[H, W, 3] uint8 (0..255) or float (0..1) image -> clip_fea
    [1, 1 + N, D] fp32 on the params' device: resized to img_size square,
    scaled to 0..1 when its max is above 1.5, CLIP-normalized, then the
    tower in fp32."""
    s = cfg["img_size"]
    x = resize_linear(np.asarray(image), (s, s)).astype(np.float32)
    if x.max() > 1.5:
        x = x / 255.0
    x = (x - CLIP_MEAN) / CLIP_STD
    dev = params["patch_embed"]["kernel"].device
    return clip_vision_forward(params, cfg, torch.from_numpy(x)[None].to(dev))


# ---------------------------------------------------------------------------
# checkpoint conversion
# ---------------------------------------------------------------------------

def _f32(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().float()
    return torch.from_numpy(np.asarray(t, np.float32))


def convert_clip_vision(state_dict: Mapping, cfg: dict = None, dtype=torch.float32,
                        heads: int = None, device=None):
    """A CLIP vision tower's state dict -> (params, cfg), for the two public
    layouts, detected by their keys:

    - HuggingFace `CLIPVisionModel`: vision_model.embeddings.*,
      vision_model.encoder.layers.{i}.self_attn.{q,k,v,out}_proj /
      layer_norm1/2 / mlp.fc1/fc2, pre/post layernorm;
    - open-clip / torch MHA: visual.conv1, visual.class_embedding,
      visual.positional_embedding, visual.ln_pre/ln_post,
      visual.transformer.resblocks.{i}.ln_1/ln_2, attn.in_proj_* (packed
      qkv), attn.out_proj, mlp.c_fc/c_proj.

    Every leaf is read as fp32 and cast to `dtype` (norms stay fp32) on
    `device` (default the CPU), as the JAX converter does. The head count is
    not in the weights: the default table covers the standard towers
    (ViT-B 768 -> 12, ViT-L 1024 -> 16, ViT-H 1280 -> 16, ViT-G 1664 -> 16),
    else 64-wide heads; pass `heads=` for other widths."""
    device = torch.device("cpu") if device is None else torch.device(device)
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
    hf = any(k.startswith("vision_model.") for k in sd)

    def get(name):
        return _f32(sd[name]).to(device)

    if hf:
        conv = get("vision_model.embeddings.patch_embedding.weight")
        cls = get("vision_model.embeddings.class_embedding")
        pos = get("vision_model.embeddings.position_embedding.weight")
        pre = ("vision_model.pre_layrnorm" if "vision_model.pre_layrnorm.weight" in sd
               else "vision_model.pre_layernorm")
        post = "vision_model.post_layernorm"
        prefix = "vision_model.encoder.layers."
    else:
        conv = get("visual.conv1.weight")
        cls = get("visual.class_embedding")
        pos = get("visual.positional_embedding")
        pre, post = "visual.ln_pre", "visual.ln_post"
        prefix = "visual.transformer.resblocks."
    nblk = len({k.split(".")[3] for k in sd if k.startswith(prefix)})

    d, _, p, _ = conv.shape
    n_tok = pos.shape[0]
    img = int(round((n_tok - 1) ** 0.5)) * p
    default_heads = {768: 12, 1024: 16, 1280: 16, 1664: 16}.get(d, max(1, d // 64))
    cfg = cfg or dict(patch=p, dim=d, depth=nblk, heads=heads or default_heads,
                      img_size=img)

    def ln(name):
        return {"scale": get(name + ".weight"), "bias": get(name + ".bias")}

    def lin(wname, bname=None):
        out = {"kernel": get(wname).t().contiguous().to(dtype)}
        if bname and bname in sd:
            out["bias"] = get(bname).to(dtype)
        return out

    # conv [D, 3, p, p] -> [3*p*p, D] in (c, py, px) patch order
    params: Params = {
        "patch_embed": {"kernel": conv.reshape(d, 3 * p * p).t().contiguous().to(dtype)},
        "cls": cls.reshape(1, 1, d).to(dtype),
        "pos": pos.reshape(1, n_tok, d).to(dtype),
        "pre_norm": ln(pre),
        "post_norm": ln(post),
        "blocks": [],
    }
    for i in range(nblk):
        b = f"{prefix}{i}."
        if hf:
            attn = {n: lin(f"{b}self_attn.{m}_proj.weight", f"{b}self_attn.{m}_proj.bias")
                    for n, m in (("q", "q"), ("k", "k"), ("v", "v"), ("o", "out"))}
            blk = {"norm1": ln(b + "layer_norm1"), "norm2": ln(b + "layer_norm2"),
                   "attn": attn,
                   "fc1": lin(b + "mlp.fc1.weight", b + "mlp.fc1.bias"),
                   "fc2": lin(b + "mlp.fc2.weight", b + "mlp.fc2.bias")}
        else:
            w = get(b + "attn.in_proj_weight")  # [3D, D] packed
            bqkv = get(b + "attn.in_proj_bias")
            attn = {n: {"kernel": w[j * d:(j + 1) * d].t().contiguous().to(dtype),
                        "bias": bqkv[j * d:(j + 1) * d].to(dtype)}
                    for j, n in enumerate("qkv")}
            attn["o"] = lin(b + "attn.out_proj.weight", b + "attn.out_proj.bias")
            blk = {"norm1": ln(b + "ln_1"), "norm2": ln(b + "ln_2"), "attn": attn,
                   "fc1": lin(b + "mlp.c_fc.weight", b + "mlp.c_fc.bias"),
                   "fc2": lin(b + "mlp.c_proj.weight", b + "mlp.c_proj.bias")}
        params["blocks"].append(blk)
    return params, cfg
