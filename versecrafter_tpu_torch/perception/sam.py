"""SAM (ViT image encoder) promptable segmentation, the port's counterpart of
``versecrafter_tpu.perception.sam``: the neural segmenter's
`mask_backend="sam1"` for SAM-vit checkpoints (there is no fresh init, as
in the JAX package).

- the ViT encoder: 16x16 patch embedding, absolute position embedding,
  windowed attention with decomposed relative positions (global at the
  selected layers), the conv neck (1x1 -> channels-first LN -> 3x3 -> LN);
- the prompt encoder: random-Fourier PE shared with the image grid PE,
  per-type point embeddings, boxes as two labelled corners;
- the mask decoder: a two-way transformer, a 4x transposed-conv upscale,
  hypernetwork mask heads and the IoU head.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from versecrafter_tpu_torch.perception._ops import full_fp32, lin as _lin, ln as _ln

Params = Dict[str, Any]

VIT_B = dict(hidden_size=768, depth=12, heads=12, global_layers=(2, 5, 8, 11),
             window=14, patch=16, img_size=1024, out_ch=256, mlp_ratio=4.0)
VIT_H = dict(hidden_size=1280, depth=32, heads=16, global_layers=(7, 15, 23, 31),
             window=14, patch=16, img_size=1024, out_ch=256, mlp_ratio=4.0)
TEST_TINY = dict(hidden_size=32, depth=2, heads=2, global_layers=(1,),
                 window=2, patch=16, img_size=64, out_ch=32, mlp_ratio=2.0)


def _ln_cf(x, p, eps=1e-6):
    """Channels-first LayerNorm over dim 1 of NCHW (SamLayerNorm)."""
    xf = x.float()
    mu = xf.mean(1, keepdim=True)
    var = (xf - mu).square().mean(1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["weight"].float()[None, :, None, None]
            + p["bias"].float()[None, :, None, None]).to(x.dtype)


# ---------------------------------------------------------------------------
# vision encoder
# ---------------------------------------------------------------------------

def _rel_pos(size: int, table: torch.Tensor) -> torch.Tensor:
    """[2*size-1, hd] -> [size, size, hd] for equal q/k sizes."""
    idx = (np.arange(size)[:, None] - np.arange(size)[None, :]) + (size - 1)
    return table[torch.from_numpy(idx).to(table.device)]


def _vision_attn(p, x, heads: int):
    """x: [B, H, W, C] (a window or the whole grid)."""
    b, h, w, c = x.shape
    hd = c // heads
    qkv = _lin(p["qkv"], x.reshape(b, h * w, c))
    qkv = qkv.reshape(b, h * w, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = (t.reshape(b * heads, h * w, hd) for t in qkv)
    attn = torch.einsum("bqd,bkd->bqk", q * (hd ** -0.5), k)
    rh = _rel_pos(h, p["rel_pos_h"]).to(q.dtype)
    rw = _rel_pos(w, p["rel_pos_w"]).to(q.dtype)
    rq = q.reshape(b * heads, h, w, hd)
    rel_h = torch.einsum("bhwc,hkc->bhwk", rq, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", rq, rw)
    attn = attn.reshape(b * heads, h, w, h, w) + rel_h[:, :, :, :, None] \
        + rel_w[:, :, :, None, :]
    attn = F.softmax(attn.reshape(b * heads, h * w, h * w).float(), -1).to(x.dtype)
    o = torch.einsum("bqk,bkd->bqd", attn, v)
    o = o.reshape(b, heads, h, w, hd).permute(0, 2, 3, 1, 4).reshape(b, h, w, c)
    return _lin(p["proj"], o)


@torch.no_grad()
def vision_forward(params: Params, cfg: dict, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, H, W, 3] (ImageNet-normalized) -> embeddings [B, C, h, w]."""
    b, H, W, _ = pixels.shape
    ps = cfg["patch"]
    x = pixels.reshape(b, H // ps, ps, W // ps, ps, 3).permute(0, 1, 3, 5, 2, 4)
    x = _lin(params["patch_embed"], x.reshape(b, H // ps, W // ps, 3 * ps * ps))
    if "pos_embed" in params:
        x = x + params["pos_embed"].to(x.dtype)
    gh, gw = x.shape[1:3]
    win = cfg["window"]
    for i, blk in enumerate(params["layers"]):
        res = x
        h = _ln(x, blk["layer_norm1"])
        if i not in cfg["global_layers"] and win > 0:
            pad_h, pad_w = (win - gh % win) % win, (win - gw % win) % win
            hp = F.pad(h, (0, 0, 0, pad_w, 0, pad_h))
            ph, pw = gh + pad_h, gw + pad_w
            hw = hp.reshape(b, ph // win, win, pw // win, win, -1)
            hw = hw.permute(0, 1, 3, 2, 4, 5).reshape(-1, win, win, hp.shape[-1])
            hw = _vision_attn(blk["attn"], hw, cfg["heads"])
            hw = hw.reshape(b, ph // win, pw // win, win, win, -1)
            h = hw.permute(0, 1, 3, 2, 4, 5).reshape(b, ph, pw, -1)[:, :gh, :gw]
        else:
            h = _vision_attn(blk["attn"], h, cfg["heads"])
        x = res + h
        x = x + _lin(blk["mlp"]["lin2"],
                     F.gelu(_lin(blk["mlp"]["lin1"], _ln(x, blk["layer_norm2"]))))
    x = x.permute(0, 3, 1, 2)
    x = _ln_cf(F.conv2d(x, params["neck"]["conv1"].to(x.dtype)), params["neck"]["layer_norm1"])
    x = F.conv2d(x, params["neck"]["conv2"].to(x.dtype), padding=1)
    return _ln_cf(x, params["neck"]["layer_norm2"])


# ---------------------------------------------------------------------------
# prompt encoder
# ---------------------------------------------------------------------------

def _fourier_pe(pe_table: torch.Tensor, coords01: torch.Tensor) -> torch.Tensor:
    proj = 2 * math.pi * ((2.0 * coords01 - 1.0).float() @ pe_table.float())
    return torch.cat([torch.sin(proj), torch.cos(proj)], -1)


def encode_prompts(params: Params, cfg: dict, boxes: Optional[torch.Tensor] = None,
                   points: Optional[torch.Tensor] = None,
                   labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """boxes [B, Q, 4] xyxy pixels; points [B, Q, P, 2] + labels [B, Q, P]
    -> sparse tokens [B, Q, T, C] (+0.5 pixel shift, a padding point of
    label -1 without boxes, per-type embeddings, not-a-point for -1)."""
    size = cfg["img_size"]
    pe = params["shared_pe"]
    toks = []
    if points is not None:
        pts = points + 0.5
        if boxes is None:
            pts = torch.cat([pts, torch.zeros((*pts.shape[:2], 1, 2), dtype=pts.dtype,
                                              device=pts.device)], 2)
            labels = torch.cat([labels, -torch.ones((*pts.shape[:2], 1), dtype=labels.dtype,
                                                     device=labels.device)], 2)
        emb = _fourier_pe(pe, pts / size)
        lab = labels[..., None]
        emb = torch.where(lab == -1, params["not_a_point"].to(emb.dtype), emb)
        emb = torch.where(lab == 0, emb + params["point_embed"][0].to(emb.dtype), emb)
        emb = torch.where(lab == 1, emb + params["point_embed"][1].to(emb.dtype), emb)
        toks.append(emb)
    if boxes is not None:
        emb = _fourier_pe(pe, (boxes + 0.5).reshape(*boxes.shape[:2], 2, 2) / size)
        toks.append(emb + torch.stack([params["point_embed"][2],
                                       params["point_embed"][3]]).to(emb.dtype))
    return torch.cat(toks, 2)


def image_grid_pe(params: Params, h: int, w: int) -> torch.Tensor:
    """get_image_wide_positional_embeddings: [1, C, h, w]."""
    dev = params["shared_pe"].device
    y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    grid = torch.stack(torch.meshgrid(x, y, indexing="xy"), -1)
    return _fourier_pe(params["shared_pe"], grid).permute(2, 0, 1)[None]


# ---------------------------------------------------------------------------
# mask decoder
# ---------------------------------------------------------------------------

def _attn(p, q, k, v, heads: int):
    """SamAttention over [B*, T, C] with the projected internal width."""
    qp, kp, vp = _lin(p["q_proj"], q), _lin(p["k_proj"], k), _lin(p["v_proj"], v)
    b, nq, ci = qp.shape
    hd = ci // heads

    def split(t):
        return t.reshape(b, -1, heads, hd).transpose(1, 2)
    s = torch.einsum("bnqd,bnkd->bnqk", split(qp), split(kp)) * (hd ** -0.5)
    a = F.softmax(s.float(), -1).to(q.dtype)
    o = torch.einsum("bnqk,bnkd->bnqd", a, split(vp)).transpose(1, 2).reshape(b, nq, ci)
    return _lin(p["out_proj"], o)


def _ffw(p, x, depth: int):
    h = torch.relu(_lin(p["proj_in"], x))
    for i in range(depth - 2):
        h = torch.relu(_lin(p["layers"][i], h))
    return _lin(p["proj_out"], h)


def _conv_transpose2x2_nchw(p, x):
    """ConvTranspose2d(2, stride 2) of NCHW with a torch [I, O, 2, 2]
    kernel (each pixel its own 2x2 block)."""
    w = p["weight"].to(x.dtype)
    b, _, h, ww = x.shape
    y = torch.einsum("bihw,ioac->bohawc", x, w).reshape(b, w.shape[1], h * 2, ww * 2)
    return y + p["bias"].to(y.dtype)[None, :, None, None]


@torch.no_grad()
def decode_masks(params: Params, cfg: dict, image_embed: torch.Tensor,
                 sparse: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """image_embed [B, C, h, w]; sparse [B, Q, T, C] -> (masks
    [B, Q, n_masks, 4h, 4w], iou [B, Q, n_masks])."""
    dec = params["decoder"]
    B, C, h, w = image_embed.shape
    Q = sparse.shape[1]
    heads = dec["_heads"]
    n_mask = dec["mask_tokens"].shape[0]
    with full_fp32():
        out_tok = torch.cat([dec["iou_token"], dec["mask_tokens"]], 0)
        tokens = out_tok[None, None].expand(B, Q, *out_tok.shape).to(sparse.dtype)
        tokens = torch.cat([tokens, sparse], 2)
        dense = params["no_mask_embed"].reshape(1, -1, 1, 1).to(image_embed.dtype)
        src = (image_embed + dense).repeat_interleave(Q, 0).reshape(B * Q, C, h * w)
        src = src.transpose(1, 2)
        img_pe = image_grid_pe(params, h, w).to(src.dtype).reshape(1, C, h * w).transpose(1, 2)
        img_pe = img_pe.expand_as(src)
        q = tokens.reshape(B * Q, -1, C)
        qpe = q
        for i, ly in enumerate(dec["layers"]):
            if i == 0:
                q = q + _attn(ly["self_attn"], q, q, q, heads)
            else:
                qq = q + qpe
                q = q + _attn(ly["self_attn"], qq, qq, q, heads)
            q = _ln(q, ly["layer_norm1"])
            q = q + _attn(ly["cross_attn_token_to_image"], q + qpe, src + img_pe, src, heads)
            q = _ln(q, ly["layer_norm2"])
            q = q + _lin(ly["mlp"]["lin2"], torch.relu(_lin(ly["mlp"]["lin1"], q)))
            q = _ln(q, ly["layer_norm3"])
            src = src + _attn(ly["cross_attn_image_to_token"], src + img_pe, q + qpe, q, heads)
            src = _ln(src, ly["layer_norm4"])
        q = q + _attn(dec["final_attn"], q + qpe, src + img_pe, src, heads)
        q = _ln(q, dec["layer_norm_final"])

        iou_tok, mask_toks = q[:, 0], q[:, 1:1 + n_mask]
        up = _conv_transpose2x2_nchw(dec["upscale_conv1"], src.transpose(1, 2).reshape(
            B * Q, C, h, w))
        up = F.gelu(_ln_cf(up, dec["upscale_layer_norm"]))
        up = F.gelu(_conv_transpose2x2_nchw(dec["upscale_conv2"], up))
        hyper = torch.stack([_ffw(dec["hyper"][i], mask_toks[:, i], 3)
                             for i in range(n_mask)], 1)
        masks = torch.einsum("bmc,bchw->bmhw", hyper, up)
        iou = _ffw(dec["iou_head"], iou_tok, dec["_iou_depth"])
    return masks.reshape(B, Q, n_mask, 4 * h, 4 * w), iou.reshape(B, Q, n_mask)


def predict_boxes(params: Params, cfg: dict, pixels: torch.Tensor, boxes: torch.Tensor,
                  multimask_output: bool = True):
    """sam2.predict_boxes's contract (token 0 the single-mask output, 1..3
    the multimask ones); returns (masks, iou, None): SAM1 has no
    object-score head."""
    with full_fp32():
        embeds = vision_forward(params, cfg, pixels)
    masks, iou = decode_masks(params, cfg, embeds, encode_prompts(params, cfg, boxes=boxes))
    if multimask_output:
        return masks[:, :, 1:], iou[:, :, 1:], None
    return masks[:, :, :1], iou[:, :, :1], None


# ---------------------------------------------------------------------------
# HF conversion
# ---------------------------------------------------------------------------

def convert_hf_sam(state_dict, cfg: dict, dtype=torch.float32, decoder_heads: int = 8) -> Params:
    """A HuggingFace SamModel state dict -> the JAX converter's tree."""
    def g(name):
        t = state_dict[name]
        return torch.as_tensor(np.asarray(t.detach().cpu().float().numpy()
                                          if hasattr(t, "detach") else t))

    def lin(prefix):
        return {"weight": g(f"{prefix}.weight").T.contiguous().to(dtype),
                "bias": g(f"{prefix}.bias").to(dtype)}

    def lnp(prefix):
        return {"weight": g(f"{prefix}.weight"), "bias": g(f"{prefix}.bias")}

    pw = g("vision_encoder.patch_embed.projection.weight")
    params: Params = {
        "patch_embed": {"weight": pw.reshape(pw.shape[0], -1).T.contiguous().to(dtype),
                        "bias": g("vision_encoder.patch_embed.projection.bias").to(dtype)},
        "layers": [],
        "neck": {
            "conv1": g("vision_encoder.neck.conv1.weight").to(dtype),
            "layer_norm1": lnp("vision_encoder.neck.layer_norm1"),
            "conv2": g("vision_encoder.neck.conv2.weight").to(dtype),
            "layer_norm2": lnp("vision_encoder.neck.layer_norm2"),
        },
        "shared_pe": g("shared_image_embedding.positional_embedding"),
        "point_embed": torch.stack([g(f"prompt_encoder.point_embed.{i}.weight")[0]
                                    for i in range(4)]).to(dtype),
        "not_a_point": g("prompt_encoder.not_a_point_embed.weight")[0].to(dtype),
        "no_mask_embed": g("prompt_encoder.no_mask_embed.weight")[0].to(dtype),
    }
    if "vision_encoder.pos_embed" in state_dict:
        params["pos_embed"] = g("vision_encoder.pos_embed").to(dtype)
    for i in range(cfg["depth"]):
        pre = f"vision_encoder.layers.{i}"
        params["layers"].append({
            "layer_norm1": lnp(f"{pre}.layer_norm1"),
            "layer_norm2": lnp(f"{pre}.layer_norm2"),
            "attn": {"qkv": lin(f"{pre}.attn.qkv"), "proj": lin(f"{pre}.attn.proj"),
                     "rel_pos_h": g(f"{pre}.attn.rel_pos_h").to(dtype),
                     "rel_pos_w": g(f"{pre}.attn.rel_pos_w").to(dtype)},
            "mlp": {"lin1": lin(f"{pre}.mlp.lin1"), "lin2": lin(f"{pre}.mlp.lin2")},
        })

    def attn_p(prefix):
        return {k: lin(f"{prefix}.{k}") for k in ("q_proj", "k_proj", "v_proj", "out_proj")}

    md = "mask_decoder"
    iou_depth = 1
    while f"{md}.iou_prediction_head.layers.{iou_depth - 1}.weight" in state_dict:
        iou_depth += 1
    dec = {
        "iou_token": g(f"{md}.iou_token.weight").to(dtype),
        "mask_tokens": g(f"{md}.mask_tokens.weight").to(dtype),
        "layers": [],
        "final_attn": attn_p(f"{md}.transformer.final_attn_token_to_image"),
        "layer_norm_final": lnp(f"{md}.transformer.layer_norm_final_attn"),
        "upscale_conv1": {"weight": g(f"{md}.upscale_conv1.weight").to(dtype),
                          "bias": g(f"{md}.upscale_conv1.bias").to(dtype)},
        "upscale_conv2": {"weight": g(f"{md}.upscale_conv2.weight").to(dtype),
                          "bias": g(f"{md}.upscale_conv2.bias").to(dtype)},
        "upscale_layer_norm": lnp(f"{md}.upscale_layer_norm"),
        "hyper": [],
        "iou_head": {"proj_in": lin(f"{md}.iou_prediction_head.proj_in"),
                     "proj_out": lin(f"{md}.iou_prediction_head.proj_out"),
                     "layers": [lin(f"{md}.iou_prediction_head.layers.{j}")
                                for j in range(iou_depth - 1)]},
        "_heads": decoder_heads,
        "_iou_depth": iou_depth + 1,
    }
    for i in range(dec["mask_tokens"].shape[0]):
        pre = f"{md}.output_hypernetworks_mlps.{i}"
        dec["hyper"].append({"proj_in": lin(f"{pre}.proj_in"), "proj_out": lin(f"{pre}.proj_out"),
                             "layers": [lin(f"{pre}.layers.0")]})
    li = 0
    while f"{md}.transformer.layers.{li}.layer_norm1.weight" in state_dict:
        pre = f"{md}.transformer.layers.{li}"
        dec["layers"].append({
            "self_attn": attn_p(f"{pre}.self_attn"),
            "layer_norm1": lnp(f"{pre}.layer_norm1"),
            "cross_attn_token_to_image": attn_p(f"{pre}.cross_attn_token_to_image"),
            "layer_norm2": lnp(f"{pre}.layer_norm2"),
            "mlp": {"lin1": lin(f"{pre}.mlp.lin1"), "lin2": lin(f"{pre}.mlp.lin2")},
            "layer_norm3": lnp(f"{pre}.layer_norm3"),
            "cross_attn_image_to_token": attn_p(f"{pre}.cross_attn_image_to_token"),
            "layer_norm4": lnp(f"{pre}.layer_norm4"),
        })
        li += 1
    params["decoder"] = dec
    return params
