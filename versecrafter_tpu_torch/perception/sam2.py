"""SAM 2.1 promptable segmentation with the Hiera encoder (the port's
counterpart of ``versecrafter_tpu.perception.sam2``), the box-prompted mask
model of the neural segmenter.

- HieraDet: a conv patch embedding (k7 s4 p3), the background position
  embedding resized by bicubic matrices plus the tiled window embedding,
  multi-scale blocks with fused qkv, per-stage windows, query max-pooling
  at stage boundaries (channels doubled through a skip `proj`), global
  attention at selected blocks;
- the FPN neck: 1x1 convs to fpn_hidden with nearest top-down fusion; the
  decoder's conv_s0 / conv_s1 pre-project the two finest levels;
- the prompt encoder: random-Fourier point PE shared with the image-wide
  grid PE, a 4-slot point-type embedding, boxes as two labelled corners and
  a padding corner;
- the mask decoder: [object-score | IoU | masks] tokens and the prompts
  through a two-way transformer, a 4x transposed-conv upscale with
  high-res skips, hypernetwork mask heads, the IoU and object-score heads
  and the stability-based single-mask choice.

NHWC activations, torch-layout conv kernels, linear kernels [in, out].
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from versecrafter_tpu_torch.perception._ops import (
    attention, conv as _conv, conv_transpose2x2 as _conv_transpose2x2, full_fp32,
    lin as _lin, ln, normal, ones, zeros)
from versecrafter_tpu_torch.perception.dinov2 import _bicubic_weights

Params = Dict[str, Any]

HIERA_TINY = dict(
    embed_dims=(96, 192, 384, 768), heads=(1, 2, 4, 8), blocks=(1, 2, 7, 2),
    window_sizes=(8, 4, 14, 7), global_blocks=(5, 7, 9), q_stride=2,
    q_pool_stages=3, window_pe_bg=(7, 7), patch_kernel=7, patch_stride=4,
    patch_pad=3, fpn_hidden=256, num_levels=3, fpn_top_down=(2, 3),
    image_size=1024, prompt_patch=16, dec_heads=8, dec_layers=2,
    dec_mlp=2048, dec_downsample=2, num_mask_tokens=4,
    stability_delta=0.05, stability_thresh=0.98)
HIERA_LARGE = dict(HIERA_TINY, embed_dims=(144, 288, 576, 1152),
                   heads=(2, 4, 8, 16), blocks=(2, 6, 36, 4),
                   window_sizes=(8, 4, 16, 8), global_blocks=(23, 33, 43))
TEST_TINY = dict(
    embed_dims=(16, 32, 64, 128), heads=(1, 2, 2, 4), blocks=(1, 1, 1, 1),
    window_sizes=(4, 4, 4, 4), global_blocks=(2,), q_stride=2,
    q_pool_stages=3, window_pe_bg=(7, 7), patch_kernel=7, patch_stride=4,
    patch_pad=3, fpn_hidden=32, num_levels=3, fpn_top_down=(2, 3),
    image_size=128, prompt_patch=16, dec_heads=2, dec_layers=2,
    dec_mlp=64, dec_downsample=2, num_mask_tokens=4,
    stability_delta=0.05, stability_thresh=0.98)


def _mlp(p, x, act):
    """Sam2FeedForward: proj_in -> act -> [layers -> act]* -> proj_out."""
    h = act(_lin(p["proj_in"], x))
    for layer in p.get("layers", []):
        h = act(_lin(layer, h))
    return _lin(p["proj_out"], h)


# ---------------------------------------------------------------------------
# HieraDet backbone
# ---------------------------------------------------------------------------

def _window_partition(x, ws):
    b, h, w, c = x.shape
    ph, pw = (-h) % ws, (-w) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def _window_unpartition(wins, ws, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = wins.shape[0] // ((hp // ws) * (wp // ws))
    x = wins.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def _max_pool2x2(x, stride):
    return F.max_pool2d(x.permute(0, 3, 1, 2), stride, stride).permute(0, 2, 3, 1)


def _block_layout(cfg) -> List[dict]:
    """Static per-block layout: (dim, dim_out, heads, window, q_stride)."""
    out = []
    total = 0
    for stage, nblocks in enumerate(cfg["blocks"]):
        for bi in range(nblocks):
            first = stage > 0 and bi == 0
            dim = cfg["embed_dims"][stage - 1] if first else cfg["embed_dims"][stage]
            window = cfg["window_sizes"][stage - 1] if first else cfg["window_sizes"][stage]
            if total in cfg["global_blocks"]:
                window = 0
            out.append(dict(
                dim=dim, dim_out=cfg["embed_dims"][stage], heads=cfg["heads"][stage],
                window=window,
                q_stride=cfg["q_stride"] if first and stage <= cfg["q_pool_stages"] else None,
                stage_end=(bi == nblocks - 1)))
            total += 1
    return out


@torch.no_grad()
def hiera_forward(params: Params, cfg: dict, pixels: torch.Tensor) -> List[torch.Tensor]:
    """pixels [B, H, W, 3] -> per-stage feature maps [B, h, w, C_stage]."""
    x = _conv(params["patch_embed"], pixels, stride=cfg["patch_stride"], pad=cfg["patch_pad"])
    b, h, w, c = x.shape
    pe = params["pos_embed"].float()  # [1, C, bh, bw]
    wh = torch.from_numpy(_bicubic_weights(h, pe.shape[2])).to(pe.device)
    wwm = torch.from_numpy(_bicubic_weights(w, pe.shape[3])).to(pe.device)
    pe = torch.einsum("oh,bchw->bcow", wh, pe)
    pe = torch.einsum("ow,bchw->bcho", wwm, pe)
    win = params["pos_embed_window"].float()
    pe = pe + win.repeat(1, 1, h // win.shape[2], w // win.shape[3])
    x = x + pe.permute(0, 2, 3, 1).to(x.dtype)

    stages: List[torch.Tensor] = []
    for bp, lo in zip(params["blocks"], _block_layout(cfg)):
        residual = x
        hcur, wcur = x.shape[1], x.shape[2]
        xn = ln(x, bp["norm1"])
        if lo["dim"] != lo["dim_out"]:
            residual = _lin(bp["proj"], xn)
            if lo["q_stride"]:
                residual = _max_pool2x2(residual, lo["q_stride"])
        ws = lo["window"]
        if ws > 0:
            xw, pad_hw = _window_partition(xn, ws)
        else:
            xw = xn
        bw, hw_, ww_, _ = xw.shape
        q, k, v = _lin(bp["qkv"], xw.reshape(bw, hw_ * ww_, -1)).chunk(3, -1)
        if lo["q_stride"]:
            q = _max_pool2x2(q.reshape(bw, hw_, ww_, -1), lo["q_stride"])
            hw_, ww_ = q.shape[1], q.shape[2]
            q = q.reshape(bw, hw_ * ww_, -1)
        o = _lin(bp["attn_proj"], attention(q, k, v, lo["heads"])).reshape(bw, hw_, ww_, -1)
        if lo["q_stride"]:
            hcur, wcur = residual.shape[1], residual.shape[2]
            if ws > 0:
                ws = ws // lo["q_stride"]
                pad_hw = (hcur + (-hcur) % ws, wcur + (-wcur) % ws)
        if lo["window"] > 0:
            o = _window_unpartition(o, ws, pad_hw, (hcur, wcur))
        x = residual + o
        x = x + _mlp(bp["mlp"], ln(x, bp["norm2"]), F.gelu)
        if lo["stage_end"]:
            stages.append(x)
    return stages


def neck_forward(params: Params, cfg: dict, stages: Sequence[torch.Tensor]
                 ) -> List[torch.Tensor]:
    """FPN: per-level 1x1 conv + nearest top-down at fpn_top_down levels;
    the finest `num_levels` maps, high-res first."""
    n = len(stages) - 1
    outs = []
    prev = None
    for i in range(n, -1, -1):
        lateral = _conv(params["convs"][n - i], stages[i])
        if i in cfg["fpn_top_down"] and i != n:
            up = prev.float().repeat_interleave(2, 1).repeat_interleave(2, 2)
            prev = lateral + up.to(lateral.dtype)
        else:
            prev = lateral
        outs.append(prev)
    return outs[-cfg["num_levels"]:][::-1]


@torch.no_grad()
def image_embeddings(params: Params, cfg: dict, pixels: torch.Tensor) -> List[torch.Tensor]:
    """Hiera -> FPN -> conv_s0 / conv_s1 pre-projection -> no-memory
    embedding on the coarsest level: [hi, mid, lo] NHWC maps."""
    with full_fp32():
        feats = neck_forward(params["neck"], cfg, hiera_forward(params["hiera"], cfg, pixels))
        feats[0] = _conv(params["decoder"]["conv_s0"], feats[0])
        feats[1] = _conv(params["decoder"]["conv_s1"], feats[1])
    feats[-1] = feats[-1] + params["no_memory_embedding"][0].to(feats[-1].dtype)
    return feats


# ---------------------------------------------------------------------------
# prompt encoder
# ---------------------------------------------------------------------------

def _fourier_pe(table: torch.Tensor, coords01: torch.Tensor) -> torch.Tensor:
    c = (2.0 * coords01 - 1.0).float() @ table.float()
    c = 2.0 * math.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], -1)


def encode_prompts(params: Params, cfg: dict, boxes: Optional[torch.Tensor] = None,
                   points: Optional[torch.Tensor] = None,
                   labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """boxes [B, Q, 4] (xyxy, input-image pixels) and/or points
    [B, Q, P, 2] + labels [B, Q, P] -> sparse embeddings [B, Q, T, C]."""
    pe = params["prompt"]
    table = params["shared_pe"]
    size = cfg["image_size"]
    sparse = None
    if points is not None:
        pts = (points + 0.5) / size
        if boxes is None:
            pts = F.pad(pts, (0, 0, 0, 1))
            labels = F.pad(labels, (0, 1), value=-1)
        emb = _fourier_pe(table, pts)
        lab = labels[..., None]
        emb = torch.where(lab == -1, pe["not_a_point"].to(emb.dtype), emb)
        emb = torch.where(lab == -10, torch.zeros((), dtype=emb.dtype, device=emb.device), emb)
        emb = emb + (pe["point_embed"][labels.clamp(min=0)]
                     * (labels >= 0)[..., None]).to(emb.dtype)
        sparse = emb
    if boxes is not None:
        corners = (boxes.reshape(*boxes.shape[:2], 2, 2) + 0.5) / size
        corners = F.pad(corners, (0, 0, 0, 1))
        emb = _fourier_pe(table, corners)
        emb = torch.stack([emb[:, :, 0] + pe["point_embed"][2].to(emb.dtype),
                           emb[:, :, 1] + pe["point_embed"][3].to(emb.dtype),
                           pe["not_a_point"].to(emb.dtype).expand_as(emb[:, :, 2])], 2)
        sparse = emb if sparse is None else torch.cat([sparse, emb], 2)
    return sparse


def image_wide_pe(params: Params, cfg: dict) -> torch.Tensor:
    """The decoder's image positional embedding [g, g, C] (Fourier over
    the pixel-centre grid of the coarsest embedding)."""
    g = cfg["image_size"] // cfg["prompt_patch"]
    dev = params["shared_pe"].device
    ys = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    xs = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), -1)
    return _fourier_pe(params["shared_pe"], grid)


# ---------------------------------------------------------------------------
# mask decoder
# ---------------------------------------------------------------------------

def _dec_attn(p, q, k, v, heads):
    return _lin(p["o_proj"], attention(_lin(p["q_proj"], q), _lin(p["k_proj"], k),
                                       _lin(p["v_proj"], v), heads))


@torch.no_grad()
def decode_masks(params: Params, cfg: dict, embeds: Sequence[torch.Tensor],
                 sparse: torch.Tensor, multimask_output: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """embeds from image_embeddings(); sparse [B, Q, T, C] -> (masks
    [B, Q, M, 4h, 4w], iou [B, Q, M], obj_logits [B, Q, 1])."""
    dp = params["decoder"]
    feat_s0, feat_s1, image_embed = embeds
    b, gh, gw, c = image_embed.shape
    qb = sparse.shape[1]
    nm = cfg["num_mask_tokens"]
    heads = cfg["dec_heads"]
    with full_fp32():
        out_tokens = torch.cat([dp["obj_score_token"], dp["iou_token"], dp["mask_tokens"]], 0)
        tokens = out_tokens[None].expand(b * qb, *out_tokens.shape)
        tokens = torch.cat([tokens, sparse.reshape(b * qb, *sparse.shape[2:])],
                           1).to(image_embed.dtype)
        img = image_embed + params["prompt"]["no_mask"].to(image_embed.dtype)
        keys = img.reshape(b, gh * gw, c).repeat_interleave(qb, 0)
        key_pe = image_wide_pe(params, cfg).reshape(1, gh * gw, c).expand(
            b * qb, gh * gw, c).to(keys.dtype)

        queries = tokens
        for i, layer in enumerate(dp["layers"]):
            if i == 0:  # skip_first_layer_pe: the output replaces the queries
                queries = _dec_attn(layer["self_attn"], queries, queries, queries, heads)
            else:
                qq = queries + tokens
                queries = queries + _dec_attn(layer["self_attn"], qq, qq, queries, heads)
            queries = ln(queries, layer["norm1"])
            queries = queries + _dec_attn(layer["cross_t2i"], queries + tokens, keys + key_pe,
                                          keys, heads)
            queries = ln(queries, layer["norm2"])
            queries = queries + _mlp(layer["mlp"], queries, torch.relu)
            queries = ln(queries, layer["norm3"])
            keys = keys + _dec_attn(layer["cross_i2t"], keys + key_pe, queries + tokens,
                                    queries, heads)
            keys = ln(keys, layer["norm4"])
        queries = queries + _dec_attn(dp["final_attn"], queries + tokens, keys + key_pe,
                                      keys, heads)
        queries = ln(queries, dp["norm_final"])

        iou_tok = queries[:, 1]
        mask_toks = queries[:, 2:2 + nm]
        img_sp = keys.reshape(b * qb, gh, gw, c)
        s0 = feat_s0.repeat_interleave(qb, 0)
        s1 = feat_s1.repeat_interleave(qb, 0)
        up = _conv_transpose2x2(dp["upscale_conv1"], img_sp) + s1
        up = F.gelu(ln(up, dp["upscale_norm"]))
        up = F.gelu(_conv_transpose2x2(dp["upscale_conv2"], up) + s0)
        hyper = torch.stack([_mlp(dp["hyper_mlps"][i], mask_toks[:, i], torch.relu)
                             for i in range(nm)], 1)
        hh, ww2 = up.shape[1], up.shape[2]
        masks = torch.einsum("bmc,bhwc->bmhw", hyper, up).reshape(b, qb, nm, hh, ww2)
        iou = torch.sigmoid(_mlp(dp["iou_head"], iou_tok, torch.relu)).reshape(b, qb, nm)
        obj = _mlp(dp["obj_head"], queries[:, 0], torch.relu).reshape(b, qb, 1)

    if multimask_output:
        return masks[:, :, 1:], iou[:, :, 1:], obj
    delta = cfg["stability_delta"]
    flat = masks.reshape(*masks.shape[:3], -1)
    area_i = (flat > delta).sum(-1).float()
    area_u = (flat > -delta).sum(-1).float()
    stability = torch.where(area_u > 0, area_i / area_u.clamp(min=1), torch.ones_like(area_i))
    is_stable = stability[:, :, 0:1] >= cfg["stability_thresh"]
    best = torch.argmax(iou[:, :, 1:], -1)
    best_masks = torch.gather(masks[:, :, 1:], 2, best[:, :, None, None, None].expand(
        -1, -1, 1, hh, ww2))
    best_iou = torch.gather(iou[:, :, 1:], 2, best[:, :, None])
    m = torch.where(is_stable[..., None, None], masks[:, :, 0:1], best_masks)
    s = torch.where(is_stable, iou[:, :, 0:1], best_iou)
    return m, s, obj


def predict_boxes(params: Params, cfg: dict, pixels: torch.Tensor, boxes: torch.Tensor,
                  multimask_output: bool = True):
    """Box-prompted prediction: pixels [B, H, W, 3] (normalized), boxes
    [B, Q, 4] xyxy in input-image pixels."""
    embeds = image_embeddings(params, cfg, pixels)
    sparse = encode_prompts(params, cfg, boxes=boxes)
    return decode_masks(params, cfg, embeds, sparse, multimask_output)


# ---------------------------------------------------------------------------
# conversion / init
# ---------------------------------------------------------------------------

def cfg_from_hf(config) -> dict:
    """The static cfg dict of a transformers Sam2Config (read by attribute;
    transformers itself is not imported)."""
    bb = config.vision_config.backbone_config
    return dict(
        embed_dims=tuple(bb.embed_dim_per_stage),
        heads=tuple(bb.num_attention_heads_per_stage),
        blocks=tuple(bb.blocks_per_stage),
        window_sizes=tuple(bb.window_size_per_stage),
        global_blocks=tuple(bb.global_attention_blocks),
        q_stride=bb.query_stride[0], q_pool_stages=bb.num_query_pool_stages,
        window_pe_bg=tuple(bb.window_positional_embedding_background_size),
        patch_kernel=bb.patch_kernel_size[0], patch_stride=bb.patch_stride[0],
        patch_pad=bb.patch_padding[0],
        fpn_hidden=config.vision_config.fpn_hidden_size,
        num_levels=config.vision_config.num_feature_levels,
        fpn_top_down=tuple(config.vision_config.fpn_top_down_levels),
        image_size=config.prompt_encoder_config.image_size,
        prompt_patch=config.prompt_encoder_config.patch_size,
        dec_heads=config.mask_decoder_config.num_attention_heads,
        dec_layers=config.mask_decoder_config.num_hidden_layers,
        dec_mlp=config.mask_decoder_config.mlp_dim,
        dec_downsample=config.mask_decoder_config.attention_downsample_rate,
        num_mask_tokens=config.mask_decoder_config.num_multimask_outputs + 1,
        stability_delta=config.mask_decoder_config.dynamic_multimask_stability_delta,
        stability_thresh=config.mask_decoder_config.dynamic_multimask_stability_thresh,
    )


def _getter(state_dict):
    def g(name):
        t = state_dict[name]
        return torch.as_tensor(np.asarray(t.detach().cpu().float().numpy()
                                          if hasattr(t, "detach") else t))
    return g


def convert_hf_sam2(state_dict, cfg: dict, dtype=torch.float32) -> Params:
    """A HuggingFace Sam2Model state dict -> the JAX converter's tree."""
    g = _getter(state_dict)

    def lin(prefix):
        return {"weight": g(f"{prefix}.weight").T.contiguous().to(dtype),
                "bias": g(f"{prefix}.bias").to(dtype)}

    def conv(prefix):
        return {"weight": g(f"{prefix}.weight").to(dtype), "bias": g(f"{prefix}.bias").to(dtype)}

    def lnp(prefix):
        return {"weight": g(f"{prefix}.weight"), "bias": g(f"{prefix}.bias")}

    def mlp(prefix):
        p = {"proj_in": lin(f"{prefix}.proj_in"), "proj_out": lin(f"{prefix}.proj_out"),
             "layers": []}
        i = 0
        while f"{prefix}.layers.{i}.weight" in state_dict:
            p["layers"].append(lin(f"{prefix}.layers.{i}"))
            i += 1
        return p

    bbp = "vision_encoder.backbone"
    blocks = []
    i = 0
    while f"{bbp}.blocks.{i}.layer_norm1.weight" in state_dict:
        pre = f"{bbp}.blocks.{i}"
        bp = {"norm1": lnp(f"{pre}.layer_norm1"), "qkv": lin(f"{pre}.attn.qkv"),
              "attn_proj": lin(f"{pre}.attn.proj"), "norm2": lnp(f"{pre}.layer_norm2"),
              "mlp": mlp(f"{pre}.mlp")}
        if f"{pre}.proj.weight" in state_dict:
            bp["proj"] = lin(f"{pre}.proj")
        blocks.append(bp)
        i += 1
    neck_convs = []
    i = 0
    while f"vision_encoder.neck.convs.{i}.weight" in state_dict:
        neck_convs.append(conv(f"vision_encoder.neck.convs.{i}"))
        i += 1

    def dec_attn(prefix):
        return {k: lin(f"{prefix}.{k}") for k in ("q_proj", "k_proj", "v_proj", "o_proj")}

    layers = []
    i = 0
    while f"mask_decoder.transformer.layers.{i}.layer_norm1.weight" in state_dict:
        pre = f"mask_decoder.transformer.layers.{i}"
        layers.append({
            "self_attn": dec_attn(f"{pre}.self_attn"), "norm1": lnp(f"{pre}.layer_norm1"),
            "cross_t2i": dec_attn(f"{pre}.cross_attn_token_to_image"),
            "norm2": lnp(f"{pre}.layer_norm2"), "mlp": mlp(f"{pre}.mlp"),
            "norm3": lnp(f"{pre}.layer_norm3"),
            "cross_i2t": dec_attn(f"{pre}.cross_attn_image_to_token"),
            "norm4": lnp(f"{pre}.layer_norm4"),
        })
        i += 1
    nm = cfg["num_mask_tokens"]
    return {
        "hiera": {
            "patch_embed": conv(f"{bbp}.patch_embed.projection"),
            "pos_embed": g(f"{bbp}.pos_embed"),
            "pos_embed_window": g(f"{bbp}.pos_embed_window"),
            "blocks": blocks,
        },
        "neck": {"convs": neck_convs},
        "shared_pe": g("shared_image_embedding.positional_embedding"),
        "no_memory_embedding": g("no_memory_embedding").to(dtype),
        "prompt": {
            "point_embed": g("prompt_encoder.point_embed.weight").to(dtype),
            "not_a_point": g("prompt_encoder.not_a_point_embed.weight").to(dtype)[0],
            "no_mask": g("prompt_encoder.no_mask_embed.weight").to(dtype)[0],
        },
        "decoder": {
            "obj_score_token": g("mask_decoder.obj_score_token.weight").to(dtype),
            "iou_token": g("mask_decoder.iou_token.weight").to(dtype),
            "mask_tokens": g("mask_decoder.mask_tokens.weight").to(dtype),
            "layers": layers,
            "final_attn": dec_attn("mask_decoder.transformer.final_attn_token_to_image"),
            "norm_final": lnp("mask_decoder.transformer.layer_norm_final_attn"),
            "upscale_conv1": conv("mask_decoder.upscale_conv1"),
            "upscale_conv2": conv("mask_decoder.upscale_conv2"),
            "upscale_norm": lnp("mask_decoder.upscale_layer_norm"),
            "hyper_mlps": [mlp(f"mask_decoder.output_hypernetworks_mlps.{i}")
                           for i in range(nm)],
            "iou_head": mlp("mask_decoder.iou_prediction_head"),
            "obj_head": mlp("mask_decoder.pred_obj_score_head"),
            "conv_s0": conv("mask_decoder.conv_s0"),
            "conv_s1": conv("mask_decoder.conv_s1"),
        },
    }


def init_sam2(generator: torch.Generator, cfg: dict = TEST_TINY,
              dtype=torch.float32) -> Params:
    """Random init from `generator` on its device with the converted tree's
    keys, shapes and dtypes (the JAX init's scales)."""
    gen = generator

    def lin(cin, cout):
        return {"weight": normal(gen, (cin, cout), (2.0 / (cin + cout)) ** 0.5, dtype),
                "bias": zeros((cout,), dtype, gen)}

    def conv(cout, cin, k):
        return {"weight": normal(gen, (cout, cin, k, k), 1 / math.sqrt(cin * k * k), dtype),
                "bias": zeros((cout,), dtype, gen)}

    def ct(cin, cout):
        return {"weight": normal(gen, (cin, cout, 2, 2), 1 / math.sqrt(cin * 4), dtype),
                "bias": zeros((cout,), dtype, gen)}

    def lnp(c):
        return {"weight": ones((c,), torch.float32, gen), "bias": zeros((c,), torch.float32, gen)}

    def mlp(cin, hid, cout, depth=2):
        return {"proj_in": lin(cin, hid), "proj_out": lin(hid, cout),
                "layers": [lin(hid, hid) for _ in range(depth - 2)]}

    blocks = []
    for lo in _block_layout(cfg):
        bp = {"norm1": lnp(lo["dim"]), "qkv": lin(lo["dim"], lo["dim_out"] * 3),
              "attn_proj": lin(lo["dim_out"], lo["dim_out"]), "norm2": lnp(lo["dim_out"]),
              "mlp": mlp(lo["dim_out"], int(lo["dim_out"] * 4), lo["dim_out"])}
        if lo["dim"] != lo["dim_out"]:
            bp["proj"] = lin(lo["dim"], lo["dim_out"])
        blocks.append(bp)
    c = cfg["fpn_hidden"]
    d0 = cfg["embed_dims"][0]

    def dec_attn(rate):
        inner = c // rate
        return {"q_proj": lin(c, inner), "k_proj": lin(c, inner), "v_proj": lin(c, inner),
                "o_proj": lin(inner, c)}

    nm = cfg["num_mask_tokens"]
    ws0 = cfg["window_sizes"][0]
    return {
        "hiera": {
            "patch_embed": conv(d0, 3, cfg["patch_kernel"]),
            "pos_embed": normal(gen, (1, d0, *cfg["window_pe_bg"]), 0.02, torch.float32),
            "pos_embed_window": normal(gen, (1, d0, ws0, ws0), 0.02, torch.float32),
            "blocks": blocks,
        },
        "neck": {"convs": [conv(c, ch, 1) for ch in cfg["embed_dims"][::-1]]},
        "shared_pe": normal(gen, (2, c // 2), 1.0, torch.float32),
        "no_memory_embedding": zeros((1, 1, c), dtype, gen),
        "prompt": {"point_embed": normal(gen, (4, c), 0.02, dtype),
                   "not_a_point": normal(gen, (c,), 0.02, dtype),
                   "no_mask": normal(gen, (c,), 0.02, dtype)},
        "decoder": {
            "obj_score_token": normal(gen, (1, c), 0.02, dtype),
            "iou_token": normal(gen, (1, c), 0.02, dtype),
            "mask_tokens": normal(gen, (nm, c), 0.02, dtype),
            "layers": [{
                "self_attn": dec_attn(1), "norm1": lnp(c),
                "cross_t2i": dec_attn(cfg["dec_downsample"]), "norm2": lnp(c),
                "mlp": mlp(c, cfg["dec_mlp"], c), "norm3": lnp(c),
                "cross_i2t": dec_attn(cfg["dec_downsample"]), "norm4": lnp(c),
            } for _ in range(cfg["dec_layers"])],
            "final_attn": dec_attn(cfg["dec_downsample"]),
            "norm_final": lnp(c),
            "upscale_conv1": ct(c, c // 4),
            "upscale_conv2": ct(c // 4, c // 8),
            "upscale_norm": lnp(c // 4),
            "hyper_mlps": [mlp(c, c, c // 8, 3) for _ in range(nm)],
            "iou_head": mlp(c, c, nm, 3),
            "obj_head": mlp(c, c, 1, 3),
            "conv_s0": conv(c // 8, c, 1),
            "conv_s1": conv(c // 4, c, 1),
        },
    }
