"""Grounding DINO open-vocabulary detection (the port's counterpart of
``versecrafter_tpu.perception.gdino_hf``), the detection half of the neural
segmenter.

- Swin backbone: relative-position-bias windowed attention, shifted windows
  with the 9-region mask, patch merging, per-stage output norms;
- BERT text backbone driven by the special-token block-diagonal mask and
  intra-phrase position ids (`text_masks_and_positions`, host numpy);
- encoder layers: vision <-> text fusion, the text self-enhancer and
  multiscale deformable attention, sampled by F.grid_sample (bilinear,
  align_corners=False, zeros outside the grid: the JAX gathers' semantics)
  in fp32;
- two-stage query selection: per-token proposals, contrastive text scores
  and the top-k taken by a stable descending sort, ties in index order as
  jax.lax.top_k keeps them (the proposals outside (0.01, 0.99) share one
  score);
- decoder layers with sine reference-point query positions and per-layer
  box refinement; the contrastive class head padded to max_text_len.

`init_gdino` builds the tree `convert_hf_gdino` gives for a
transformers GroundingDinoForObjectDetection (keys, shapes, dtypes) from a
torch.Generator, without transformers. The detector's activations follow
the weights' dtype (bf16 with `dtype=torch.bfloat16`); sampling locations,
softmaxes, layer norms and the box recursion stay fp32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from versecrafter_tpu_torch.perception._ops import (
    attention, full_fp32, lin as _lin, ln, normal, ones, zeros)

Params = Dict[str, Any]

SPECIAL_TOKENS = (101, 102, 1012, 1029)  # [CLS] [SEP] . ?

# Swin-T + BERT-base, 900 queries, 4-level deformable encoder / decoder
SWINT_CFG = dict(d_model=256, enc_heads=8, dec_heads=8, fusion_heads=4,
                 enc_points=4, dec_points=4, num_queries=900,
                 max_text_len=256, pos_temperature=20.0, swin_patch=4,
                 swin_window=7, swin_heads=(3, 6, 12, 24),
                 swin_out_stages=(1, 2, 3), bert_heads=12)
# the sizes init_gdino needs beyond the forward's cfg: those of
# hf_swint_config() in the JAX package (transformers' BertConfig defaults)
SWINT_SHAPES = dict(swin_embed_dim=96, swin_depths=(2, 2, 6, 2), bert_vocab=30522,
                    bert_hidden=768, bert_layers=12, bert_intermediate=3072,
                    bert_max_pos=512, bert_type_vocab=2, enc_layers=6, dec_layers=6,
                    enc_ffn=2048, dec_ffn=2048, num_levels=4)

_F32_MIN = torch.finfo(torch.float32).min


def _ln(x, p, eps=1e-5):
    return ln(x, p, eps)


def _mha(p, q, k, v, heads, mask=None):
    """query/key/value/out_proj attention; additive fp32 mask broadcastable
    to [B, heads, Q, K]."""
    o = attention(_lin(p["query"], q), _lin(p["key"], k), _lin(p["value"], v), heads, mask=mask)
    return _lin(p["out_proj"], o)


# ---------------------------------------------------------------------------
# Swin backbone
# ---------------------------------------------------------------------------

def _rel_index(window: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1).reshape(-1)


def _swin_attn(p, x, heads, window, mask=None):
    """x: [nW*B, win*win, C]; the relative position bias from the table and
    an optional per-window additive mask [nW, win^2, win^2]."""
    bW, n, c = x.shape
    hd = c // heads
    q, k, v = (_lin(p[name], x).reshape(bW, n, heads, hd).transpose(1, 2)
               for name in ("query", "key", "value"))
    s = torch.einsum("bnqd,bnkd->bnqk", q, k) / math.sqrt(hd)
    idx = torch.from_numpy(_rel_index(window)).to(x.device)
    bias = p["relative_position_bias_table"][idx].reshape(n, n, -1).permute(2, 0, 1)
    s = s + bias[None].to(s.dtype)
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(bW // nW, nW, heads, n, n) + mask[None, :, None].to(s.dtype))
        s = s.reshape(bW, heads, n, n)
    a = F.softmax(s.float(), -1).to(x.dtype)
    o = torch.einsum("bnqk,bnkd->bnqd", a, v).transpose(1, 2).reshape(bW, n, c)
    return _lin(p["out_dense"], o)


def _swin_shift_mask(h, w, window, shift) -> torch.Tensor:
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // window, window, w // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    mask = win[:, None, :] - win[:, :, None]
    return torch.from_numpy(np.where(mask != 0, -100.0, 0.0).astype(np.float32))


def swin_forward(params: Params, cfg: dict, pixels: torch.Tensor) -> List[torch.Tensor]:
    """pixels [B, 3, H, W] -> the out-stages' normed NCHW features."""
    b = pixels.shape[0]
    ps = cfg["swin_patch"]
    x = pixels.permute(0, 2, 3, 1)
    H, W = x.shape[1:3]
    x = x.reshape(b, H // ps, ps, W // ps, ps, 3).permute(0, 1, 3, 5, 2, 4)
    x = _ln(_lin(params["patch_embed"], x.reshape(b, (H // ps) * (W // ps), 3 * ps * ps)),
            params["patch_norm"])
    h, w = H // ps, W // ps
    window = cfg["swin_window"]
    outs = []
    for si, stage in enumerate(params["stages"]):
        heads = cfg["swin_heads"][si]
        for bi, blk in enumerate(stage["blocks"]):
            shift = window // 2 if bi % 2 else 0
            if min(h, w) <= window:
                shift = 0
            win = min(window, h, w)
            shortcut = x
            hs = _ln(x, blk["layernorm_before"]).reshape(b, h, w, -1)
            pad_r, pad_b = (win - w % win) % win, (win - h % win) % win
            hs = F.pad(hs, (0, 0, 0, pad_r, 0, pad_b))
            hp, wp = h + pad_b, w + pad_r
            if shift > 0:
                hs = torch.roll(hs, (-shift, -shift), (1, 2))
            hw = hs.reshape(b, hp // win, win, wp // win, win, -1)
            hw = hw.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, hs.shape[-1])
            amask = _swin_shift_mask(hp, wp, win, shift).to(x.device) if shift > 0 else None
            hw = _swin_attn(blk["attn"], hw, heads, win, amask)
            hs = hw.reshape(b, hp // win, wp // win, win, win, -1).permute(
                0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
            if shift > 0:
                hs = torch.roll(hs, (shift, shift), (1, 2))
            x = shortcut + hs[:, :h, :w].reshape(b, h * w, -1)
            x = x + _lin(blk["output_dense"], F.gelu(_lin(blk["intermediate_dense"],
                                                        _ln(x, blk["layernorm_after"]))))
        if si in cfg["swin_out_stages"]:
            xo = _ln(x, params["out_norms"][cfg["swin_out_stages"].index(si)])
            outs.append(xo.reshape(b, h, w, -1).permute(0, 3, 1, 2))
        if "downsample" in stage:
            xv = x.reshape(b, h, w, -1)
            xv = torch.cat([xv[:, 0::2, 0::2], xv[:, 1::2, 0::2], xv[:, 0::2, 1::2],
                            xv[:, 1::2, 1::2]], -1)
            h, w = h // 2, w // 2
            x = _lin(stage["downsample"]["reduction"],
                     _ln(xv.reshape(b, h * w, -1), stage["downsample"]["norm"]))
    return outs


# ---------------------------------------------------------------------------
# BERT text backbone
# ---------------------------------------------------------------------------

def text_masks_and_positions(input_ids: np.ndarray):
    """generate_masks_with_special_tokens_and_transfer_map (host numpy)."""
    bsz, n = input_ids.shape
    special = np.isin(input_ids, SPECIAL_TOKENS)
    attn = np.tile(np.eye(n, dtype=bool)[None], (bsz, 1, 1))
    pos = np.zeros((bsz, n), np.int64)
    for row in range(bsz):
        prev = 0
        for col in np.nonzero(special[row])[0]:
            if col == 0 or col == n - 1:
                attn[row, col, col] = True
                pos[row, col] = 0
            else:
                attn[row, prev + 1:col + 1, prev + 1:col + 1] = True
                pos[row, prev + 1:col + 1] = np.arange(0, col - prev)
            prev = col
    return attn, pos


def bert_forward(params: Params, cfg: dict, input_ids, attn3d, position_ids):
    emb = params["embeddings"]
    x = emb["word"][input_ids] + emb["position"][position_ids] \
        + emb["token_type"][torch.zeros_like(input_ids)]
    x = _ln(x, emb["LayerNorm"], eps=1e-12)
    mask = (1.0 - attn3d.float())[:, None] * _F32_MIN
    heads = cfg["bert_heads"]
    for ly in params["layers"]:
        a = _mha({"query": ly["q"], "key": ly["k"], "value": ly["v"], "out_proj": ly["attn_out"]},
                 x, x, x, heads, mask=mask)
        x = _ln(x + a, ly["attn_ln"], eps=1e-12)
        x = _ln(x + _lin(ly["out"], F.gelu(_lin(ly["inter"], x))), ly["out_ln"], eps=1e-12)
    return x


# ---------------------------------------------------------------------------
# positional embeddings
# ---------------------------------------------------------------------------

def sine_pos_2d(h: int, w: int, d_model: int, temperature: float = 20.0) -> torch.Tensor:
    """GroundingDinoSinePositionEmbedding with a full-valid mask: [d, h, w]."""
    half = d_model // 2
    eps = 1e-6
    y = (np.arange(h, dtype=np.float64) + 1) / (h + eps) * 2 * np.pi
    x = (np.arange(w, dtype=np.float64) + 1) / (w + eps) * 2 * np.pi
    dim_t = temperature ** (2 * (np.arange(half) // 2) / half)
    py, px = y[:, None] / dim_t, x[:, None] / dim_t

    def inter(p):
        return np.stack([np.sin(p[..., 0::2]), np.cos(p[..., 1::2])], -1).reshape(
            *p.shape[:-1], -1)
    py = inter(py)[:, None, :].repeat(w, 1)
    px = inter(px)[None, :, :].repeat(h, 0)
    return torch.from_numpy(np.concatenate([py, px], -1).transpose(2, 0, 1).astype(np.float32))


def get_sine_pos_embed(pos: torch.Tensor, num_pos_feats: int = 128,
                       temperature: float = 10000.0, exchange_xy: bool = True):
    """[..., n] -> [..., n*num_pos_feats] (HF get_sine_pos_embed)."""
    scale = 2 * math.pi
    dim_t = temperature ** (2 * (torch.arange(num_pos_feats, device=pos.device) // 2)
                            / num_pos_feats)
    parts = []
    for i in range(pos.shape[-1]):
        s = pos[..., i:i + 1] * scale / dim_t
        s = torch.stack([torch.sin(s[..., 0::2]), torch.cos(s[..., 1::2])], -1)
        parts.append(s.reshape(*pos.shape[:-1], -1))
    if exchange_xy and len(parts) >= 2:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, -1)


# ---------------------------------------------------------------------------
# deformable attention
# ---------------------------------------------------------------------------

def deformable_attention(p: Params, query, reference_points, value, shapes,
                         heads: int, n_points: int):
    """query [B, Q, D]; reference_points [B, Q, L, 2 or 4] normalized;
    value [B, sum(HW), D] over the `shapes` levels. Each level sampled with
    F.grid_sample in fp32 (bilinear, align_corners=False, zeros outside)."""
    B, Q, D = query.shape
    L = len(shapes)
    hd = D // heads
    off = _lin(p["sampling_offsets"], query).reshape(B, Q, heads, L, n_points, 2)
    w = _lin(p["attention_weights"], query).reshape(B, Q, heads, L * n_points)
    w = F.softmax(w.float(), -1).to(query.dtype).reshape(B, Q, heads, L, n_points)
    v = _lin(p["value_proj"], value)
    if reference_points.shape[-1] == 2:
        normalizer = torch.tensor([[wd, ht] for ht, wd in shapes], dtype=torch.float32,
                                  device=query.device)
        loc = reference_points[:, :, None, :, None, :] \
            + off.float() / normalizer[None, None, None, :, None, :]
    else:
        loc = reference_points[:, :, None, :, None, :2] \
            + (off / n_points).float() * reference_points[:, :, None, :, None, 2:] * 0.5
    out = torch.zeros((B * heads, hd, Q, n_points), dtype=torch.float32, device=query.device)
    start = 0
    for li, (ht, wd) in enumerate(shapes):
        lvl = v[:, start:start + ht * wd].reshape(B, ht, wd, heads, hd)
        start += ht * wd
        lvl = lvl.permute(0, 3, 4, 1, 2).reshape(B * heads, hd, ht, wd).float()
        grid = (2 * loc[:, :, :, li] - 1).permute(0, 2, 1, 3, 4).reshape(B * heads, Q, n_points, 2)
        samp = F.grid_sample(lvl, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False)  # [B*heads, hd, Q, P]
        wl = w[:, :, :, li].float().permute(0, 2, 1, 3).reshape(B * heads, 1, Q, n_points)
        out = out + samp * wl
    out = out.sum(-1).reshape(B, heads, hd, Q).permute(0, 3, 1, 2).reshape(B, Q, D)
    return _lin(p["output_proj"], out.to(query.dtype))


# ---------------------------------------------------------------------------
# encoder / decoder
# ---------------------------------------------------------------------------

def _mlp_head(p, x, act=torch.relu):
    n = len(p["layers"])
    for i, lyr in enumerate(p["layers"]):
        x = _lin(lyr, x)
        if i < n - 1:
            x = act(x)
    return x


def _fusion(p, vis, txt, heads):
    vn = _ln(vis, p["layer_norm_vision"])
    tn = _ln(txt, p["layer_norm_text"])
    a = p["attn"]
    b, nv, _ = vn.shape
    nt = tn.shape[1]
    emb = a["vision_proj"]["weight"].shape[1]
    hd = emb // heads

    def resh(t):
        return t.reshape(b, -1, heads, hd).transpose(1, 2)
    vq = resh(_lin(a["vision_proj"], vn) * (hd ** -0.5))
    tk = resh(_lin(a["text_proj"], tn))
    vv = resh(_lin(a["values_vision_proj"], vn))
    tv = resh(_lin(a["values_text_proj"], tn))
    s = torch.einsum("bhvd,bhtd->bhvt", vq, tk)
    s = torch.clamp(s - s.max(), -50000, 50000)
    st = s.transpose(2, 3)
    st = torch.clamp(st - st.amax(-1, keepdim=True), -50000, 50000)
    va = F.softmax(s.float(), -1).to(vis.dtype)
    ta = F.softmax(st.float(), -1).to(vis.dtype)
    dv = torch.einsum("bhvt,bhtd->bhvd", va, tv).transpose(1, 2).reshape(b, nv, emb)
    dt = torch.einsum("bhtv,bhvd->bhtd", ta, vv).transpose(1, 2).reshape(b, nt, emb)
    vis = vn + p["vision_param"].to(vis.dtype) * _lin(a["out_vision_proj"], dv)
    txt = tn + p["text_param"].to(txt.dtype) * _lin(a["out_text_proj"], dt)
    return vis, txt


def _level_refs(shapes, batch, device):
    refs = []
    for (ht, wd) in shapes:
        yy, xx = np.mgrid[0:ht, 0:wd].astype(np.float64) + 0.5
        refs.append(np.stack([(xx / wd).reshape(-1), (yy / ht).reshape(-1)], -1))
    ref = torch.from_numpy(np.concatenate(refs, 0).astype(np.float32)).to(device)
    return ref[None, :, None, :].expand(batch, ref.shape[0], len(shapes), 2)


def encoder_forward(params: Params, cfg: dict, vis, vis_pos, shapes, txt,
                    text_self_masks, text_pos_ids):
    heads = cfg["enc_heads"]
    text_pos = get_sine_pos_embed(text_pos_ids[..., None].float(), num_pos_feats=cfg["d_model"],
                                  exchange_xy=False)
    ref = _level_refs(shapes, vis.shape[0], vis.device)
    tmask = (1.0 - text_self_masks.float())[:, None] * _F32_MIN
    for ly in params["layers"]:
        vis, txt = _fusion(ly["fusion_layer"], vis, txt, cfg["fusion_heads"])
        te = ly["text_enhancer_layer"]
        qk = txt + text_pos.to(txt.dtype)
        a = _mha({"query": te["q"], "key": te["k"], "value": te["v"], "out_proj": te["attn_out"]},
                 qk, qk, txt, cfg["enc_heads"] // 2, mask=tmask)
        txt = _ln(txt + a, te["layer_norm_before"])
        txt = _ln(txt + _lin(te["fc2"], torch.relu(_lin(te["fc1"], txt))), te["layer_norm_after"])
        dl = ly["deformable_layer"]
        h = deformable_attention(dl["self_attn"], vis + vis_pos.to(vis.dtype), ref, vis, shapes,
                                 heads, cfg["enc_points"])
        vis = _ln(vis + h, dl["self_attn_layer_norm"])
        vis = _ln(vis + _lin(dl["fc2"], torch.relu(_lin(dl["fc1"], vis))), dl["final_layer_norm"])
    return vis, txt


def decoder_forward(params: Params, cfg: dict, target, ref_boxes, vis, txt, shapes,
                    text_token_mask):
    heads = cfg["dec_heads"]
    tmask = torch.where(text_token_mask[:, None, None, :], 0.0, _F32_MIN)
    for idx, ly in enumerate(params["layers"]):
        ref_in = ref_boxes[:, :, None, :].expand(*ref_boxes.shape[:2], len(shapes), 4)
        qpos = get_sine_pos_embed(ref_in[:, :, 0, :], num_pos_feats=cfg["d_model"] // 2)
        qpos = _mlp_head(params["reference_points_head"], qpos).to(target.dtype)
        qk = target + qpos
        target = _ln(target + _mha(ly["self_attn"], qk, qk, target, heads),
                     ly["self_attn_layer_norm"])
        a = _mha(ly["encoder_attn_text"], target + qpos, txt, txt, heads, mask=tmask)
        target = _ln(target + a, ly["encoder_attn_text_layer_norm"])
        a = deformable_attention(ly["encoder_attn"], target + qpos, ref_in, vis, shapes, heads,
                                 cfg["dec_points"])
        target = _ln(target + a, ly["encoder_attn_layer_norm"])
        target = _ln(target + _lin(ly["fc2"], torch.relu(_lin(ly["fc1"], target))),
                     ly["final_layer_norm"])
        delta = _mlp_head(params["bbox_embed"][idx], target)
        ref_boxes = torch.sigmoid(delta + torch.logit(torch.clamp(ref_boxes, 1e-5, 1 - 1e-5)))
    return _ln(target, params["layer_norm"]), ref_boxes


def _gn_conv(p, x, stride: int = 1):
    """input_proj: conv + GroupNorm(32), NCHW."""
    k = p["conv"]["weight"]
    y = F.conv2d(x, k.to(x.dtype), p["conv"]["bias"].to(x.dtype), stride, k.shape[2] // 2)
    b, c, h, w = y.shape
    groups = min(32, c)
    yf = y.float().reshape(b, groups, c // groups, h, w)
    mu = yf.mean((2, 3, 4), keepdim=True)
    var = (yf - mu).square().mean((2, 3, 4), keepdim=True)
    yf = ((yf - mu) * torch.rsqrt(var + 1e-5)).reshape(b, c, h, w)
    return (yf * p["gn"]["weight"].float()[None, :, None, None]
            + p["gn"]["bias"].float()[None, :, None, None]).to(x.dtype)


def _proposals(shapes):
    props = []
    for lvl, (h, w) in enumerate(shapes):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        grid = np.stack([(xx + 0.5) / w, (yy + 0.5) / h], -1).reshape(-1, 2)
        props.append(np.concatenate([grid, np.full_like(grid, 0.05 * (2.0 ** lvl))], -1))
    props = np.concatenate(props, 0)
    valid = ((props > 0.01) & (props < 0.99)).all(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        logit = np.where(valid[:, None], np.log(props / (1 - props)), np.inf)
    return valid, logit


def topk_stable(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores along the last axis, equal scores in
    index order (jax.lax.top_k's order)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :k]


@torch.no_grad()
def gdino_encode(params: Params, cfg: dict, pixel_values: torch.Tensor, input_ids,
                 attn3d=None, pos_ids=None) -> dict:
    """gdino_forward up to the two-stage query selection: the encoder's
    vision and text tokens, the proposals' features and logits, and each
    proposal's score (its best text-token similarity), on the params'
    device."""
    dev = params["level_embed"].device
    B = pixel_values.shape[0]
    d = cfg["d_model"]
    pixel_values = pixel_values.to(dev, params["swin"]["patch_embed"]["weight"].dtype)
    if attn3d is None or pos_ids is None:
        attn3d, pos_ids = text_masks_and_positions(np.asarray(input_ids))
    attn3d = torch.as_tensor(np.asarray(attn3d)).to(dev)
    pos_ids = torch.as_tensor(np.asarray(pos_ids)).to(dev)
    input_ids = torch.as_tensor(np.asarray(input_ids)).to(dev)
    with full_fp32():
        txt = _lin(params["text_projection"],
                   bert_forward(params["text_backbone"], cfg, input_ids, attn3d, pos_ids))
        feats = swin_forward(params["swin"], cfg, pixel_values)
        srcs = [_gn_conv(params["input_proj"][i], f) for i, f in enumerate(feats)]
        srcs.append(_gn_conv(params["input_proj"][len(feats)], feats[-1], stride=2))
        shapes = [(s.shape[2], s.shape[3]) for s in srcs]
        vis = torch.cat([s.reshape(B, d, -1).transpose(1, 2) for s in srcs], 1)
        pos = torch.cat([
            (sine_pos_2d(h, w, d, cfg["pos_temperature"]).to(dev).reshape(d, -1).T
             + params["level_embed"][li][None])[None].expand(B, -1, -1)
            for li, (h, w) in enumerate(shapes)], 1)
        vis, txt_e = encoder_forward(params["encoder"], cfg, vis, pos, shapes, txt, attn3d,
                                     pos_ids)
        valid_np, logit_np = _proposals(shapes)
        valid = torch.from_numpy(valid_np).to(dev)
        obj = torch.where(valid[None, :, None], vis, torch.zeros((), dtype=vis.dtype, device=dev))
        obj = _ln(_lin(params["enc_output"], obj), params["enc_output_norm"])
        cls = torch.einsum("bnd,btd->bnt", obj.float(), txt_e.float())
    return {"vis": vis, "txt": txt_e, "shapes": shapes, "obj": obj,
            "props_logit": torch.from_numpy(logit_np.astype(np.float32)).to(dev)[None],
            "scores": cls.amax(-1), "text_len": input_ids.shape[-1]}


@torch.no_grad()
def gdino_decode(params: Params, cfg: dict, enc: dict, top_idx: torch.Tensor):
    """The decoder from gdino_encode's output and the selected proposals
    top_idx [B, num_queries] -> (logits [B, Q, max_text_len], boxes
    [B, Q, 4] cxcywh)."""
    vis, txt_e, obj = enc["vis"], enc["txt"], enc["obj"]
    B, d = vis.shape[0], cfg["d_model"]
    text_token_mask = torch.ones((B, enc["text_len"]), dtype=torch.bool, device=vis.device)
    with full_fp32():
        coord_logits = torch.gather(
            enc["props_logit"] + _mlp_head(params["encoder_output_bbox_embed"], obj),
            1, top_idx[..., None].expand(-1, -1, 4))
        target = params["query_position_embeddings"][None].expand(
            B, top_idx.shape[1], d).to(vis.dtype)
        hidden, boxes = decoder_forward(params["decoder"], cfg, target,
                                        torch.sigmoid(coord_logits), vis, txt_e, enc["shapes"],
                                        text_token_mask)
        logits = torch.einsum("bqd,btd->bqt", hidden.float(), txt_e.float())
    logits = torch.where(text_token_mask[:, None, :], logits, -math.inf)
    pad = cfg["max_text_len"] - logits.shape[-1]
    if pad > 0:
        logits = F.pad(logits, (0, pad), value=-math.inf)
    return logits, boxes


def gdino_forward(params: Params, cfg: dict, pixel_values: torch.Tensor, input_ids,
                  attn3d=None, pos_ids=None):
    """pixel_values [B, 3, H, W] (ImageNet-normalized); input_ids [B, L]
    BERT tokens -> (logits [B, Q, max_text_len], boxes [B, Q, 4] cxcywh),
    on the params' device: gdino_encode, the num_queries best-scoring
    proposals (topk_stable), gdino_decode."""
    enc = gdino_encode(params, cfg, pixel_values, input_ids, attn3d, pos_ids)
    return gdino_decode(params, cfg, enc, topk_stable(enc["scores"], cfg["num_queries"]))


# ---------------------------------------------------------------------------
# HF conversion / init
# ---------------------------------------------------------------------------

def convert_hf_gdino(state_dict, cfg: dict, dtype=torch.float32) -> Params:
    """A HuggingFace GroundingDinoForObjectDetection state dict -> the JAX
    converter's tree."""
    def g(name):
        t = state_dict[name]
        return torch.as_tensor(np.asarray(t.detach().cpu().float().numpy()
                                          if hasattr(t, "detach") else t))

    def lin(prefix):
        p = {"weight": g(f"{prefix}.weight").T.contiguous().to(dtype)}
        if f"{prefix}.bias" in state_dict:
            p["bias"] = g(f"{prefix}.bias").to(dtype)
        return p

    def lnp(prefix):
        return {"weight": g(f"{prefix}.weight"), "bias": g(f"{prefix}.bias")}

    def mha(prefix):
        return {k: lin(f"{prefix}.{k}") for k in ("query", "key", "value", "out_proj")}

    def mlp(prefix, n):
        return {"layers": [lin(f"{prefix}.layers.{j}") for j in range(n)]}

    bb = "model.backbone.conv_encoder.model"
    pw = g(f"{bb}.embeddings.patch_embeddings.projection.weight")
    swin: Params = {
        "patch_embed": {"weight": pw.reshape(pw.shape[0], -1).T.contiguous().to(dtype),
                        "bias": g(f"{bb}.embeddings.patch_embeddings.projection.bias").to(dtype)},
        "patch_norm": lnp(f"{bb}.embeddings.norm"),
        "stages": [],
        "out_norms": [],
    }
    si = 0
    while f"{bb}.encoder.layers.{si}.blocks.0.layernorm_before.weight" in state_dict:
        stage = {"blocks": []}
        bi = 0
        while f"{bb}.encoder.layers.{si}.blocks.{bi}.layernorm_before.weight" in state_dict:
            pre = f"{bb}.encoder.layers.{si}.blocks.{bi}"
            stage["blocks"].append({
                "layernorm_before": lnp(f"{pre}.layernorm_before"),
                "layernorm_after": lnp(f"{pre}.layernorm_after"),
                "attn": {
                    "query": lin(f"{pre}.attention.self.query"),
                    "key": lin(f"{pre}.attention.self.key"),
                    "value": lin(f"{pre}.attention.self.value"),
                    "out_dense": lin(f"{pre}.attention.output.dense"),
                    "relative_position_bias_table": g(
                        f"{pre}.attention.self.relative_position_bias_table").to(dtype),
                },
                "intermediate_dense": lin(f"{pre}.intermediate.dense"),
                "output_dense": lin(f"{pre}.output.dense"),
            })
            bi += 1
        if f"{bb}.encoder.layers.{si}.downsample.reduction.weight" in state_dict:
            stage["downsample"] = {
                "reduction": lin(f"{bb}.encoder.layers.{si}.downsample.reduction"),
                "norm": lnp(f"{bb}.encoder.layers.{si}.downsample.norm"),
            }
        swin["stages"].append(stage)
        si += 1
    for st in cfg["swin_out_stages"]:
        swin["out_norms"].append(lnp(f"{bb}.hidden_states_norms.stage{st + 1}"))

    tb = "model.text_backbone"
    bert: Params = {
        "embeddings": {
            "word": g(f"{tb}.embeddings.word_embeddings.weight").to(dtype),
            "position": g(f"{tb}.embeddings.position_embeddings.weight").to(dtype),
            "token_type": g(f"{tb}.embeddings.token_type_embeddings.weight").to(dtype),
            "LayerNorm": lnp(f"{tb}.embeddings.LayerNorm"),
        },
        "layers": [],
    }
    li = 0
    while f"{tb}.encoder.layer.{li}.attention.self.query.weight" in state_dict:
        pre = f"{tb}.encoder.layer.{li}"
        bert["layers"].append({
            "q": lin(f"{pre}.attention.self.query"), "k": lin(f"{pre}.attention.self.key"),
            "v": lin(f"{pre}.attention.self.value"),
            "attn_out": lin(f"{pre}.attention.output.dense"),
            "attn_ln": lnp(f"{pre}.attention.output.LayerNorm"),
            "inter": lin(f"{pre}.intermediate.dense"), "out": lin(f"{pre}.output.dense"),
            "out_ln": lnp(f"{pre}.output.LayerNorm"),
        })
        li += 1

    def deform(prefix):
        return {k: lin(f"{prefix}.{k}") for k in
                ("sampling_offsets", "attention_weights", "value_proj", "output_proj")}

    enc: Params = {"layers": []}
    li = 0
    while f"model.encoder.layers.{li}.fusion_layer.vision_param" in state_dict:
        pre = f"model.encoder.layers.{li}"
        enc["layers"].append({
            "fusion_layer": {
                "layer_norm_vision": lnp(f"{pre}.fusion_layer.layer_norm_vision"),
                "layer_norm_text": lnp(f"{pre}.fusion_layer.layer_norm_text"),
                "vision_param": g(f"{pre}.fusion_layer.vision_param").to(dtype),
                "text_param": g(f"{pre}.fusion_layer.text_param").to(dtype),
                "attn": {k: lin(f"{pre}.fusion_layer.attn.{k}") for k in
                         ("vision_proj", "text_proj", "values_vision_proj",
                          "values_text_proj", "out_vision_proj", "out_text_proj")},
            },
            "text_enhancer_layer": {
                "q": lin(f"{pre}.text_enhancer_layer.self_attn.query"),
                "k": lin(f"{pre}.text_enhancer_layer.self_attn.key"),
                "v": lin(f"{pre}.text_enhancer_layer.self_attn.value"),
                "attn_out": lin(f"{pre}.text_enhancer_layer.self_attn.out_proj"),
                "fc1": lin(f"{pre}.text_enhancer_layer.fc1"),
                "fc2": lin(f"{pre}.text_enhancer_layer.fc2"),
                "layer_norm_before": lnp(f"{pre}.text_enhancer_layer.layer_norm_before"),
                "layer_norm_after": lnp(f"{pre}.text_enhancer_layer.layer_norm_after"),
            },
            "deformable_layer": {
                "self_attn": deform(f"{pre}.deformable_layer.self_attn"),
                "self_attn_layer_norm": lnp(f"{pre}.deformable_layer.self_attn_layer_norm"),
                "fc1": lin(f"{pre}.deformable_layer.fc1"),
                "fc2": lin(f"{pre}.deformable_layer.fc2"),
                "final_layer_norm": lnp(f"{pre}.deformable_layer.final_layer_norm"),
            },
        })
        li += 1

    dec: Params = {"layers": [], "reference_points_head": mlp("model.decoder.reference_points_head", 2),
                   "layer_norm": lnp("model.decoder.layer_norm"), "bbox_embed": []}
    li = 0
    while f"model.decoder.layers.{li}.self_attn.query.weight" in state_dict:
        pre = f"model.decoder.layers.{li}"
        dec["layers"].append({
            "self_attn": mha(f"{pre}.self_attn"),
            "self_attn_layer_norm": lnp(f"{pre}.self_attn_layer_norm"),
            "encoder_attn_text": mha(f"{pre}.encoder_attn_text"),
            "encoder_attn_text_layer_norm": lnp(f"{pre}.encoder_attn_text_layer_norm"),
            "encoder_attn": deform(f"{pre}.encoder_attn"),
            "encoder_attn_layer_norm": lnp(f"{pre}.encoder_attn_layer_norm"),
            "fc1": lin(f"{pre}.fc1"), "fc2": lin(f"{pre}.fc2"),
            "final_layer_norm": lnp(f"{pre}.final_layer_norm"),
        })
        dec["bbox_embed"].append(mlp(f"model.decoder.bbox_embed.{li}", 3))
        li += 1

    input_proj = []
    while f"model.input_proj_vision.{len(input_proj)}.0.weight" in state_dict:
        n = len(input_proj)
        input_proj.append({
            "conv": {"weight": g(f"model.input_proj_vision.{n}.0.weight").to(dtype),
                     "bias": g(f"model.input_proj_vision.{n}.0.bias").to(dtype)},
            "gn": lnp(f"model.input_proj_vision.{n}.1"),
        })
    return {
        "swin": swin,
        "text_backbone": bert,
        "text_projection": lin("model.text_projection"),
        "input_proj": input_proj,
        "level_embed": g("model.level_embed"),
        "encoder": enc,
        "decoder": dec,
        "enc_output": lin("model.enc_output"),
        "enc_output_norm": lnp("model.enc_output_norm"),
        "encoder_output_bbox_embed": mlp("model.encoder_output_bbox_embed", 3),
        "query_position_embeddings": g("model.query_position_embeddings.weight").to(dtype),
    }


def init_gdino(cfg: dict, generator: torch.Generator, dtype=torch.float32,
               shapes: Optional[dict] = None) -> Params:
    """Random init from `generator` on its device with the tree that
    convert_hf_gdino gives for transformers' GroundingDinoForObjectDetection
    of the same sizes (keys, shapes, dtypes): `cfg` is the forward's cfg,
    `shapes` the sizes it does not hold (default SWINT_SHAPES, the Swin-T +
    BERT-base model). Linear and embedding weights N(0, 0.02), biases 0,
    layer norms 1 / 0, the fusion layer scales 1e-4 (transformers'
    init_std and fusion init values)."""
    s = dict(SWINT_SHAPES, **(shapes or {}))
    gen = generator
    f32 = torch.float32
    d = cfg["d_model"]

    def lin(cin, cout, bias=True):
        p = {"weight": normal(gen, (cin, cout), 0.02, dtype)}
        if bias:
            p["bias"] = zeros((cout,), dtype, gen)
        return p

    def lnp(c):
        return {"weight": ones((c,), f32, gen), "bias": zeros((c,), f32, gen)}

    def mha(c):
        return {k: lin(c, c) for k in ("query", "key", "value", "out_proj")}

    def mlp(dims):
        return {"layers": [lin(a, b) for a, b in zip(dims[:-1], dims[1:])]}

    def deform(heads, points):
        lv = s["num_levels"]
        return {"sampling_offsets": lin(d, heads * lv * points * 2),
                "attention_weights": lin(d, heads * lv * points),
                "value_proj": lin(d, d), "output_proj": lin(d, d)}

    e, ps, win = s["swin_embed_dim"], cfg["swin_patch"], cfg["swin_window"]
    stages = []
    n_stages = len(s["swin_depths"])
    for si, depth in enumerate(s["swin_depths"]):
        c = e * 2 ** si
        stage = {"blocks": [{
            "layernorm_before": lnp(c), "layernorm_after": lnp(c),
            "attn": {"query": lin(c, c), "key": lin(c, c), "value": lin(c, c),
                     "out_dense": lin(c, c),
                     "relative_position_bias_table": normal(
                         gen, ((2 * win - 1) ** 2, cfg["swin_heads"][si]), 0.02, dtype)},
            "intermediate_dense": lin(c, 4 * c), "output_dense": lin(4 * c, c),
        } for _ in range(depth)]}
        if si < n_stages - 1:
            stage["downsample"] = {"reduction": lin(4 * c, 2 * c, bias=False), "norm": lnp(4 * c)}
        stages.append(stage)
    out_ch = [e * 2 ** st for st in cfg["swin_out_stages"]]
    swin = {"patch_embed": lin(3 * ps * ps, e), "patch_norm": lnp(e), "stages": stages,
            "out_norms": [lnp(c) for c in out_ch]}

    hb = s["bert_hidden"]
    bert = {
        "embeddings": {"word": normal(gen, (s["bert_vocab"], hb), 0.02, dtype),
                       "position": normal(gen, (s["bert_max_pos"], hb), 0.02, dtype),
                       "token_type": normal(gen, (s["bert_type_vocab"], hb), 0.02, dtype),
                       "LayerNorm": lnp(hb)},
        "layers": [{"q": lin(hb, hb), "k": lin(hb, hb), "v": lin(hb, hb), "attn_out": lin(hb, hb),
                    "attn_ln": lnp(hb), "inter": lin(hb, s["bert_intermediate"]),
                    "out": lin(s["bert_intermediate"], hb), "out_ln": lnp(hb)}
                   for _ in range(s["bert_layers"])],
    }

    def conv(cin, cout, k):
        return {"weight": normal(gen, (cout, cin, k, k), 0.02, dtype),
                "bias": zeros((cout,), dtype, gen)}

    input_proj = [{"conv": conv(c, d, 1), "gn": lnp(d)} for c in out_ch]
    for _ in range(s["num_levels"] - len(out_ch)):
        input_proj.append({"conv": conv(out_ch[-1] if len(input_proj) == len(out_ch) else d, d, 3),
                           "gn": lnp(d)})
    fusion_emb = s["enc_ffn"] // 2  # the fusion attention's inner width, as in transformers
    enc = {"layers": [{
        "fusion_layer": {
            "layer_norm_vision": lnp(d), "layer_norm_text": lnp(d),
            "vision_param": torch.full((d,), 1e-4, dtype=dtype, device=gen.device),
            "text_param": torch.full((d,), 1e-4, dtype=dtype, device=gen.device),
            "attn": {"vision_proj": lin(d, fusion_emb), "text_proj": lin(d, fusion_emb),
                     "values_vision_proj": lin(d, fusion_emb),
                     "values_text_proj": lin(d, fusion_emb),
                     "out_vision_proj": lin(fusion_emb, d), "out_text_proj": lin(fusion_emb, d)},
        },
        "text_enhancer_layer": {
            "q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "attn_out": lin(d, d),
            "fc1": lin(d, s["enc_ffn"] // 2), "fc2": lin(s["enc_ffn"] // 2, d),
            "layer_norm_before": lnp(d), "layer_norm_after": lnp(d),
        },
        "deformable_layer": {
            "self_attn": deform(cfg["enc_heads"], cfg["enc_points"]),
            "self_attn_layer_norm": lnp(d), "fc1": lin(d, s["enc_ffn"]),
            "fc2": lin(s["enc_ffn"], d), "final_layer_norm": lnp(d),
        },
    } for _ in range(s["enc_layers"])]}
    dec = {
        "layers": [{
            "self_attn": mha(d), "self_attn_layer_norm": lnp(d),
            "encoder_attn_text": mha(d), "encoder_attn_text_layer_norm": lnp(d),
            "encoder_attn": deform(cfg["dec_heads"], cfg["dec_points"]),
            "encoder_attn_layer_norm": lnp(d), "fc1": lin(d, s["dec_ffn"]),
            "fc2": lin(s["dec_ffn"], d), "final_layer_norm": lnp(d),
        } for _ in range(s["dec_layers"])],
        "reference_points_head": mlp((2 * d, d, d)),
        "layer_norm": lnp(d),
        "bbox_embed": [mlp((d, d, d, 4)) for _ in range(s["dec_layers"])],
    }
    return {
        "swin": swin, "text_backbone": bert, "text_projection": lin(hb, d),
        "input_proj": input_proj,
        "level_embed": normal(gen, (s["num_levels"], d), 1.0, f32),
        "encoder": enc, "decoder": dec, "enc_output": lin(d, d), "enc_output_norm": lnp(d),
        "encoder_output_bbox_embed": mlp((d, d, d, 4)),
        "query_position_embeddings": normal(gen, (cfg["num_queries"], d), 1.0, dtype),
    }


# ---------------------------------------------------------------------------
# grounded post-processing (HF GroundingDinoProcessor semantics)
# ---------------------------------------------------------------------------

def postprocess_grounded_detections(logits, pred_boxes, input_ids,
                                    box_threshold: float = 0.25, text_threshold: float = 0.25):
    """score = max sigmoid over the text tokens, kept above box_threshold;
    each kept box's posmap is the token positions above text_threshold
    (first and last excluded); boxes cxcywh -> xyxy, still normalized.
    Returns dicts {score, box, token_positions, probs}, best score first."""
    logits = _np32(logits)[0]
    boxes = _np32(pred_boxes)[0]
    L = np.asarray(input_ids).shape[-1]
    probs = 1.0 / (1.0 + np.exp(-logits[:, :L]))
    scores = probs.max(-1)
    out = []
    for q in np.where(scores > box_threshold)[0]:
        posmap = probs[q] > text_threshold
        posmap[0] = False
        posmap[L - 1:] = False
        cx, cy, w, h = boxes[q]
        out.append({"score": float(scores[q]),
                    "box": np.array([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], np.float32),
                    "token_positions": np.where(posmap)[0], "probs": probs[q]})
    out.sort(key=lambda d: -d["score"])
    return out


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def phrase_token_spans(tokenizer, phrases):
    """The '[CLS] p0 . p1 . ... [SEP]' encoding and each phrase's token span
    [start, end): (input_ids [1, L] int64, spans)."""
    dot = tokenizer.convert_tokens_to_ids(".")
    ids = [tokenizer.cls_token_id]
    spans = []
    for p in phrases:
        toks = tokenizer(p, add_special_tokens=False)["input_ids"]
        spans.append((len(ids), len(ids) + len(toks)))
        ids.extend(toks)
        ids.append(dot)
    ids.append(tokenizer.sep_token_id)
    return np.asarray([ids], np.int64), spans


def assign_phrase(det: dict, spans) -> int:
    """The prompt phrase whose span overlaps the detection's posmap most;
    else the span holding the highest-probability token."""
    pos = det["token_positions"]
    overlaps = [np.sum((pos >= s) & (pos < e)) for s, e in spans]
    if pos.size and max(overlaps) > 0:
        return int(np.argmax(overlaps))
    probs = det["probs"]
    return int(np.argmax([probs[s:e].max() if e > s else 0.0 for s, e in spans]))


def nms_xyxy(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.5) -> list:
    """Class-agnostic NMS; the kept indices, best score first."""
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        x0 = np.maximum(boxes[i, 0], boxes[rest, 0])
        y0 = np.maximum(boxes[i, 1], boxes[rest, 1])
        x1 = np.minimum(boxes[i, 2], boxes[rest, 2])
        y1 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        area_r = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(area_i + area_r - inter, 1e-9)
        order = rest[iou <= iou_threshold]
    return keep
