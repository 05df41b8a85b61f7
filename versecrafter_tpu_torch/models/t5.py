"""umT5 encoder (text conditioning): pre-RMSNorm blocks, unscaled q.k
attention with a per-layer bucketed relative position bias, gated-GELU FFN,
final RMSNorm. Parameters use the JAX package's tree: [in, out] kernels, a
list of block dicts. A tree sharded over a mesh
(parallel/sharding.shard_t5_params) has each big leaf gathered at use, so
every rank runs the whole encode from its 1/N of the weights."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from versecrafter_tpu_torch.core.config import T5Config
from versecrafter_tpu_torch.parallel.sharding import gathered

Params = Dict[str, Any]


def t5_layer_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """T5 RMSNorm: no mean subtraction, no bias; stats in fp32."""
    xf = x.float()
    y = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)).to(x.dtype)
    return y * weight.to(x.dtype)


def relative_position_bucket(relative_position: np.ndarray, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """Bidirectional T5 bucket function (host side; positions are static)."""
    ret = np.zeros_like(relative_position)
    n = -relative_position
    num_buckets //= 2
    ret += (n < 0).astype(np.int64) * num_buckets
    n = np.abs(n)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    ret += np.where(is_small, n, val_if_large)
    return ret


def _position_bias(rel_bias_emb, qlen: int, klen: int, num_buckets: int,
                   max_distance: int) -> torch.Tensor:
    """[n_heads, qlen, klen] from the bucket embedding [num_buckets, n_heads]."""
    buckets = relative_position_bucket(
        np.arange(klen)[None, :] - np.arange(qlen)[:, None], num_buckets, max_distance)
    idx = torch.as_tensor(buckets, device=rel_bias_emb.device)
    return rel_bias_emb[idx].permute(2, 0, 1)


def _attention(p: Params, cfg: T5Config, x, mask):
    b, s, _ = x.shape
    n = cfg.num_heads
    hd = cfg.dim_attn // n
    q = torch.matmul(x, gathered(p["q"]).to(x.dtype)).view(b, s, n, hd)
    k = torch.matmul(x, gathered(p["k"]).to(x.dtype)).view(b, s, n, hd)
    v = torch.matmul(x, gathered(p["v"]).to(x.dtype)).view(b, s, n, hd)
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    bias = _position_bias(p["rel_bias"], s, s, cfg.num_buckets,
                          cfg.rel_pos_max_distance).float()
    scores = scores + bias[None]
    if mask is not None:
        scores = scores.masked_fill(~(mask[:, None, None, :] > 0), -1e9)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bnqk,bknd->bqnd", w, v).reshape(b, s, -1)
    return torch.matmul(out, gathered(p["o"]).to(out.dtype))


def _ffn(p: Params, x):
    gate = F.gelu(torch.matmul(x, gathered(p["wi_0"]).to(x.dtype)), approximate="tanh")
    h = gate * torch.matmul(x, gathered(p["wi_1"]).to(x.dtype))
    return torch.matmul(h, gathered(p["wo"]).to(h.dtype))


@torch.no_grad()
def t5_encode(params: Params, cfg: T5Config, input_ids: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, L] token ids -> [B, L, dim] encoder states."""
    x = gathered(params["embed"])[input_ids.long()]
    for blk in params["blocks"]:
        h = t5_layer_norm(x, blk["norm1"], cfg.eps)
        x = x + _attention(blk["attn"], cfg, h, attention_mask)
        h = t5_layer_norm(x, blk["norm2"], cfg.eps)
        x = x + _ffn(blk["ffn"], h)
    x = t5_layer_norm(x, params["final_norm"], cfg.eps)
    if attention_mask is not None:
        x = x * attention_mask[..., None].to(x.dtype)
    return x


def init_t5(cfg: T5Config, generator: torch.Generator,
            dtype=torch.float32) -> Params:
    """Random init, i.i.d. N(0,1)*scale per leaf (the JAX package's
    scales), drawn from `generator` on its device."""
    device = generator.device
    d, da, dff = cfg.dim, cfg.dim_attn, cfg.dim_ffn
    hd = da // cfg.num_heads

    def normal(shape, scale, dt=dtype):
        t = torch.empty(shape, dtype=dt, device=device).normal_(generator=generator)
        return t.mul_(scale)

    def ones():
        return torch.ones((d,), dtype=torch.float32, device=device)

    blocks = []
    for _ in range(cfg.num_layers):
        blocks.append({
            "norm1": ones(),
            "attn": {
                "q": normal((d, da), (d * hd) ** -0.5),
                "k": normal((d, da), d ** -0.5),
                "v": normal((d, da), d ** -0.5),
                "o": normal((da, d), (cfg.num_heads * hd) ** -0.5),
                "rel_bias": normal((cfg.num_buckets, cfg.num_heads),
                                   2.0 / math.sqrt(d), torch.float32),
            },
            "norm2": ones(),
            "ffn": {
                "wi_0": normal((d, dff), d ** -0.5),
                "wi_1": normal((d, dff), d ** -0.5),
                "wo": normal((dff, d), dff ** -0.5),
            },
        })
    return {"embed": normal((cfg.vocab, d), 1.0), "final_norm": ones(),
            "blocks": blocks}


def convert_hf_umt5(state_dict, cfg: T5Config, dtype=torch.bfloat16) -> Params:
    """A Hugging Face UMT5EncoderModel state dict (torch tensors or numpy
    arrays) -> this module's params: Linear weights transposed to [in, out]
    in `dtype`, layer norms and relative-position biases in float32 (the
    JAX package's convert_hf_umt5, leaf for leaf)."""
    def g(name):
        t = state_dict[name]
        return (t.detach().to("cpu").float() if isinstance(t, torch.Tensor)
                else torch.from_numpy(np.asarray(t, np.float32)))

    def lin(name):  # torch Linear stores [out, in]
        return g(name).t().contiguous().to(dtype)

    params: Params = {
        "embed": g("shared.weight").to(dtype),
        "final_norm": g("encoder.final_layer_norm.weight"),
        "blocks": [],
    }
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        params["blocks"].append({
            "norm1": g(f"{pre}.0.layer_norm.weight"),
            "attn": {
                "q": lin(f"{pre}.0.SelfAttention.q.weight"),
                "k": lin(f"{pre}.0.SelfAttention.k.weight"),
                "v": lin(f"{pre}.0.SelfAttention.v.weight"),
                "o": lin(f"{pre}.0.SelfAttention.o.weight"),
                "rel_bias": g(f"{pre}.0.SelfAttention.relative_attention_bias.weight"),
            },
            "norm2": g(f"{pre}.1.layer_norm.weight"),
            "ffn": {
                "wi_0": lin(f"{pre}.1.DenseReluDense.wi_0.weight"),
                "wi_1": lin(f"{pre}.1.DenseReluDense.wi_1.weight"),
                "wo": lin(f"{pre}.1.DenseReluDense.wo.weight"),
            },
        })
    return params
