"""Flow-matching training step for the Wan DiT + GeoAdapter.

The counterpart of the JAX package's parallel/train_step.py: rectified-flow
loss, a frozen Wan backbone with a trainable GeoAdapter
branch (or the whole model), block rematerialisation, and
torch.optim.AdamW, whose update equals optax.adamw's (decoupled weight decay
on the pre-update parameter, bias-corrected moments, eps outside the square
root). A step draws its noise level and noise from a threefry key as the
JAX loss does (utils/prng.py: split, then uniform and normal), so the same
key gives both packages the same draws; a test may pass them explicitly.
make_lora_train_step trains LoRA factors (utils/lora.py) over a frozen
base tree instead.

Under a mesh (called inside parallel/sharding.mesh_context, the tree from
shard_dit_params) every rank draws the whole sig and noise from the key,
embeds the whole batch and keeps its [B/dp, S/sp] token slice; the head
gathers the prediction, so the loss is the global mean on every rank. The
gradients are summed over dp and sp (sharding.sync_grads) and the
optimizer updates each rank's own slices.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch

from versecrafter_tpu_torch.core.config import WanDiTConfig
from versecrafter_tpu_torch.models.wan_dit import (
    geoada_patch_embedding, wan_dit_blocks, wan_dit_embed, wan_dit_head)
from versecrafter_tpu_torch.parallel.sharding import constrain_tokens, sync_grads
from versecrafter_tpu_torch.utils import prng

Params = Dict[str, Any]


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict/list tree, in key order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def flow_matching_loss(params: Params, cfg: WanDiTConfig, x0, context, cos, sin,
                       geoada_context, sig, noise, remat: bool = True, lora=None,
                       attn_impl: str = "auto"):
    """Rectified-flow loss: x_sig = (1 - sig) x0 + sig * noise, target
    noise - x0, timestep 1000 * sig, mean squared error in fp32.
    x0 [B, C, F, H, W] latents, sig [B] in [0, 1), noise like x0.
    lora: (factors, scale) applied to the blocks' kernels. attn_impl as in
    models/wan_dit.wan_dit_blocks."""
    sb = sig[:, None, None, None, None].to(x0.dtype)
    x_sig = (1.0 - sb) * x0 + sb * noise
    target = noise - x0
    tokens, e, e0, ctx, _, grid = wan_dit_embed(params, cfg, x_sig, sig * 1000.0, context)
    tokens = constrain_tokens(tokens)
    gtok = None
    if geoada_context is not None and cfg.has_geoadapter:
        gtok = constrain_tokens(geoada_patch_embedding(params, cfg, geoada_context))
    tokens = wan_dit_blocks(params, cfg, tokens, e0, cos, sin, ctx,
                            geoada_tokens=gtok, remat=remat, lora=lora, attn_impl=attn_impl)
    pred = wan_dit_head(params, cfg, tokens, e, grid)
    return (pred.float() - target.float()).square().mean()


def split_trainable(params: Params, geoadapter_only: bool = True
                    ) -> Tuple[Params, Params]:
    """(trainable, frozen) views of the tree: the GeoAdapter branch (every
    top-level `geoada*` entry) trains and the backbone is frozen, or
    everything trains. Sets requires_grad accordingly, so frozen leaves get
    no gradient buffers."""
    train = {k: v for k, v in params.items()
             if not geoadapter_only or k.startswith("geoada")}
    frozen = {k: v for k, v in params.items() if k not in train}
    for leaf in tree_leaves(train):
        leaf.requires_grad_(True)
    for leaf in tree_leaves(frozen):
        leaf.requires_grad_(False)
    return train, frozen


def make_optimizer(train: Params, lr: float = 1e-4, weight_decay: float = 1e-2
                   ) -> torch.optim.AdamW:
    """AdamW over the trainable leaves with optax.adamw's defaults."""
    return torch.optim.AdamW(list(tree_leaves(train)), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def draw_noise(key: torch.Tensor, x0: torch.Tensor):
    """(sig [B] fp32 in [0, 1), noise like x0) from a threefry key, as the
    JAX flow_matching_loss draws them: split, uniform, normal."""
    k_sig, k_eps = prng.split(key.to(x0.device))
    sig = prng.uniform(k_sig, (x0.shape[0],), torch.float32)
    return sig, prng.normal(k_eps, x0.shape, x0.dtype)


def _sig_noise(key, sig, noise, x0):
    if sig is None or noise is None:
        if key is None:
            raise ValueError("train_step needs a key, or both sig and noise")
        drawn_sig, drawn_noise = draw_noise(key, x0)
        sig = drawn_sig if sig is None else sig
        noise = drawn_noise if noise is None else noise
    return sig.to(x0.device), noise.to(x0.device)


def _optimized(optimizer):
    return [t for g in optimizer.param_groups for t in g["params"]]


def make_train_step(cfg: WanDiTConfig, optimizer: torch.optim.Optimizer,
                    attn_impl: str = "auto"):
    """train_step(params, x0, context, cos, sin, geoada_context=None,
    key=None, sig=None, noise=None) -> loss: one optimizer step on the
    leaves the optimizer holds (updated in place), blocks rematerialised.
    sig and noise are drawn from the threefry `key` (utils/prng.key) unless
    both are given."""

    def train_step(params, x0, context, cos, sin, geoada_context=None, key=None,
                   sig=None, noise=None):
        sig, noise = _sig_noise(key, sig, noise, x0)
        optimizer.zero_grad(set_to_none=True)
        loss = flow_matching_loss(params, cfg, x0, context, cos, sin,
                                  geoada_context, sig, noise, attn_impl=attn_impl)
        loss.backward()
        sync_grads(_optimized(optimizer))
        optimizer.step()
        return loss.detach()

    return train_step


def make_lora_train_step(cfg: WanDiTConfig, optimizer: torch.optim.Optimizer,
                         lora_scale: float = 1.0, attn_impl: str = "auto"):
    """train_step(lora, base_params, x0, context, cos, sin,
    geoada_context=None, key=None, sig=None, noise=None) -> loss: one
    optimizer step on the LoRA factors (the optimizer holds them; see
    utils/lora.init_lora). The whole base tree is frozen
    (requires_grad_(False)); each block forms its effective kernels
    kernel + lora_scale * down @ up inside its rematerialised forward, so a
    step holds one block's effective kernels at a time."""

    def train_step(lora, base_params, x0, context, cos, sin, geoada_context=None,
                   key=None, sig=None, noise=None):
        for leaf in tree_leaves(base_params):
            leaf.requires_grad_(False)
        for leaf in tree_leaves(lora):
            leaf.requires_grad_(True)
        sig, noise = _sig_noise(key, sig, noise, x0)
        optimizer.zero_grad(set_to_none=True)
        loss = flow_matching_loss(base_params, cfg, x0, context, cos, sin,
                                  geoada_context, sig, noise, lora=(lora, lora_scale),
                                  attn_impl=attn_impl)
        loss.backward()
        sync_grads(_optimized(optimizer))
        optimizer.step()
        return loss.detach()

    return train_step


def attention_launches_per_step(cfg: WanDiTConfig, lora: bool = False) -> Dict[str, int]:
    """Attention kernel launches of one train step with remat, by kernel
    (the keys of the kernels' LAUNCHES counters): GeoAdapter-only, or with
    `lora` a LoRA step over every block.

    LoRA: every block's q/k/v projections train, so every block, base
    block 0 included, runs self- and cross-attention through the stats
    forward twice (forward, remat recompute) and needs dQ and dK/dV for
    both: 4, 2 and 2 launches a block, and no fused kernel.

    GeoAdapter only: base block 0 of the first superstep sees only frozen
    inputs (tokens from the frozen patch embedding, the frozen text
    embedding), so it runs the fused inference kernels once and is neither
    recomputed nor differentiated. Every other block (all GeoAdapter blocks and the other
    L - 1 base blocks) runs self- and cross-attention through the stats
    forward twice (forward, then the remat recompute) and needs dQ for
    both; dK/dV for self-attention, and for cross-attention only in the
    GeoAdapter blocks, whose K/V projections train (a base block's cross K/V
    come from frozen weights and the frozen context)."""
    g = len(cfg.resolved_geoada_layers)
    if lora:
        n = g + cfg.num_layers
        return {"fused_rope_rms_attention": 0, "fused_rms_cross_attention": 0,
                "flash_attention": 4 * n, "fa_backward_dq": 2 * n,
                "fa_backward_dkv": 2 * n}
    blocks = g + cfg.num_layers - 1
    return {"fused_rope_rms_attention": 1, "fused_rms_cross_attention": 1,
            "flash_attention": 2 * 2 * blocks, "fa_backward_dq": 2 * blocks,
            "fa_backward_dkv": blocks + g}

