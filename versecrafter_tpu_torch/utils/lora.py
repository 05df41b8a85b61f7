"""LoRA: merge / unmerge of LoRA state dicts into the DiT, and LoRA training.

The port's counterpart of the JAX package's utils/lora.py over the port's
tree (block lists instead of [L, ...] stacks):

- merge_lora / unmerge_lora fold W <- W + weight * (up @ down)^T into the
  kernels, the delta formed as the JAX package forms it (numpy fp32
  ``(up @ down).T``, times the weight, cast to the kernel's dtype, one add
  in that dtype), so merged leaves are bit for bit the JAX package's.
  State dicts may use dotted names (``blocks.0.self_attn.q.lora_down.weight``,
  PEFT ``lora_A`` / ``lora_B``) or underscore-only ones
  (``lora_unet_blocks_0_self_attn_q``). The JAX package turns every ``_`` of
  the latter into ``.``, so ``self_attn`` / ``cross_attn`` / ``geoada_blocks``
  no longer match and those pairs are dropped; here the module names are
  mapped back, and a pair that still matches no kernel is named in a
  logged warning.
- init_lora draws the factors with utils/prng from a threefry key, as the
  JAX package draws them: {group: {"self_attn/q": {"down": [L, K, r],
  "up": [L, r, N] (zeros)}}}; apply_lora_tree forms the effective kernels
  (fp32 delta, one cast); lora_block does so for one block (the train step
  calls it inside each rematerialised block); lora_to_torch_sd exports the
  factors in the dotted naming merge_lora reads.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from versecrafter_tpu_torch.utils import prng

log = logging.getLogger(__name__)

_TORCH_TO_TREE = {
    r"blocks\.(\d+)\.self_attn\.(q|k|v|o)": ("blocks", "self_attn", "{m2}"),
    r"blocks\.(\d+)\.cross_attn\.(q|k|v|o)": ("blocks", "cross_attn", "{m2}"),
    r"blocks\.(\d+)\.ffn\.0": ("blocks", "ffn_in"),
    r"blocks\.(\d+)\.ffn\.2": ("blocks", "ffn_out"),
    r"geoada_blocks\.(\d+)\.self_attn\.(q|k|v|o)": ("geoada_blocks", "self_attn", "{m2}"),
    r"geoada_blocks\.(\d+)\.cross_attn\.(q|k|v|o)": ("geoada_blocks", "cross_attn", "{m2}"),
    r"geoada_blocks\.(\d+)\.ffn\.0": ("geoada_blocks", "ffn_in"),
    r"geoada_blocks\.(\d+)\.ffn\.2": ("geoada_blocks", "ffn_out"),
}

# module names that hold an underscore of their own
_UNDERSCORED = ("geoada_blocks", "self_attn", "cross_attn")

_MARKERS = ((".lora_down.weight", "down"), (".lora_up.weight", "up"),
            (".lora_A.weight", "down"), (".lora_B.weight", "up"),
            (".lora_A.default.weight", "down"), (".lora_B.default.weight", "up"))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu").float().numpy()
    return np.asarray(t)


def _collect_pairs(lora_sd) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """-> {module name: (down [r, in], up [out, r])} from either naming."""
    pairs: Dict[str, dict] = {}
    for k in lora_sd.keys():
        for marker, slot in _MARKERS:
            if k.endswith(marker):
                mod = re.sub(r"^(lora_unet_|transformer\.|diffusion_model\.)", "",
                             k[: -len(marker)])
                if "." not in mod:
                    mod = mod.replace("_", ".")
                    for name in _UNDERSCORED:
                        mod = mod.replace(name.replace("_", "."), name)
                pairs.setdefault(mod, {})[slot] = _np(lora_sd[k])
                break
    return {m: (d["down"], d["up"]) for m, d in pairs.items()
            if "down" in d and "up" in d}


def _copy_structure(tree):
    """New dicts and lists over the same tensors."""
    if isinstance(tree, dict):
        return {k: _copy_structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_structure(v) for v in tree]
    return tree


def _target(params, mod: str) -> Optional[dict]:
    """The {"kernel", ...} node a LoRA module name points at, or None."""
    for pat, path in _TORCH_TO_TREE.items():
        m = re.match(pat + r"$", mod)
        if not m:
            continue
        blocks, layer = params.get(path[0], []), int(m.group(1))
        if layer >= len(blocks):
            return None
        node = blocks[layer]
        for k in path[1:]:
            node = node[k.format(m2=m.group(2)) if "{m2}" in k else k]
        return node
    return None


def merge_lora(params: Dict[str, Any], lora_sd, weight: float = 1.0,
               sign: float = 1.0) -> Dict[str, Any]:
    """A new tree with the LoRA deltas folded into the kernels."""
    params = _copy_structure(params)
    unmatched = []
    for mod, (down, up) in _collect_pairs(lora_sd).items():
        node = _target(params, mod)
        if node is None:
            unmatched.append(mod)
            continue
        kern = node["kernel"]
        delta = (sign * weight) * (up @ down).T  # [in, out], numpy fp32
        if delta.shape != tuple(kern.shape):
            raise ValueError(f"LoRA {mod}: delta {delta.shape} does not fit the kernel "
                             f"{tuple(kern.shape)}")
        node["kernel"] = kern + torch.from_numpy(np.ascontiguousarray(delta)).to(
            device=kern.device, dtype=kern.dtype)
    if unmatched:
        log.warning("merge_lora: %d LoRA pair(s) match no kernel and were not merged: %s",
                    len(unmatched), sorted(unmatched))
    return params


def unmerge_lora(params, lora_sd, weight: float = 1.0):
    return merge_lora(params, lora_sd, weight=weight, sign=-1.0)


LORA_TARGETS = (
    ("self_attn", "q"), ("self_attn", "k"), ("self_attn", "v"),
    ("self_attn", "o"),
    ("cross_attn", "q"), ("cross_attn", "k"), ("cross_attn", "v"),
    ("cross_attn", "o"),
    ("ffn_in",), ("ffn_out",),
)

_TREE_TO_TORCH = {
    ("self_attn", "q"): "self_attn.q", ("self_attn", "k"): "self_attn.k",
    ("self_attn", "v"): "self_attn.v", ("self_attn", "o"): "self_attn.o",
    ("cross_attn", "q"): "cross_attn.q", ("cross_attn", "k"): "cross_attn.k",
    ("cross_attn", "v"): "cross_attn.v", ("cross_attn", "o"): "cross_attn.o",
    ("ffn_in",): "ffn.0", ("ffn_out",): "ffn.2",
}


def _node(block, target):
    for k in target:
        block = block[k]
    return block


def init_lora(params: Dict[str, Any], rank: int, key: torch.Tensor,
              groups=("blocks",), targets=LORA_TARGETS, dtype=None) -> Dict[str, Any]:
    """LoRA factors for each target kernel [K, N] of each block list:
    down [L, K, r] = normal * (1 / sqrt(K)) drawn from the threefry key
    (split into one key per group and target, as the JAX package splits
    it), up [L, r, N] zeros (the adapter starts as an exact no-op); in
    `dtype` (default the kernel's), on the kernels' device."""
    out: Dict[str, Any] = {}
    keys = prng.split(key, len(groups) * len(targets))
    i = 0
    for g in groups:
        if g not in params:
            continue
        out[g] = {}
        for t in targets:
            kern = _node(params[g][0], t)["kernel"]
            (K, N), L = kern.shape, len(params[g])
            dt = dtype or kern.dtype
            scale = torch.tensor(1.0 / np.sqrt(K), dtype=torch.float32, device=kern.device)
            down = (prng.normal(keys[i].to(kern.device), (L, K, rank), torch.float32)
                    * scale).to(dt)
            out[g]["/".join(t)] = {"down": down,
                                   "up": torch.zeros((L, rank, N), dtype=dt,
                                                     device=kern.device)}
            i += 1
    return out


def lora_kernel(kern: torch.Tensor, down: torch.Tensor, up: torch.Tensor,
                scale: float) -> torch.Tensor:
    """kern + scale * down @ up, in fp32, cast once to the kernel's dtype
    (differentiable through the factors)."""
    return (kern.float() + scale * (down.float() @ up.float())).to(kern.dtype)


def block_factors(lora, group: str, i: int):
    """(block i's {target: (down, up)}, scale) of a (factors, scale) pair,
    or None (no LoRA, or none on this group)."""
    if lora is None or group not in lora[0]:
        return None
    tree, scale = lora
    return {t: (f["down"][i], f["up"][i]) for t, f in tree[group].items()}, scale


def lora_block(block: Dict[str, Any], factors: Dict[str, Any], scale: float):
    """One block with its effective kernels."""
    block = _copy_structure(block)
    for t, (down, up) in factors.items():
        node = _node(block, t.split("/"))
        node["kernel"] = lora_kernel(node["kernel"], down, up, scale)
    return block


def apply_lora_tree(params: Dict[str, Any], lora: Dict[str, Any],
                    scale: float = 1.0) -> Dict[str, Any]:
    """The tree with every target kernel replaced by its effective kernel."""
    params = _copy_structure(params)
    for g in lora:
        params[g] = [lora_block(b, block_factors((lora, scale), g, i)[0], scale)
                     for i, b in enumerate(params[g])]
    return params


def lora_to_torch_sd(lora: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The factors in the naming merge_lora reads, fp32 on the host:
    {group}.{i}.<module>.lora_down.weight [r, K] and .lora_up.weight [N, r]
    (so that (up @ down).T == down_i @ up_i)."""
    sd: Dict[str, torch.Tensor] = {}
    for g, mods in lora.items():
        for tkey, dw in mods.items():
            torch_mod = _TREE_TO_TORCH[tuple(tkey.split("/"))]
            down = dw["down"].detach().float().cpu()
            up = dw["up"].detach().float().cpu()
            for layer in range(down.shape[0]):
                base = f"{g}.{layer}.{torch_mod}"
                sd[f"{base}.lora_down.weight"] = down[layer].t().contiguous()
                sd[f"{base}.lora_up.weight"] = up[layer].t().contiguous()
    return sd
