"""int8 / int4 weight storage and W8A8 compute for the DiT.

The port's counterpart of the JAX package's utils/quantize.py over the
port's tree, where the blocks are lists of per-block dicts instead of
[L, ...] stacks. A quantized leaf keeps the JAX keys:

- ``qvalues`` int8 [K, N] (or ``q4values`` uint8 [K/2, N]: two signed
  nibbles per byte along the contracting axis, the even row in the low
  nibble);
- ``qscales`` fp32 [1, N] per output channel, or [K/g, 1, N] in g-row
  groups;
- ``qdtype``: a zero-size tensor of the original dtype;
- after tag_int8_compute, ``a_dyn`` (dynamic activation scales) or
  ``a_scale`` (a calibrated per-tensor scale): one fp32 scalar a block;
- on a tensor-parallel shard of a grouped leaf (tp_shard), ``qgroup``:
  int32 [K_shard], the row of the shard's qscales that each code row takes.

Which leaves quantize is decided as the JAX package decides it on its
stacked tree: a leaf of a block list counts its list's length as the
stack's leading axis in MIN_SIZE and in the number of dimensions, so
``quantize_tree(params_from_jax(tree))`` equals
``params_from_jax(quantize_tree(tree))`` bit for bit.

int8_compute_dot quantizes the activations (per row by default, or with one
per-tensor scale), multiplies s8 x s8 -> s32 with ``torch._int_mm`` and
rescales in fp32: ``y.float() * (a * qscales)``, then one cast to the
activations' dtype, as the JAX package rounds it. cuBLASLt's s8 product is
~7x faster with the weight column-major (K contiguous) than row-major on an
H100, so tag_int8_compute stores a W8A8 leaf's qvalues column-major (the
same [K, N] values), and an int4 leaf unpacks straight into that layout.
Under tensor parallelism (tp_shard, parallel/sharding.tp_linear) a
row-parallel product holds its slice of the contracting dim: the per-row
absmax is reduced with MAX over the tp group before the codes are taken,
and the s32 partial products are summed over it before the one fp32
rescale, so the shards' result equals the one-rank product bit for bit.

A division by a constant (qmax, 127) is a multiplication by the constant's
fp32 reciprocal, as XLA compiles the jitted JAX function (and as PyTorch's
CUDA division by a host scalar would do, but not its CPU one), so the CPU
and the card give the JAX package's bits.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

EXCLUDE = ("modulation",)
MIN_SIZE = 1 << 16  # don't quantize tiny leaves

_QKEYS = {"qvalues", "q4values", "qscales", "qdtype", "a_dyn", "a_scale", "qgroup"}

# Block-matmul sites eligible for W8A8 compute (path suffixes under blocks /
# geoada_blocks). Embeddings, the head and the GeoAdapter before / after
# projections stay weight-only.
COMPUTE_SITES = (
    "self_attn/q/kernel", "self_attn/k/kernel", "self_attn/v/kernel",
    "self_attn/o/kernel",
    "cross_attn/q/kernel", "cross_attn/k/kernel", "cross_attn/v/kernel",
    "cross_attn/o/kernel", "cross_attn/k_img/kernel",
    "cross_attn/v_img/kernel",
    "ffn_in/kernel", "ffn_out/kernel",
)

# Dynamic activation scales per row (per token, absmax over the contracting
# dim) when True; one per-tensor absmax when False. A calibrated a_scale is
# per-tensor either way.
ROW_ACT_SCALES = True

# Above this many rows int8_compute_dot runs in row chunks of an eighth of
# it (bit-identical: the scales are row-local, or computed once first), so
# only one chunk's s32 product, fp32 scales and output (10 bytes an output
# element) are alive. 65,520 rows (480x832x81 at CFG-2) is the largest
# shape whose unchunked 14B W8A8 step was measured on the card (PERF.md).
INT8_DOT_CHUNK_ROWS = 65_520

# torch._int_mm on CUDA wants more than 16 rows and K, N multiples of 8
_MM_MIN_ROWS = 17
_MM_ALIGN = 8


def _is_quantized(leaf) -> bool:
    return (isinstance(leaf, dict)
            and ("qvalues" in leaf or "q4values" in leaf)
            and "qscales" in leaf and set(leaf) <= _QKEYS)


def is_compute_tagged(leaf) -> bool:
    """True for a quantized leaf that runs W8A8 (int8_compute_dot)."""
    return _is_quantized(leaf) and ("a_dyn" in leaf or "a_scale" in leaf)


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """t / c for a constant c: t times c's fp32 reciprocal (see the module
    docstring)."""
    return t * torch.full((), 1.0 / c, dtype=torch.float32, device=t.device)


def _quantize_leaf(leaf: torch.Tensor, bits: int, group_size: Optional[int]):
    qmax = 127.0 if bits == 8 else 7.0
    kdim = leaf.shape[-2]
    g = group_size if group_size is not None else (128 if bits == 4 else 0)
    grouped = bool(g) and g < kdim and kdim % g == 0 and g % 2 == 0
    # at most two fp32 copies of the leaf live at once: its values and the codes
    lf = leaf.float()
    if grouped:
        lf = lf.reshape(*leaf.shape[:-2], kdim // g, g, leaf.shape[-1])
    absmax = torch.maximum(lf.amax(dim=-2, keepdim=True), -lf.amin(dim=-2, keepdim=True))
    scale = _div(absmax.clamp_min(1e-8), qmax)  # [..., (K/g,) 1, N]
    q = (lf / scale).round_().clamp_(-qmax, qmax).reshape(leaf.shape)
    del lf
    if bits == 4:
        qu = q.to(torch.int32).bitwise_and_(0xF)  # two's-complement low nibble
        del q
        packed = (qu[..., 1::2, :] << 4).bitwise_or_(qu[..., 0::2, :])
        del qu
        vals = packed.to(torch.uint8)
        key = "q4values"
    else:
        vals = q.to(torch.int8)
        key = "qvalues"
    return {key: vals, "qscales": scale,
            "qdtype": torch.zeros((0,), dtype=leaf.dtype, device=leaf.device)}


def _quantize(tree, bits: int, group_size, path: str, stack: Optional[int]):
    if isinstance(tree, dict):
        return {k: _quantize(v, bits, group_size, f"{path}/{k}" if path else k, stack)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [quantize_block(b, path, len(tree), bits, group_size) for b in tree]
    leaf = tree
    if (not path.endswith("kernel") or not isinstance(leaf, torch.Tensor)
            or leaf.ndim + (stack is not None) < 2 or leaf.numel() * (stack or 1) < MIN_SIZE
            or any(e in path for e in EXCLUDE) or not leaf.is_floating_point()):
        return leaf
    if bits == 4 and leaf.shape[-2] % 2:
        return leaf  # odd contracting dim: can't nibble-pack
    return _quantize_leaf(leaf, bits, group_size)


def _check_bits(bits: int):
    if bits not in (8, 4):
        raise ValueError(f"quantize_bits must be 8 or 4, got {bits}")


def quantize_block(block, group: str, num_blocks: int, bits: int = 8,
                   group_size: Optional[int] = None):
    """One block of the list `group` ("blocks" / "geoada_blocks") of
    `num_blocks` blocks, quantized as quantize_tree quantizes it."""
    _check_bits(bits)
    return _quantize(block, bits, group_size, group, num_blocks)


def quantize_tree(params: Dict[str, Any], bits: int = 8,
                  group_size: Optional[int] = None) -> Dict[str, Any]:
    """A new tree whose big weight leaves (named ``*kernel``, >= 2
    dimensions and >= MIN_SIZE elements counting the block list as a stack,
    floating point, not under ``modulation``) are quantized leaves.
    bits 8: int8 with per-output-channel scales; bits 4: nibble-packed int4,
    with 128-row group scales where the contracting dim allows (an odd one
    is left alone). group_size: None picks that default, 0 forces
    per-channel scales."""
    _check_bits(bits)
    return _quantize(params, bits, group_size, "", None)


def quantize_dit_top(part: Dict[str, Any], bits: int = 8, int8_compute: bool = False,
                     act_scales: Optional[Dict[str, Any]] = None,
                     sites: Optional[tuple] = None) -> Dict[str, Any]:
    """Non-block entries of a DiT tree (a dict of some of its top-level
    keys, no block list among them), quantized as quantize_dit quantizes
    them."""
    top = quantize_tree(part, bits, 0 if (bits == 4 and int8_compute) else None)
    return tag_int8_compute(top, act_scales, sites) if int8_compute else top


def quantize_dit_block(block, group: str, index: int, num_blocks: int, bits: int = 8,
                       int8_compute: bool = False, act_scales=None, sites=None):
    """Block `index` of the list `group` of `num_blocks` blocks, quantized as
    quantize_dit quantizes it."""
    blk = quantize_block(block, group, num_blocks, bits,
                         0 if (bits == 4 and int8_compute) else None)
    return tag_block(blk, group, index, num_blocks, act_scales, sites) if int8_compute else blk


def quantize_dit(params: Dict[str, Any], bits: int = 8, int8_compute: bool = False,
                 act_scales: Optional[Dict[str, Any]] = None,
                 sites: Optional[tuple] = None) -> Dict[str, Any]:
    """The DiT tree `params` quantized in place and returned: quantize_tree
    (bits 4 with per-channel scales under int8_compute, W4A8), then with
    int8_compute tag_int8_compute (`act_scales`, `sites`). The non-block
    leaves are replaced at once, then each entry of the block lists in turn,
    so a block's original is dropped as soon as its quantized copy exists
    unless something else still holds it."""
    lists = {k: v for k, v in params.items() if isinstance(v, list)}
    params.update(quantize_dit_top({k: v for k, v in params.items() if k not in lists},
                                   bits, int8_compute, act_scales, sites))
    for key, blocks in lists.items():
        for i in range(len(blocks)):
            blocks[i] = quantize_dit_block(blocks[i], key, i, len(blocks), bits,
                                           int8_compute, act_scales, sites)
    return params


def _nibbles(packed: torch.Tensor):
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    return torch.where(lo > 7, lo - 16, lo), torch.where(hi > 7, hi - 16, hi)


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., K/2, N] uint8 (two signed nibbles) -> [..., K, N] int8."""
    lo, hi = _nibbles(packed)
    inter = torch.stack([lo, hi], dim=-2)  # [..., K/2, 2, N]
    return inter.reshape(*packed.shape[:-2], packed.shape[-2] * 2, packed.shape[-1])


def _int_values(leaf) -> torch.Tensor:
    return _unpack_int4(leaf["q4values"]) if "q4values" in leaf else leaf["qvalues"]


def _column_major(w: torch.Tensor) -> torch.Tensor:
    """The same [K, N] values with K contiguous."""
    return w if w.stride(0) == 1 else w.t().contiguous().t()


def _product_weight(leaf) -> torch.Tensor:
    """A compute leaf's s8 weight [K, N], column-major (int4 unpacked
    straight into that layout)."""
    if "q4values" in leaf:
        lo, hi = _nibbles(leaf["q4values"].t())  # [N, K/2]
        k2, n = leaf["q4values"].shape
        return torch.stack([lo, hi], dim=-1).reshape(n, 2 * k2).t()
    return _column_major(leaf["qvalues"])


def dequantize_leaf(leaf: Dict[str, Any], dtype=None) -> torch.Tensor:
    """One quantized leaf (int8 or int4, per-channel or grouped scales) as a
    tensor of `dtype` (default: its recorded qdtype)."""
    out_dtype = dtype if dtype is not None else leaf["qdtype"].dtype
    q = _int_values(leaf)
    scale = leaf["qscales"]
    if "qgroup" in leaf:  # a tp shard of a grouped leaf: each row's group
        return (q.float() * scale[..., 0, :].index_select(-2, leaf["qgroup"])).to(out_dtype)
    if scale.ndim == q.ndim + 1:  # grouped [..., K/g, 1, N]
        gct = scale.shape[-3]
        qg = q.float().reshape(*q.shape[:-2], gct, q.shape[-2] // gct, q.shape[-1])
        return (qg * scale).reshape(q.shape).to(out_dtype)
    return (q.float() * scale).to(out_dtype)


def dequantize_tree(params, dtype=None, force: bool = False):
    """The tree with every quantized leaf dequantized (to `dtype`, default
    each leaf's qdtype); compute-tagged leaves stay quantized unless
    `force`. Other leaves are the same tensors."""
    if _is_quantized(params):
        if is_compute_tagged(params) and not force:
            return params
        return dequantize_leaf(params, dtype)
    if isinstance(params, dict):
        return {k: dequantize_tree(v, dtype, force) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [dequantize_tree(v, dtype, force) for v in params]
    return params


def _tag(tree, path: str, index: Optional[int], num_blocks: int, eligible, act_scales):
    if _is_quantized(tree):
        vals = tree.get("qvalues", tree.get("q4values"))
        if (not any(path.endswith(s) for s in eligible) or is_compute_tagged(tree)
                or tree["qscales"].ndim != vals.ndim):
            # group-wise scales: the s8 x s8 product folds one scale per
            # output channel into its epilogue, not K/g of them
            return tree
        dev = tree["qscales"].device
        if "qvalues" in tree:  # the layout of the s8 product's fast path
            tree = {**tree, "qvalues": _column_major(tree["qvalues"])}
        akey = next((k for k in act_scales if path == k or path.endswith("/" + k)), None)
        if akey is None:
            return {**tree, "a_dyn": torch.zeros((), dtype=torch.float32, device=dev)}
        a = torch.as_tensor(act_scales[akey], dtype=torch.float32).to(dev)
        want = () if index is None else (num_blocks,)
        if tuple(a.shape) != want:
            raise ValueError(
                f"act_scales[{akey!r}] has shape {tuple(a.shape)}, expected {want} "
                f"for this tree (calibrated on a different config?)")
        return {**tree, "a_scale": a if index is None else a[index]}
    if isinstance(tree, dict):
        return {k: _tag(v, f"{path}/{k}" if path else k, index, num_blocks, eligible,
                        act_scales)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tag(b, path, i, len(tree), eligible, act_scales) for i, b in enumerate(tree)]
    return tree


def _eligible(sites):
    return (COMPUTE_SITES if sites is None else
            tuple(s for s in COMPUTE_SITES if any(tok in s for tok in sites)))


def tag_block(block, group: str, index: int, num_blocks: int, act_scales=None,
              sites=None):
    """Block `index` of the list `group` of `num_blocks` blocks, tagged as
    tag_int8_compute tags it."""
    return _tag(block, group, index, num_blocks, _eligible(sites), act_scales or {})


def tag_int8_compute(params: Dict[str, Any], act_scales: Optional[Dict[str, Any]] = None,
                     sites: Optional[tuple] = None) -> Dict[str, Any]:
    """Upgrade quantized COMPUTE_SITES leaves of a quantize_tree tree to W8A8.

    act_scales: optional {path suffix: scales} from fit_act_scales, matched
    on whole path components from the right ("blocks/ffn_in/kernel" does
    not match geoada_blocks leaves); a block list's entry is [len(list)],
    given out one scalar a block (a shape mismatch raises ValueError).
    Sites without an entry get dynamic scales (a_dyn). sites: an optional
    substring filter over COMPUTE_SITES. Group-wise leaves are left alone;
    per-channel int4 leaves qualify (W4A8)."""
    return _tag(params, "", None, 1, _eligible(sites), act_scales or {})


def fit_act_scales(stats_list, margin: float = 1.0) -> Dict[str, torch.Tensor]:
    """Calibration stats of one or more forwards ({"blocks": {site: [L]},
    "geoada_blocks": {site: [G]}} absmaxes) -> tag_int8_compute's
    act_scales: the running max over the forwards, times margin / 127."""
    out = {}
    for grp, sites in stats_list[0].items():
        for site in sites:
            acc = torch.stack([s[grp][site] for s in stats_list]).amax(dim=0)
            out[f"{grp}/{site}"] = acc.float() * (margin / 127.0)
    return out


def _int_mm(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """s8 [M, K] x s8 [K, N] -> s32 [M, N], w taken column-major. On CUDA a
    product below torch._int_mm's minimum shape is padded with zero rows /
    columns (which add nothing to the exact integer sums) and sliced back."""
    if xq.device.type != "cuda":
        return torch._int_mm(xq, w)
    m, k = xq.shape
    n = w.shape[1]
    pm, pk, pn = (max(m, _MM_MIN_ROWS), -(-k // _MM_ALIGN) * _MM_ALIGN,
                  -(-n // _MM_ALIGN) * _MM_ALIGN)
    if (pm, pk) != (m, k):
        xq = torch.nn.functional.pad(xq, (0, pk - k, 0, pm - m))
    if (pk, pn) != (k, n):
        w = torch.nn.functional.pad(w, (0, pn - n, 0, pk - k))
    y = torch._int_mm(xq.contiguous(), _column_major(w))
    return y[:m, :n] if (pm, pn) != (m, n) else y


def _all_reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    """t reduced in place over `group` (t itself without one)."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def _quantize_rows(x: torch.Tensor, a_global, group=None):
    """(a, s8 codes of x [M, K]): a is the per-tensor scale a_global, or
    the per-row dynamic scales [M, 1] when it is None, their absmax taken
    over `group` too (the ranks that hold the other slices of K)."""
    if a_global is not None:  # [1, 1], not 0-dim: it must promote x to fp32
        a = a_global.reshape(1, 1)
    else:  # max|x| is one of x's values: exact in x's dtype
        m = torch.linalg.vector_norm(x, float("inf"), dim=-1, keepdim=True).float()
        if group is not None:
            m = _all_reduce(m, group, dist.ReduceOp.MAX)
        a = _div(m.clamp_min(1e-8), 127.0)
    t = torch.div(x, a)  # fp32: x.float() / a in one pass
    return a, t.round_().clamp_(-127, 127).to(torch.int8)


def _rescale(y: torch.Tensor, a: torch.Tensor, qscales: torch.Tensor, dtype) -> torch.Tensor:
    """fp32(y) * (a * qscales), rounded once to fp32 and once to `dtype`:
    the int32 -> fp32 conversion and the output cast happen inside the one
    multiplication."""
    out = torch.empty(y.shape, dtype=dtype, device=y.device)
    return torch.mul(y, a * qscales, out=out)


def _int8_dot_rows(leaf, w: torch.Tensor, x: torch.Tensor, a_global, group=None):
    """One s8 x s8 -> s32 product over rows x [M, K] (a_global: the
    per-tensor scale, or None for per-row dynamic scales). With `group`, x
    and w are this rank's slices of K: the row absmax is reduced with MAX
    and the s32 partial products summed over the group before the rescale."""
    a, xq = _quantize_rows(x, a_global, group)
    y = _int_mm(xq, w)
    if group is not None:
        y = _all_reduce(y.contiguous(), group, dist.ReduceOp.SUM)
    return _rescale(y, a, leaf["qscales"], x.dtype)


def int8_compute_dot(leaf: Dict[str, Any], x: torch.Tensor, row_group=None,
                     tensor_group=None) -> torch.Tensor:
    """W8A8 (or W4A8) product of a compute-tagged leaf ([K, N] after the
    block's own slice; qscales [1, N]) with activations x [..., K].

    Dynamic scales are per row when ROW_ACT_SCALES (else one absmax over x);
    a calibrated a_scale is one per-tensor scale. int4 leaves unpack to s8
    values in [-7, 7] for the same product. Above INT8_DOT_CHUNK_ROWS rows
    the product runs in row chunks, bit-identical.

    Under a mesh: row_group is the tp group of a row-parallel product (x and
    the leaf hold this rank's slice of K; the row absmax is reduced with MAX
    and the s32 partials summed over it); tensor_group the ranks that hold
    the other pieces of x, over which a dynamic per-tensor absmax is
    reduced with MAX."""
    d_in = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d_in)
    rows = x2.shape[0]
    a_global = None
    if "a_scale" in leaf:
        a_global = leaf["a_scale"].float().clamp_min(1e-8)
    elif not ROW_ACT_SCALES:
        m = x2.abs().amax().float()
        a_global = _div(_all_reduce(m, tensor_group, dist.ReduceOp.MAX).clamp_min(1e-8),
                        127.0)
    w = _product_weight(leaf)

    def dot(xc):
        if row_group is None:
            return _int8_dot_rows(leaf, w, xc, a_global)
        return _int8_dot_rows(leaf, w, xc, a_global, row_group)

    if rows > INT8_DOT_CHUNK_ROWS:
        n = -(-rows // max(1, INT8_DOT_CHUNK_ROWS // 8))
        ch = -(-rows // n)
        out = torch.empty((rows, w.shape[-1]), dtype=x.dtype, device=x.device)
        for i in range(0, rows, ch):
            out[i:i + ch] = dot(x2[i:i + ch])
    else:
        out = dot(x2)
    return out.reshape(*lead, w.shape[-1])


def codes(leaf) -> torch.Tensor:
    """A quantized leaf's code tensor (qvalues, or the packed q4values)."""
    return leaf["q4values"] if "q4values" in leaf else leaf["qvalues"]


def _compact(t: torch.Tensor, column_major: bool) -> torch.Tensor:
    return t.t().contiguous().t() if column_major else t.contiguous()


def tp_shard(leaf: Dict[str, Any], kind: str, index: int, count: int) -> Dict[str, Any]:
    """Shard `index` of `count` of a quantized [K, N] leaf at a
    tensor-parallel site, as new compact tensors (a column-major qvalues
    stays column-major). kind 'col': the shard's N / count columns of the
    codes and scales. kind 'row': its K / count rows of the codes (K / (2 *
    count) packed rows of q4values), the per-channel scales whole, and of
    group scales [K/g, 1, N] the rows that cover the shard, a straddled
    group included, with `qgroup` mapping each code row to its scale row.
    qdtype, a_dyn and a_scale are shared."""
    key = "q4values" if "q4values" in leaf else "qvalues"
    c, scales = leaf[key], leaf["qscales"]
    col_major = c.dim() == 2 and c.stride(0) == 1 and c.shape[1] > 1
    out = {k: v for k, v in leaf.items() if k not in (key, "qscales")}
    if kind == "col":
        n = c.shape[-1] // count
        out[key] = _compact(c.narrow(-1, index * n, n), col_major)
        out["qscales"] = scales.narrow(-1, index * n, n).contiguous()
        return out
    if c.shape[-2] % count:
        raise ValueError(f"{c.shape[-2]} rows of {key} do not divide over {count} shards")
    rows = c.shape[-2] // count
    out[key] = _compact(c.narrow(-2, index * rows, rows), col_major)
    kl = rows * (2 if key == "q4values" else 1)
    k0 = index * kl
    if scales.dim() == c.dim() + 1:  # grouped [K/g, 1, N]
        g = kl * count // scales.shape[-3]
        first, last = k0 // g, (k0 + kl - 1) // g
        out["qscales"] = scales.narrow(-3, first, last - first + 1).contiguous()
        out["qgroup"] = (torch.arange(k0, k0 + kl, device=c.device) // g - first).to(torch.int32)
    else:
        out["qscales"] = scales
    return out


def has_quantized(tree) -> bool:
    if _is_quantized(tree):
        return True
    if isinstance(tree, dict):
        return any(has_quantized(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(has_quantized(v) for v in tree)
    return False


def tree_bytes(params) -> int:
    """Bytes of every tensor in the tree."""
    if isinstance(params, dict):
        return sum(tree_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(tree_bytes(v) for v in params)
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0
