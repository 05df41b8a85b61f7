"""Parallelism by hand: the mesh context, parameter shards, and the
collectives that the JAX package's GSPMD inserts on its own.

The counterpart of the JAX package's parallel/sharding.py, as one process
per GPU with explicit collectives over the mesh's groups (core/mesh.py):

- tokens: under a mesh each rank holds its [B/dp, S/sp, D] slice of the
  DiT's token activations (constrain_tokens), the RoPE tables cut to the
  same sequence slice (local_seq) and the per-row conditioning to the same
  rows (local_rows); the head's output is gathered over sp and dp
  (gather_tokens), so every rank ends a forward with the whole prediction;
- parameters: shard_dit_params keeps each rank's slice of the leaves the
  rule table (dit_param_pspecs) shards, and leaves the rest whole. A
  sharded leaf carries its spec (SPEC_ATTR). gathered() all-gathers it at
  use over its axes (FSDP: ZeRO-3 at use); tp_linear runs the block's
  tensor-parallel sites: q / k / v / k_img / v_img / ffn_in column-parallel
  (heads or hidden split over tp), o / ffn_out row-parallel, summed over tp;
  tp_rms_norm sums the q / k RMSNorm's squares over tp before the rsqrt,
  since WanRMSNorm spans every head's channels;
- attention: sequence_parallel_attention picks Ulysses (all_to_all over sp,
  the plain flash kernel over the whole sequence on N / (tp * sp) heads,
  all_to_all back) when the local head count divides by sp, else the ring
  (kernels/ring_attention.py); sp_cross_attention attends each sequence
  shard to the whole (short) context without a collective.

Gradients follow one rule: each rank's backward gives the gradient of the
(replicated) loss through its own tokens, and sync_grads sums every
trainable leaf's gradient over dp and sp. Inside a tp group the
column-parallel input's gradient is summed in the backward, the row-parallel
output's passes through, and a whole leaf used in tp slices gathers its
slices' gradients. fsdp does not split the tokens (the JAX package's token
spec is (dp, sp, None)), so the fsdp ranks compute the same gradients and a
gathered weight's backward keeps the rank's own slice without a collective.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from versecrafter_tpu_torch.core.mesh import AXES, Mesh
from versecrafter_tpu_torch.kernels.flash_attention import flash_attention

# the attribute a sharded leaf carries: per dimension None (whole), an axis
# name, or AXES (every axis, the world)
SPEC_ATTR = "_vc_shard_spec"
# the text encoder's leaves below this many elements stay whole
T5_SHARD_MIN = 1 << 16

_STATE = threading.local()


@contextlib.contextmanager
def mesh_context(mesh: Optional[Mesh]):
    """Install the mesh the model's collectives use (None: none)."""
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def current_mesh() -> Optional[Mesh]:
    return getattr(_STATE, "mesh", None)


def active_mesh() -> Optional[Mesh]:
    """The current mesh when it spans more than one rank, else None."""
    mesh = current_mesh()
    return mesh if mesh is not None and mesh.size > 1 else None


def _require_mesh() -> Mesh:
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("a sharded leaf was used outside mesh_context")
    return mesh


def _axes(names) -> Tuple[str, ...]:
    return tuple(names) if isinstance(names, tuple) else (names,)


def _axis_size(mesh: Mesh, names) -> int:
    n = 1
    for a in _axes(names):
        n *= mesh.shape[a]
    return n


def _axis_index(mesh: Mesh, names) -> int:
    """This rank's index along the (row-major) product of `names`."""
    i = 0
    for a in _axes(names):
        i = i * mesh.shape[a] + mesh.coord[a]
    return i


# ---------------------------------------------------------------------------
# collectives with their gradients
# ---------------------------------------------------------------------------

def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    return x.chunk(n, dim=dim)[dist.get_rank(group)]


class _Gather(torch.autograd.Function):
    """All-gather along `dim`; the backward keeps this rank's slice (the
    group's ranks compute the same downstream gradient)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.group, ctx.dim).contiguous(), None, None


class _Slice(torch.autograd.Function):
    """This rank's slice of a whole tensor along `dim`; the backward
    gathers the slices' gradients, so every rank of the group holds the
    whole leaf's gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _chunk(x, group, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _SumForward(torch.autograd.Function):
    """all_reduce(sum) of partial results into a replicated one; the
    gradient passes through (row-parallel output)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group
    (column-parallel input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumBoth(torch.autograd.Function):
    """all_reduce(sum) whose consumers are split over the group (the RMS
    statistic of tp-split channels): the backward sums too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllToAll(torch.autograd.Function):
    """all_to_all_single of x [n, ...] over an n-rank group: chunk j goes
    to rank j, out[j] comes from rank j. Its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


# ---------------------------------------------------------------------------
# parameter shardings
# ---------------------------------------------------------------------------

def _spec_for(names, ndim: int) -> Tuple:
    """The JAX package's rule for one leaf (its layer axis aside): () for a
    whole leaf, else one entry per dimension."""
    joined = ".".join(str(n) for n in names)
    if "modulation" in joined or ndim != 2:
        return ()
    if any(s in joined for s in (".q.", ".k.", ".v.", "k_img", "v_img", "ffn_in", "qkv")):
        return ("fsdp", "tp")
    if any(s in joined for s in (".o.", "ffn_out", "proj")):
        return ("tp", "fsdp")
    return ("fsdp", None)


def _is_quantized_leaf(tree) -> bool:
    return isinstance(tree, dict) and "q" in tree and "scale" in tree


def _map_with_path(fn, tree, path=()):
    if _is_quantized_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def dit_param_pspecs(params: Dict[str, Any]) -> Dict[str, Any]:
    """The spec tree of a DiT tree (same structure): block matrices shard
    their contracting dim over fsdp and their output dim over tp for q / k
    / v / k_img / v_img / ffn_in, the reverse for o / ffn_out and the
    projections; the embeddings, head and text / time projections shard
    their first dim over fsdp; biases, norms and modulation stay whole."""
    return _map_with_path(
        lambda path, leaf: () if isinstance(leaf, dict) else _spec_for(path, leaf.ndim),
        params)


def _divisible(shape, spec, mesh: Mesh) -> bool:
    return all(names is None or dim % _axis_size(mesh, names) == 0
               for dim, names in zip(shape, spec))


def _local_slice(leaf: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a whole leaf, a fresh tensor that carries
    `spec`, or the leaf itself when no axis of spec splits it."""
    if not any(names is not None and _axis_size(mesh, names) > 1 for names in spec):
        return leaf
    t = leaf.detach()
    for dim, names in enumerate(spec):
        if names is not None:
            n = _axis_size(mesh, names)
            t = t.chunk(n, dim=dim)[_axis_index(mesh, names)]
    out = t.clone().requires_grad_(leaf.requires_grad)
    setattr(out, SPEC_ATTR, tuple(spec))
    return out


def shard_dit_params(params, mesh: Mesh):
    """Each rank's slices of the DiT tree under dit_param_pspecs; a leaf
    whose sharded dims do not divide stays whole, as do quantized leaves."""
    def place(path, leaf):
        if isinstance(leaf, dict):
            return leaf
        spec = _spec_for(path, leaf.ndim)
        if spec and _divisible(leaf.shape, spec, mesh):
            return _local_slice(leaf, spec, mesh)
        return leaf
    return _map_with_path(place, params)


def shard_t5_params(params, mesh: Mesh):
    """The text encoder FSDP-style over every axis of the mesh (the
    reference's fsdp_text_encoder default): each 2-D leaf of at least
    T5_SHARD_MIN elements is split on its first dim that the world divides;
    gathered at use by models/t5.py."""
    def place(path, leaf):
        if isinstance(leaf, torch.Tensor) and leaf.ndim == 2 and leaf.numel() >= T5_SHARD_MIN:
            for d in (0, 1):
                spec = tuple(AXES if i == d else None for i in range(2))
                if _divisible(leaf.shape, spec, mesh):
                    return _local_slice(leaf, spec, mesh)
        return leaf
    return _map_with_path(place, params)


def gathered(t, keep: Tuple[str, ...] = ()):
    """A sharded leaf made whole at use (all-gathered over each of its
    axes but those in `keep`); any other value unchanged."""
    spec = getattr(t, SPEC_ATTR, None)
    if spec is None:
        return t
    mesh = _require_mesh()
    for dim, names in enumerate(spec):
        if names is None or names in keep or _axis_size(mesh, names) == 1:
            continue
        t = _Gather.apply(t, mesh.group(names), dim)
    return t


def is_sharded(t) -> bool:
    return getattr(t, SPEC_ATTR, None) is not None


def check_dit_mesh(cfg, mesh: Mesh, *trees) -> None:
    """What the DiT's hand-written tensor parallelism needs: whole heads
    and FFN columns per tp rank, and unquantized block kernels under tp."""
    tp = mesh.shape["tp"]
    if cfg.num_heads % tp or cfg.ffn_dim % tp:
        raise ValueError(f"tp={tp} must divide num_heads {cfg.num_heads} and "
                         f"ffn_dim {cfg.ffn_dim}")
    if tp > 1:
        from versecrafter_tpu_torch.utils.quantize import has_quantized
        if any(t is not None and has_quantized(t) for t in trees):
            raise ValueError("a quantized DiT runs under dp / fsdp / sp only, not tp > 1")


# ---------------------------------------------------------------------------
# tokens
# ---------------------------------------------------------------------------

def _split(x: torch.Tensor, mesh: Mesh, axis: str, dim: int, what: str) -> torch.Tensor:
    n = mesh.shape[axis]
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"{what} of size {x.shape[dim]} does not divide over {axis}={n} "
                         "(the sequence-parallel path needs even shards)")
    return x.chunk(n, dim=dim)[mesh.coord[axis]]


def local_rows(x):
    """This rank's dp rows of a per-row tensor [B, ...] (None stays None)."""
    mesh = active_mesh()
    if mesh is None or x is None:
        return x
    return _split(x, mesh, "dp", 0, "batch")


def local_seq(x: torch.Tensor) -> torch.Tensor:
    """This rank's sp slice of a per-token table [S, ...] (RoPE cos / sin)."""
    mesh = active_mesh()
    if mesh is None:
        return x
    return _split(x, mesh, "sp", 0, "sequence")


def constrain_tokens(x):
    """This rank's [B/dp, S/sp, ...] slice of token activations [B, S, ...]
    under a mesh (a quantized residual {"q", "scale"} slice by slice); x
    itself without one. Raises ValueError where B % dp or S % sp is not 0,
    as the JAX package's sequence-parallel shard_map does."""
    mesh = active_mesh()
    if mesh is None or x is None:
        return x
    if isinstance(x, dict):
        return {k: constrain_tokens(v) for k, v in x.items()}
    return _split(_split(x, mesh, "dp", 0, "batch"), mesh, "sp", 1, "sequence")


def gather_tokens(x: torch.Tensor) -> torch.Tensor:
    """The whole [B, S, ...] from every rank's [B/dp, S/sp, ...] slice."""
    mesh = active_mesh()
    if mesh is None:
        return x
    if mesh.shape["sp"] > 1:
        x = _Gather.apply(x, mesh.group("sp"), 1)
    if mesh.shape["dp"] > 1:
        x = _Gather.apply(x, mesh.group("dp"), 0)
    return x


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

def tp_slice(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This tp rank's slice of a whole tensor (gradients gathered back)."""
    mesh = active_mesh()
    if mesh is None or mesh.shape["tp"] == 1:
        return t
    return _Slice.apply(t, mesh.group("tp"), dim)


def tp_linear(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    """A block projection under the mesh: kind 'col' (x whole, the output's
    tp slice) or 'row' (x's tp slice of channels, the output summed over
    tp). The kernel is gathered over fsdp; a whole kernel is sliced."""
    mesh = _require_mesh()
    tp = mesh.shape["tp"]
    k, b = p["kernel"], p.get("bias")
    if isinstance(k, dict):
        if tp > 1:
            raise ValueError("a quantized kernel under tp > 1")
        from versecrafter_tpu_torch.utils import quantize as qz
        y = (qz.int8_compute_dot(k, x) if qz.is_compute_tagged(k)
             else torch.matmul(x, qz.dequantize_leaf(k, x.dtype)))
        return y + b.to(y.dtype) if b is not None else y
    sharded = is_sharded(k)
    k = gathered(k, keep=("tp",))
    if kind == "col":
        if not sharded:
            k = tp_slice(k, 1)
        if tp > 1:
            x = _SumBackward.apply(x, mesh.group("tp"))
        y = torch.matmul(x, k.to(x.dtype))
        return y + tp_slice(b, 0).to(y.dtype) if b is not None else y
    if not sharded:
        k = tp_slice(k, 0)
    y = torch.matmul(x, k.to(x.dtype))
    if tp > 1:
        y = _SumForward.apply(y, mesh.group("tp"))
    return y + b.to(y.dtype) if b is not None else y


def tp_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, dim: int) -> torch.Tensor:
    """kernels/norms.rms_norm of a tensor whose last axis is this tp rank's
    slice of `dim` channels: the sum of squares is summed over tp before
    the rsqrt."""
    mesh = _require_mesh()
    xf = x.float()
    ss = xf.square().sum(-1, keepdim=True)
    if mesh.shape["tp"] > 1:
        ss = _SumBoth.apply(ss, mesh.group("tp"))
    y = xf * torch.rsqrt(ss / dim + eps)
    return (y * tp_slice(weight, 0).float()).to(x.dtype)


# ---------------------------------------------------------------------------
# sequence-parallel attention
# ---------------------------------------------------------------------------

def ulysses_attention(q, k, v, window_size=(-1, -1)) -> torch.Tensor:
    """Self-attention of this rank's [B, N/tp, S/sp, D] shards: all_to_all
    over sp to [B, N/(tp*sp), S, D], the flash kernel over the whole
    sequence (a window applies unchanged), all_to_all back. Needs
    (N/tp) % sp == 0."""
    mesh = active_mesh()
    n = 1 if mesh is None else mesh.shape["sp"]
    if n == 1:
        return flash_attention(q, k, v, window_size=window_size)
    group = mesh.group("sp")
    b, nh, sl, d = q.shape

    def scatter_heads(t):  # [B, N, S/sp, D] -> [B, N/sp, S, D]
        t = t.reshape(b, n, nh // n, sl, d).permute(1, 0, 2, 3, 4)
        return _AllToAll.apply(t.contiguous(), group).permute(1, 2, 0, 3, 4).reshape(
            b, nh // n, n * sl, d)

    o = flash_attention(scatter_heads(q), scatter_heads(k), scatter_heads(v),
                        window_size=window_size)
    o = o.reshape(b, nh // n, n, sl, d).permute(2, 0, 1, 3, 4)
    return _AllToAll.apply(o.contiguous(), group).permute(1, 0, 2, 3, 4).reshape(b, nh, sl, d)


def ring_sp_attention(q, k, v) -> torch.Tensor:
    """Self-attention of the sp shards by rotating K/V around the sp group
    (kernels/ring_attention.py): no head-count constraint."""
    mesh = active_mesh()
    if mesh is None or mesh.shape["sp"] == 1:
        return ulysses_attention(q, k, v)
    from versecrafter_tpu_torch.kernels.ring_attention import ring_attention
    return ring_attention(q, k, v, mesh.group("sp"), mesh.global_ranks("sp"))


def sequence_parallel_attention(q, k, v, window_size=(-1, -1)) -> torch.Tensor:
    """Ulysses when this rank's head count divides by sp, else the ring. A
    window needs the Ulysses path (the ring's merge has no per-shard window
    offsets)."""
    mesh = active_mesh()
    if mesh is None:
        return flash_attention(q, k, v, window_size=window_size)
    sp = mesh.shape["sp"]
    heads_local = q.shape[1]
    windowed = tuple(window_size) != (-1, -1)
    if heads_local % sp == 0:
        return ulysses_attention(q, k, v, window_size=window_size)
    if windowed:
        raise NotImplementedError(
            f"window_size={tuple(window_size)} with sp={sp} needs "
            f"the Ulysses path, but heads/tp={heads_local} is not divisible "
            f"by sp (ring attention does not support windows)")
    return ring_sp_attention(q, k, v)


def sp_cross_attention(q, k, v) -> torch.Tensor:
    """Cross-attention of a query sequence shard against the whole short
    context: no collective, each shard attends locally."""
    return flash_attention(q, k, v)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def sync_grads(leaves) -> None:
    """Sum each leaf's gradient over dp and sp (the ranks that hold other
    tokens); tp and fsdp ranks hold their own slices' gradients already."""
    mesh = active_mesh()
    if mesh is None:
        return
    for axis in ("dp", "sp"):
        if mesh.shape[axis] == 1:
            continue
        for t in leaves:
            if t.grad is not None:
                dist.all_reduce(t.grad, group=mesh.group(axis))
