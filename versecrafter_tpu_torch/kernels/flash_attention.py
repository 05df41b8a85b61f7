"""Attention kernels' wrappers, their plain PyTorch versions, and the
attention reference math.

Fused qk-RMSNorm (+ RoPE) attention (csrc/fused_attention.cu; the bf16
and int8 flavors on wgmma with TMA-fed tiles, on the persistent schedule of
csrc/attention_wgmma.cuh). Both
fused flavors take the RAW q/k/v projections in their flat [B, S, N*D]
layout. The per-row RMS statistic spans all heads, so the wrapper computes it
outside the kernel (rq = rsqrt(mean(q^2)+eps) * sm_scale * log2(e), rk
likewise without the scale); the per-head norm scale and the RoPE rotation
run inside the kernel's tile prologue. The plain version computes the same function with the
same rounding points (q~/k~ rounded once after norm+rotate, bf16 interleaved
tables, l from fp32 P, PV on P cast to v's dtype). The fused kernel is
inference only: when grad is enabled and an input needs a gradient, the fused
functions run the unfused math through the differentiable `flash_attention`.
The statistics may also come from the projection's matmul epilogue
(kernels/matmul_stat.py): `rstats=(rq, rk)` / `rq=`. The RoPE flavor has an
int8 variant (`int8_score`): q~/k~ are quantized per (row, head) to int8,
QK^T is an s8 x s8 -> s32 product, and the scales multiply back before the
softmax; PV stays bf16.

Plain flash attention (csrc/flash_attention.cu) over head-major
[B, N, S, D], with k_lens masking and a (left, right) window, in two
flavors: inference (exp2, sm_scale*log2(e) folded into q) and stats
(natural-log exp, sm_scale folded into q, also returns the row max m and sum
l). Under autograd it is a torch.autograd.Function whose forward is the stats
flavor and whose backward is kernels/flash_attention_bwd.fa_backward.

On a CUDA tensor every wrapper launches its kernel or raises; only a CPU
tensor takes the plain version. Outputs are fresh tensors; inputs are never
written.

The entry points (flash_attention and the two fused functions) take
`impl`, the JAX package's attn_impl: 'auto' (the above), 'pallas' (the
hand-written kernels, ValueError on a CPU tensor) or 'xla' (the reference
math, attention_reference behind unfused norm and RoPE passes, on any
device, differentiable through autograd).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from versecrafter_tpu_torch.kernels import _build
from versecrafter_tpu_torch.kernels.norms import rms_norm
from versecrafter_tpu_torch.kernels.rope import (_pairswap, apply_rope,
                                                 interleave_rope_tables)

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
LOG2E = math.log2(math.e)
HEAD_DIM = 128          # the only head_dim the kernel takes
TABLE_ROW_ALIGN = 128   # rope tables are padded to this many rows
FUSED_TILE = 128        # the fused kernel's q rows and keys per tile (int8
                        # k scales pad to it)

# Kernel launches per kernel since the last reset (comparison launches are
# counted too; a caller measuring a path resets first). "flash_attention"
# counts both flavors of the plain forward; the RoPE flavor's int8 variant
# has a count of its own.
LAUNCHES = {"fused_rope_rms_attention": 0, "fused_rope_rms_attention_int8": 0,
            "fused_rms_cross_attention": 0, "flash_attention": 0}


ATTN_IMPLS = ("auto", "pallas", "xla")


def check_impl(impl: str, t: torch.Tensor) -> None:
    """ValueError for an unknown attn_impl, or 'pallas' on a tensor the
    CUDA kernels cannot take."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {impl!r}: expected one of {ATTN_IMPLS}")
    if impl == "pallas" and not t.is_cuda:
        raise ValueError(f"attn_impl 'pallas' runs the CUDA kernels, but the tensors "
                         f"are on {t.device.type}")


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def attention_reference(q, k, v, k_lens=None, sm_scale=None,
                        window_size=(-1, -1)):
    """Reference attention over [B, N, S, D] with fp32 softmax, optional
    per-batch KV lengths and a (left, right) window (-1 = unbounded)."""
    B, N, Sq, D = q.shape
    Skv = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float()) * sm_scale
    if k_lens is not None:
        col = torch.arange(Skv, device=q.device)
        ok = col[None, :] < k_lens.to(q.device)[:, None]
        s = s.masked_fill(~ok[:, None, None, :], NEG_INF)
    wl, wr = window_size
    if wl >= 0 or wr >= 0:
        rel = (torch.arange(Skv, device=q.device)[None, :]
               - torch.arange(Sq, device=q.device)[:, None])
        ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
        if wl >= 0:
            ok &= rel >= -wl
        if wr >= 0:
            ok &= rel <= wr
        s = s.masked_fill(~ok[None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bnqk,bnkd->bnqd", p, v.float()).to(q.dtype)


def visible_keys(i0: int, i1: int, skv: int, k_len: torch.Tensor,
                 window_size) -> torch.Tensor:
    """[B, 1, i1-i0, Skv] bool: key j is visible to query row i when
    j < k_len[b] and j lies inside row i's (left, right) window."""
    col = torch.arange(skv, device=k_len.device)
    ok = (col[None, :] < k_len[:, None])[:, None, None, :]
    wl, wr = window_size
    if wl >= 0 or wr >= 0:
        rel = col[None, :] - torch.arange(i0, i1, device=k_len.device)[:, None]
        win = torch.ones_like(rel, dtype=torch.bool)
        if wl >= 0:
            win &= rel >= -wl
        if wr >= 0:
            win &= rel <= wr
        ok = ok & win[None, None]
    return ok


def _key_lengths(k_lens, b: int, skv: int, device) -> torch.Tensor:
    if k_lens is None:
        return torch.full((b,), skv, dtype=torch.int32, device=device)
    return k_lens.to(device=device, dtype=torch.int32).clamp(0, skv)


def flash_attention_plain(q, k, v, k_lens=None, sm_scale=None,
                          window_size=(-1, -1), stats: bool = False,
                          chunk: int = 512):
    """Plain PyTorch version of the flash-attention kernel over head-major
    [B, N, S, D], over chunks of query rows. q is scaled once and rounded to
    its dtype (sm_scale for stats=True, natural-log exp; sm_scale*log2(e)
    otherwise, exp2); P is rounded to v's dtype before PV and l summed from
    the fp32 P. A row that sees no key writes 0, m = NEG_INF and l = 0.
    Returns out, or (out, m, l) with m, l fp32 [B, N, Sq] when stats."""
    B, N, Sq, D = q.shape
    Skv = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    scale = sm_scale if stats else sm_scale * LOG2E
    exp = torch.exp if stats else torch.exp2
    qs = (q.float() * scale).to(q.dtype)
    kf, vf = k.float(), v.float()
    k_len = _key_lengths(k_lens, B, Skv, q.device)
    out = torch.empty_like(q)
    m_all = torch.empty((B, N, Sq), dtype=torch.float32, device=q.device)
    l_all = torch.empty_like(m_all)
    for i0 in range(0, Sq, chunk):
        i1 = min(Sq, i0 + chunk)
        ok = visible_keys(i0, i1, Skv, k_len, window_size)
        s = torch.matmul(qs[:, :, i0:i1].float(), kf.transpose(-1, -2))
        s = s.masked_fill(~ok, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.where(ok, exp(s - m), torch.zeros((), device=q.device))
        l = p.sum(-1, keepdim=True)
        o = torch.matmul(p.to(v.dtype).float(), vf)
        o = o * torch.where(l == 0, torch.ones_like(l), 1.0 / l)
        out[:, :, i0:i1] = o.to(q.dtype)
        m_all[:, :, i0:i1] = m[..., 0]
        l_all[:, :, i0:i1] = l[..., 0]
    return (out, m_all, l_all) if stats else out


def _fa_kernel_fn():
    fn = _build.load("flash_attention").vc_flash_attention
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def check_head_major(q, k, v, k_lens):
    """Validate [B, N, S, 128] bf16 q/k/v (and int32 k_lens [B]) for the
    flash-attention kernels; raises ValueError on what they cannot take."""
    B, N, Sq, D = q.shape
    Skv = k.shape[2]
    if D != HEAD_DIM:
        raise ValueError(f"the flash-attention kernels need head_dim {HEAD_DIM}, got {D}")
    _check_cuda("q", q, torch.bfloat16, (B, N, Sq, D))
    _check_cuda("k", k, torch.bfloat16, (B, N, Skv, D))
    _check_cuda("v", v, torch.bfloat16, (B, N, Skv, D))
    if k_lens is not None:
        _check_cuda("k_lens", k_lens, torch.int32, (B,))
    for name, t in (("k", k), ("v", v), ("k_lens", k_lens)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _fa_launch(q, k, v, k_lens, sm_scale, window_size, stats):
    B, N, Sq, D = q.shape
    Skv = k.shape[2]
    check_head_major(q, k, v, k_lens)
    out = torch.empty_like(q)
    m = l = None
    if stats:
        m = torch.empty((B, N, Sq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    scale = sm_scale if stats else sm_scale * LOG2E
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fa_kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_lens.data_ptr() if k_lens is not None else None, out.data_ptr(),
            m.data_ptr() if stats else None, l.data_ptr() if stats else None,
            B, N, Sq, Skv, int(window_size[0]), int(window_size[1]),
            int(stats), scale, stream)
    if err >= 100000:
        raise RuntimeError(f"flash attention: tensor map refused, CUresult {err - 100000}")
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err}")
    LAUNCHES["flash_attention"] += 1
    return (out, m, l) if stats else out


def _fa_forward(q, k, v, k_lens, sm_scale, window_size, stats):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, k_lens, sm_scale, window_size,
                                     stats=stats)
    return _fa_launch(q, k, v, k_lens, sm_scale, window_size, stats)


class _FlashAttentionFn(torch.autograd.Function):
    """The counterpart of the JAX package's `_fa_diff` custom_vjp: the
    forward is the stats flavor, the backward the FA2 kernels of
    kernels/flash_attention_bwd.py, which recompute P from the saved m, l.
    m and l are outputs without a gradient. Only the gradients autograd asks
    for are computed (cross-attention K/V from a frozen context need none)."""

    @staticmethod
    def forward(ctx, q, k, v, k_lens, sm_scale, window_size):
        out, m, l = _fa_forward(q, k, v, k_lens, sm_scale, window_size, True)
        ctx.save_for_backward(q, k, v, out, m, l, k_lens)
        ctx.sm_scale = sm_scale
        ctx.window_size = window_size
        ctx.mark_non_differentiable(m, l)
        return out, m, l

    @staticmethod
    def backward(ctx, do, _dm, _dl):
        from versecrafter_tpu_torch.kernels.flash_attention_bwd import fa_backward
        q, k, v, out, m, l, k_lens = ctx.saved_tensors
        need = ctx.needs_input_grad
        dq, dk, dv = fa_backward(q, k, v, out, m, l, do.contiguous(), k_lens,
                                 ctx.sm_scale, ctx.window_size,
                                 need_dq=need[0], need_dkv=need[1] or need[2])
        return dq, dk, dv, None, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _fa_args(q, k, k_lens, sm_scale, window_size):
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"flash attention takes [B, N, S, D], got {tuple(q.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if k_lens is not None:
        k_lens = k_lens.to(device=q.device, dtype=torch.int32).clamp(0, k.shape[2])
    return k_lens, float(sm_scale), (int(window_size[0]), int(window_size[1]))


def flash_attention(q, k, v, k_lens: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None, window_size=(-1, -1),
                    impl: str = "auto"):
    """Attention over head-major [B, N, S, D] with optional per-batch KV
    lengths and a (left, right) window (-1 = unbounded; causal is (-1, 0)).
    Differentiable: with grad enabled and an input that needs a gradient it
    runs the stats flavor and the FA2 backward; otherwise the exp2 inference
    flavor, as the JAX package's `_fa_diff` primal does. impl 'xla' runs
    attention_reference instead (autograd differentiates it)."""
    check_impl(impl, q)
    k_lens, sm_scale, window_size = _fa_args(q, k, k_lens, sm_scale, window_size)
    if impl == "xla":
        return attention_reference(q, k, v, k_lens, sm_scale, window_size)
    if _needs_grad(q, k, v):
        return _FlashAttentionFn.apply(q, k, v, k_lens, sm_scale, window_size)[0]
    return _fa_forward(q, k, v, k_lens, sm_scale, window_size, False)


def flash_attention_with_stats(q, k, v, sm_scale: Optional[float] = None):
    """(out, m, l): attention over [B, N, S, D] that also returns the row
    max m of the scaled scores and the sum l of exp(s - m), fp32 [B, N, Sq].
    Differentiable through `out`; the cotangents of m and l are ignored."""
    k_lens, sm_scale, window_size = _fa_args(q, k, None, sm_scale, (-1, -1))
    if _needs_grad(q, k, v):
        return _FlashAttentionFn.apply(q, k, v, k_lens, sm_scale, window_size)
    return _fa_forward(q, k, v, k_lens, sm_scale, window_size, True)


def prepare_fused_rope_tables(cos: torch.Tensor, sin: torch.Tensor, dtype=torch.bfloat16):
    """Half-width [S, D/2] tables -> interleaved [S_pad, D] tables (S_pad a
    multiple of TABLE_ROW_ALIGN), built once per forward; bf16 (the kernel's)
    unless `dtype` asks for fp32 tables (plain version only)."""
    ci, si = interleave_rope_tables(cos, sin)
    ci, si = ci.to(dtype), si.to(dtype)
    pad = -ci.shape[0] % TABLE_ROW_ALIGN
    if pad:
        ci = torch.nn.functional.pad(ci, (0, 0, 0, pad))
        si = torch.nn.functional.pad(si, (0, 0, 0, pad))
    return ci, si


def row_rstat(x: torch.Tensor, eps: float) -> torch.Tensor:
    """rsqrt(mean(x^2, -1) + eps) in fp32, [B, S]."""
    xf = x.float()
    return torch.rsqrt(xf.square().mean(-1) + eps)


def _qk_transform(x, rstat, g, cos_i, sin_i, num_heads):
    """fp32 (x * rstat) * g, optional interleaved-table RoPE, one rounding
    to x.dtype. x [B, S, N*D], rstat [B, S], g [N*D]."""
    b, s, df = x.shape
    xf = x.float() * rstat[..., None] * g.float()
    if cos_i is not None:
        xh = xf.view(b, s, num_heads, df // num_heads)
        c = cos_i[:s].float()[:, None, :]
        sn = sin_i[:s].float()[:, None, :]
        xf = (xh * c + _pairswap(xh) * sn).view(b, s, df)
    return xf.to(x.dtype)


def quantize_rows(t: torch.Tensor):
    """Per-row int8 quantization of a transformed tile, as the fused kernel
    does it: sc = max(max|t|, 1e-20) / 127 in fp32 and codes
    round_half_even(t / sc). Returns (codes as fp32, sc [..., 1] fp32)."""
    tf = t.float()
    sc = tf.abs().amax(-1, keepdim=True).clamp_min(1e-20) / 127.0
    return torch.round(tf / sc), sc


def fused_attention_plain(q, k, v, rq, rk, gq, gk, cos_i=None, sin_i=None, *,
                          num_heads: int, window_size=(-1, -1), k_lens=None,
                          int8_score: bool = False,
                          chunk: int = 512) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel, over chunks of query rows
    (a whole [B, N, S, S] fp32 score tensor does not fit at Wan scale).
    Masked keys get P = 0, so a row that sees no key writes 0. With
    int8_score (RoPE flavor only) the scores are the int8 codes' exact
    integer product times the q row's and the k row's scales, in that
    order."""
    B, Sq, DF = q.shape
    Skv = k.shape[1]
    n = num_heads
    hd = DF // n
    qt = _qk_transform(q, rq, gq, cos_i, sin_i, n).view(B, Sq, n, hd).transpose(1, 2)
    kt = _qk_transform(k, rk, gk, cos_i, sin_i, n).view(B, Skv, n, hd).transpose(1, 2)
    if int8_score and cos_i is not None:
        qf, qsc = quantize_rows(qt)   # integer-valued fp32: the products and
        kf, ksc = quantize_rows(kt)   # their sums (< 2^24) are exact
        ksc = ksc.transpose(-1, -2)
    else:
        qf, kf, qsc = qt.float(), kt.float(), None
    vf = v.view(B, Skv, n, hd).transpose(1, 2).float()
    k_len = _key_lengths(k_lens, B, Skv, q.device)
    out = torch.empty_like(q)
    for i0 in range(0, Sq, chunk):
        i1 = min(Sq, i0 + chunk)
        s = torch.matmul(qf[:, :, i0:i1], kf.transpose(-1, -2))
        if qsc is not None:
            s = s * qsc[:, :, i0:i1] * ksc
        ok = visible_keys(i0, i1, Skv, k_len, window_size)
        s = s.masked_fill(~ok, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.where(ok, torch.exp2(s - m), torch.zeros((), device=q.device))
        l = p.sum(-1, keepdim=True)
        o = torch.matmul(p.to(v.dtype).float(), vf)
        o = o * torch.where(l == 0, torch.ones_like(l), 1.0 / l)
        out[:, i0:i1] = o.to(q.dtype).transpose(1, 2).reshape(B, i1 - i0, DF)
    return out


def _check_cuda(name, t, dtype, shape=None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")


def _kernel_fn():
    fn = _build.load("fused_attention").vc_fused_attention
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return fn


def _launch(q, k, v, rq, rk, gq, gk, cos_i, sin_i, *, num_heads, window_size,
            k_lens, int8_score=False) -> torch.Tensor:
    B, Sq, DF = q.shape
    Skv = k.shape[1]
    if DF % num_heads or DF // num_heads != HEAD_DIM:
        raise ValueError(f"the fused kernel needs head_dim {HEAD_DIM}, got "
                         f"{DF}/{num_heads}")
    dev = q.device
    _check_cuda("q", q, torch.bfloat16, (B, Sq, DF))
    _check_cuda("k", k, torch.bfloat16, (B, Skv, DF))
    _check_cuda("v", v, torch.bfloat16, (B, Skv, DF))
    _check_cuda("rq", rq, torch.float32, (B, Sq))
    _check_cuda("rk", rk, torch.float32, (B, Skv))
    _check_cuda("gq", gq, torch.float32, (DF,))
    _check_cuda("gk", gk, torch.float32, (DF,))
    rope = cos_i is not None
    if rope:
        rows = max(Sq, Skv)
        _check_cuda("cos_i", cos_i, torch.bfloat16)
        _check_cuda("sin_i", sin_i, torch.bfloat16, cos_i.shape)
        if cos_i.shape[0] < rows or cos_i.shape[1] != HEAD_DIM:
            raise ValueError(f"rope tables {tuple(cos_i.shape)} do not cover "
                             f"{rows} rows x {HEAD_DIM}")
    if k_lens is not None:
        _check_cuda("k_lens", k_lens, torch.int32, (B,))
    for name, t in (("k", k), ("v", v), ("rq", rq), ("rk", rk), ("gq", gq),
                    ("gk", gk), ("cos_i", cos_i), ("sin_i", sin_i),
                    ("k_lens", k_lens)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    int8 = bool(int8_score) and rope
    out = torch.empty_like(q)
    # the kernel's normalised (+ rotated) K, or its int8 codes and their
    # per-(row, head) scales [B, N, Skv rounded up to the kv tile]
    k_scratch = torch.empty(k.shape, dtype=torch.int8 if int8 else k.dtype,
                            device=dev)
    k_scale = (torch.zeros((B, num_heads, -(-Skv // FUSED_TILE) * FUSED_TILE),
                           dtype=torch.float32, device=dev) if int8 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rq.data_ptr(),
            rk.data_ptr(), gq.data_ptr(), gk.data_ptr(),
            cos_i.data_ptr() if rope else None,
            sin_i.data_ptr() if rope else None,
            k_lens.data_ptr() if k_lens is not None else None,
            k_scratch.data_ptr(), k_scale.data_ptr() if int8 else None,
            out.data_ptr(), B, Sq, Skv, num_heads, int(window_size[0]),
            int(window_size[1]), int(rope), int(int8), stream)
    if err >= 100000:
        raise RuntimeError(f"fused attention: tensor map refused, CUresult {err - 100000}")
    if err != 0:
        raise RuntimeError(f"fused attention kernel launch failed: cudaError {err}")
    LAUNCHES["fused_rope_rms_attention_int8" if int8 else
             "fused_rope_rms_attention" if rope else "fused_rms_cross_attention"] += 1
    return out


def fused_layout_check(a: torch.Tensor, b: torch.Tensor, h: int = 0):
    """The fused kernel's tile and fragment layouts on the card: a, b [1,
    rows, cols] (rows <= 128, cols a multiple of 128) read through the flat
    tensor map at head h's columns into zero-padded [128, 128] tiles.

    bf16 a, b: returns (A Bᵀ, bf16(A Bᵀ) B), fp32 [128, 128] each: the score
    product (A as register fragments loaded from the swizzled tile, B K-major
    in shared memory) and the PV product (P from registers, B read MN-major
    as V is). int8 codes: returns (A Bᵀ,), the int8 flavor's s8 product (A
    fragments from 128-byte code rows, B K-major, accumulators started from
    the fp32 bias whose subtraction gives float(s32)). Exact on small
    integers."""
    int8 = a.dtype == torch.int8
    _check_cuda("a", a, torch.int8 if int8 else torch.bfloat16)
    _check_cuda("b", b, a.dtype, a.shape)
    one, rows, cols = a.shape
    if one != 1 or not 0 < rows <= FUSED_TILE or cols % HEAD_DIM or not 0 <= h < cols // HEAD_DIM:
        raise ValueError(f"need [1, rows <= {FUSED_TILE}, N*{HEAD_DIM}] and a head of it, "
                         f"got {tuple(a.shape)}, h={h}")
    fn = _build.load("fused_attention").vc_fused_layout_check
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    outs = [torch.empty(FUSED_TILE, n, dtype=torch.float32, device=a.device)
            for n in ((FUSED_TILE,) if int8 else (FUSED_TILE, HEAD_DIM))]
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), rows, cols, h, int(int8),
                 outs[0].data_ptr(), None if int8 else outs[1].data_ptr(),
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused layout check failed: error {err}")
    return tuple(outs)


def fused_attention(q, k, v, rq, rk, gq, gk, cos_i=None, sin_i=None, *,
                    num_heads: int, window_size=(-1, -1),
                    k_lens: Optional[torch.Tensor] = None,
                    int8_score: bool = False) -> torch.Tensor:
    """The kernel's entry once the row statistics are known: the RoPE flavor
    when interleaved tables are given (int8-scored with `int8_score`), the
    norm-only flavor otherwise (which ignores `int8_score`). CUDA tensors
    launch the kernel (or raise); CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, rq, rk, gq, gk, cos_i, sin_i,
                                     num_heads=num_heads,
                                     window_size=window_size, k_lens=k_lens,
                                     int8_score=int8_score)
    return _launch(q, k, v, rq, rk, gq, gk, cos_i, sin_i, num_heads=num_heads,
                   window_size=window_size, k_lens=k_lens, int8_score=int8_score)


def _stats_and_scales(q, k, gq, gk, eps, sm_scale, rq=None, rk=None):
    """(rq, rk, gq, gk) as the kernel takes them: rq with sm_scale*log2(e)
    folded in; unit statistics and scales when there is no qk-norm. A
    statistic the projection already computed ([B, S, 1]) is used as it is,
    the other is reduced here."""
    scale_q = sm_scale * LOG2E
    df = q.shape[-1]
    if gq is None:
        ones = torch.ones(df, dtype=torch.float32, device=q.device)
        rq = torch.full(q.shape[:2], scale_q, dtype=torch.float32, device=q.device)
        rk = torch.ones(k.shape[:2], dtype=torch.float32, device=q.device)
        return rq, rk, ones, ones
    rq = (row_rstat(q, eps) if rq is None else rq.reshape(q.shape[:2]).float()) * scale_q
    rk = row_rstat(k, eps) if rk is None else rk.reshape(k.shape[:2]).float()
    return (rq.contiguous(), rk.contiguous(), gq.float().contiguous(),
            gk.float().contiguous())


def _heads(x, num_heads):
    """[B, S, N*D] -> contiguous head-major [B, N, S, D]."""
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).transpose(1, 2).contiguous()


def _merge_heads(x):
    b, n, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, n * hd)


def _unfused_rope_rms_attention(q, k, v, cos, sin, gq, gk, num_heads, eps,
                                sm_scale, window_size, impl="auto"):
    """The separate-passes math the fused self-attention kernel replaces:
    full-dim RMSNorm, pairwise RoPE on the half-width tables, head split,
    flash attention. The differentiable path of fused_rope_rms_attention."""
    b, s, _ = q.shape
    if gq is not None:
        q = rms_norm(q, gq, eps)
        k = rms_norm(k, gk, eps)
    q = apply_rope(q.reshape(b, s, num_heads, -1), cos, sin).flatten(2)
    k = apply_rope(k.reshape(b, s, num_heads, -1), cos, sin).flatten(2)
    out = flash_attention(_heads(q, num_heads), _heads(k, num_heads),
                          _heads(v, num_heads), sm_scale=sm_scale,
                          window_size=window_size, impl=impl)
    return _merge_heads(out)


def _unfused_rms_cross_attention(q, k, v, gq, gk, num_heads, eps, sm_scale,
                                 impl="auto"):
    """The separate-passes math the fused cross-attention kernel replaces:
    full-dim RMSNorm on q and k, head split, flash attention."""
    if gq is not None:
        q = rms_norm(q, gq, eps)
        k = rms_norm(k, gk, eps)
    out = flash_attention(_heads(q, num_heads), _heads(k, num_heads),
                          _heads(v, num_heads), sm_scale=sm_scale, impl=impl)
    return _merge_heads(out)


def _rms_apply(x, rstat, g):
    """rms_norm with the row statistic supplied ([..., 1] fp32): the same
    math and rounding as kernels.norms.rms_norm when rstat equals
    rsqrt(mean(x^2, -1) + eps)."""
    return (x.float() * rstat * g.float()).to(x.dtype)


def _unfused_rope_rms_attention_rs(q, k, v, rq, rk, cos, sin, gq, gk,
                                   num_heads, sm_scale, window_size, impl="auto"):
    """_unfused_rope_rms_attention with the producer's row statistics
    (linear_rstat) in place of the reduces over the model dim."""
    b, s, _ = q.shape
    q = _rms_apply(q, rq, gq)
    k = _rms_apply(k, rk, gk)
    q = apply_rope(q.reshape(b, s, num_heads, -1), cos, sin).flatten(2)
    k = apply_rope(k.reshape(b, s, num_heads, -1), cos, sin).flatten(2)
    out = flash_attention(_heads(q, num_heads), _heads(k, num_heads),
                          _heads(v, num_heads), sm_scale=sm_scale,
                          window_size=window_size, impl=impl)
    return _merge_heads(out)


def _unfused_rms_cross_attention_rs(q, k, v, rq, gq, gk, num_heads, eps,
                                    sm_scale, impl="auto"):
    """_unfused_rms_cross_attention with the producer's q statistic; the k
    statistic spans only the short context axis and stays a plain
    rms_norm."""
    q = _rms_apply(q, rq, gq)
    k = rms_norm(k, gk, eps)
    out = flash_attention(_heads(q, num_heads), _heads(k, num_heads),
                          _heads(v, num_heads), sm_scale=sm_scale, impl=impl)
    return _merge_heads(out)


def fused_rope_rms_attention(q, k, v, cos, sin, gq=None, gk=None, *,
                             num_heads: int, eps: float = 1e-6,
                             sm_scale: Optional[float] = None,
                             window_size=(-1, -1), tables_i=None,
                             rstats=None, int8_score: bool = False,
                             impl: str = "auto"):
    """Self-attention over RAW q/k/v projections [B, S, D] with qk-RMSNorm
    (scales gq/gk [D], optional) and RoPE (half-width cos/sin [S, hd/2], or
    pre-built interleaved `tables_i` from prepare_fused_rope_tables) fused
    into the kernel.

    rstats: optional (rq, rk) [B, S, 1] fp32 raw row statistics that the
    projection computed (kernels.matmul_stat.linear_rstat); used only with
    gq/gk. int8_score: score QK^T on per-(row, head) int8 codes of q~/k~
    (an inference approximation).

    With grad enabled and an input that needs a gradient it runs the unfused
    math through the differentiable flash_attention instead (as the JAX
    package's custom_vjp does), which needs the half-width cos/sin; there
    int8_score is a no-op and the exact math runs. impl 'xla' runs that
    unfused math over attention_reference, with or without grad."""
    check_impl(impl, q)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    rq, rk = rstats if rstats is not None and gq is not None else (None, None)
    if impl == "xla" or _needs_grad(q, k, v, gq, gk, rq, rk):
        if cos is None or sin is None:
            raise ValueError("the differentiable path needs the half-width "
                             "cos/sin tables")
        if rq is not None:
            return _unfused_rope_rms_attention_rs(q, k, v, rq, rk, cos, sin, gq,
                                                  gk, num_heads, sm_scale,
                                                  window_size, impl)
        return _unfused_rope_rms_attention(q, k, v, cos, sin, gq, gk, num_heads,
                                           eps, sm_scale, window_size, impl)
    rq, rk, gqv, gkv = _stats_and_scales(q, k, gq, gk, eps, sm_scale, rq, rk)
    cos_i, sin_i = tables_i if tables_i is not None else prepare_fused_rope_tables(cos, sin)
    return fused_attention(q, k, v, rq, rk, gqv, gkv, cos_i, sin_i,
                           num_heads=num_heads, window_size=window_size,
                           int8_score=int8_score)


def fused_rms_cross_attention(q, k, v, gq=None, gk=None, *, num_heads: int,
                              eps: float = 1e-6,
                              sm_scale: Optional[float] = None, rq=None, rk=None,
                              impl: str = "auto"):
    """Cross-attention over RAW projections q [B, S, D] (video tokens) and
    k/v [B, Skv, D] (context tokens) with qk-RMSNorm fused into the kernel.
    rq: optional [B, S, 1] fp32 raw q statistic from the projection (used
    only with gq); the k statistic spans each context row and is reduced
    here unless rk [B, Skv, 1] gives it (a tensor-parallel shard's, summed
    over its group; inference only). Under grad (an input needs a
    gradient), or with impl 'xla', it runs the unfused math through
    flash_attention."""
    check_impl(impl, q)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    rq = rq if gq is not None else None
    rk = rk if gk is not None else None
    if rk is not None and (impl == "xla" or _needs_grad(q, k, v, gq, gk, rq, rk)):
        raise ValueError("a given k statistic runs on the fused inference path only")
    if impl == "xla" or _needs_grad(q, k, v, gq, gk, rq):
        if rq is not None:
            return _unfused_rms_cross_attention_rs(q, k, v, rq, gq, gk, num_heads,
                                                   eps, sm_scale, impl)
        return _unfused_rms_cross_attention(q, k, v, gq, gk, num_heads, eps,
                                            sm_scale, impl)
    rq, rk, gqv, gkv = _stats_and_scales(q, k, gq, gk, eps, sm_scale, rq, rk)
    return fused_attention(q, k, v, rq, rk, gqv, gkv, num_heads=num_heads)
