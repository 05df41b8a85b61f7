"""FA2-style flash-attention backward: the wrapper of the two CUDA kernels
(csrc/flash_attention_bwd.cu) and their plain PyTorch versions.

From the forward's residuals (out and the stats flavor's row max m and sum
l) the backward recomputes the score tile, then

    p  = exp(qs kᵀ - L)                 dV = Σ_q bf16(p)ᵀ dO
    dp = dO vᵀ                          dS = p (dp - Δ),  Δ = rowsum(dO∘O)
    dQ = Σ_kv bf16(dS) k · sm_scale     dK = Σ_q bf16(dS)ᵀ qs

with qs = bf16(q · sm_scale), the same rounding the stats forward used, and
L = m + log(max(l, 1e-30)). Two kernels, as the JAX package has: dQ loops
over KV tiles, dK/dV over Q tiles; neither uses atomics, so results are
run-to-run identical. On the card both are wgmma kernels fed by TMA from
tensor maps over [B*N, S, 128], so every tensor must be contiguous and
16-byte aligned (the wrapper raises otherwise). Masked keys (past k_len,
outside the window) and query rows past Sq get p = 0 explicitly, so they
contribute nothing, also in a row that sees no key (l = 0). On a CUDA
tensor fa_backward launches the kernels or raises; only CPU tensors take
the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from versecrafter_tpu_torch.kernels import _build
from versecrafter_tpu_torch.kernels.flash_attention import (
    _check_cuda, _key_lengths, check_head_major, visible_keys)

# Kernel launches since the last reset (comparison launches are counted too;
# a caller measuring a path resets first).
LAUNCHES = {"fa_backward_dq": 0, "fa_backward_dkv": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def backward_preamble(q, out, m, l, do, sm_scale):
    """(qs, L, delta): q scaled and rounded to its dtype once, the row
    logsumexp and rowsum(dO∘O), both fp32 [B, N, Sq]."""
    qs = (q.float() * sm_scale).to(q.dtype)
    L = m + torch.log(torch.clamp(l, min=1e-30))
    delta = (do.float() * out.float()).sum(-1)
    return qs, L, delta


def fa_backward_plain(qs, k, v, do, L, delta, k_lens, sm_scale, window_size,
                      need_dq=True, need_dkv=True, chunk: int = 512):
    """Plain PyTorch version of both kernels, over chunks of query rows (no
    [B, N, Sq, Skv] tensor is ever held whole). Returns (dq, dk, dv), None
    where not asked for."""
    B, N, Sq, D = qs.shape
    Skv = k.shape[2]
    kf, vf = k.float(), v.float()
    k_len = _key_lengths(k_lens, B, Skv, qs.device)
    dq = torch.empty_like(qs) if need_dq else None
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device) if need_dkv else None
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device) if need_dkv else None
    zero = torch.zeros((), device=qs.device)
    for i0 in range(0, Sq, chunk):
        i1 = min(Sq, i0 + chunk)
        ok = visible_keys(i0, i1, Skv, k_len, window_size)
        qc = qs[:, :, i0:i1].float()
        doc = do[:, :, i0:i1].float()
        s = torch.matmul(qc, kf.transpose(-1, -2))
        p = torch.where(ok, torch.exp(s - L[:, :, i0:i1, None]), zero)
        dp = torch.matmul(doc, vf.transpose(-1, -2))
        ds = p * (dp - delta[:, :, i0:i1, None])
        if need_dq:
            dq[:, :, i0:i1] = (torch.matmul(ds.to(k.dtype).float(), kf)
                               * sm_scale).to(qs.dtype)
        if need_dkv:
            dv += torch.matmul(p.to(do.dtype).float().transpose(-1, -2), doc)
            dk += torch.matmul(ds.to(qs.dtype).float().transpose(-1, -2), qc)
    if need_dkv:
        dk, dv = dk.to(k.dtype), dv.to(v.dtype)
    return dq, dk, dv


def _kernel_fn(name: str, n_ptr: int, with_scale: bool):
    fn = getattr(_build.load("flash_attention_bwd"), name)
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
                       + [ctypes.c_float] * with_scale + [ctypes.c_void_p])
    return fn


def _launch_error(what: str, err: int) -> RuntimeError:
    if err >= 100000:
        return RuntimeError(f"{what}: tensor map refused, CUresult {err - 100000}")
    return RuntimeError(f"{what} launch failed: cudaError {err}")


def wgmma_layout_check(a: torch.Tensor, b: torch.Tensor, which: int = 0):
    """One warpgroup over the first 64 rows of matrix `which` of a and b
    (bf16 [count, rows, 128] on the card): (A Bᵀ from shared memory, A Bᵀ
    with A from registers, bf16(A Bᵀ) B with B read transposed, A[:, :64]
    [A | B | B] with A and B both from shared memory and B read transposed),
    fp32 [64, 64], [64, 64], [64, 128], [64, 384]. Every product form, tile
    layout and fragment layout the backward kernels and the linear_rstat
    GEMM rely on; exact on small integers."""
    _check_cuda("a", a, torch.bfloat16)
    _check_cuda("b", b, torch.bfloat16, a.shape)
    count, rows, d = a.shape
    if d != 128 or not 0 <= which < count:
        raise ValueError(f"need [count, rows, 128] and 0 <= which < count, got {a.shape}")
    fn = _build.load("flash_attention_bwd").vc_wgmma_layout_check
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5)
    outs = [torch.empty(64, n, dtype=torch.float32, device=a.device)
            for n in (64, 64, 128, 384)]
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), rows, count, which,
                 *(t.data_ptr() for t in outs),
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise _launch_error("wgmma layout check", err)
    return tuple(outs)


def _launch(qs, k, v, do, L, delta, k_lens, sm_scale, window_size, need_dq,
            need_dkv):
    B, N, Sq, D = qs.shape
    Skv = k.shape[2]
    check_head_major(qs, k, v, k_lens)
    _check_cuda("do", do, torch.bfloat16, qs.shape)
    _check_cuda("L", L, torch.float32, (B, N, Sq))
    _check_cuda("delta", delta, torch.float32, (B, N, Sq))
    ins = (qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           L.data_ptr(), delta.data_ptr(),
           k_lens.data_ptr() if k_lens is not None else None)
    dims = (B, N, Sq, Skv, int(window_size[0]), int(window_size[1]))
    dq = dk = dv = None
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream(qs.device).cuda_stream
        if need_dq:
            dq = torch.empty_like(qs)
            err = _kernel_fn("vc_fa_backward_dq", 8, True)(
                *ins, dq.data_ptr(), *dims, sm_scale, stream)
            if err != 0:
                raise _launch_error("dQ kernel", err)
            LAUNCHES["fa_backward_dq"] += 1
        if need_dkv:
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            err = _kernel_fn("vc_fa_backward_dkv", 9, False)(
                *ins, dk.data_ptr(), dv.data_ptr(), *dims, stream)
            if err != 0:
                raise _launch_error("dK/dV kernel", err)
            LAUNCHES["fa_backward_dkv"] += 1
    return dq, dk, dv


def fa_backward(q, k, v, out, m, l, do, k_lens: Optional[torch.Tensor] = None,
                sm_scale: Optional[float] = None, window_size=(-1, -1),
                need_dq: bool = True, need_dkv: bool = True):
    """(dq, dk, dv) of attention over head-major [B, N, S, D] from the stats
    forward's out, m, l and the output cotangent do (None where not asked
    for). The preamble (qs, L, delta) runs in plain torch; the two kernels
    on the card, their plain version on the CPU."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    qs, L, delta = backward_preamble(q, out, m, l, do, sm_scale)
    if q.device.type == "cpu":
        return fa_backward_plain(qs, k, v, do, L, delta, k_lens, sm_scale,
                                 window_size, need_dq, need_dkv)
    return _launch(qs, k, v, do, L, delta, k_lens, float(sm_scale), window_size,
                   need_dq, need_dkv)
