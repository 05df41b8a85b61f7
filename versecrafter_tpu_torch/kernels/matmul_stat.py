"""Linear projection with a fused row-RMS statistic epilogue.

``linear_rstat(p, x)`` applies the dense layer ``p`` ({"kernel": [K, N],
"bias"?: [N]}) to x [..., K] and also returns the qk-RMSNorm row statistic of
the output, rsqrt(mean(y^2, -1) + eps) as fp32 [..., 1], so that the fused
attention kernels never re-read the projection output to reduce over it.

Numerics (those of the JAX package's `_linear_rstat_ref`): the product
accumulates in fp32, the bias is added in fp32, y is rounded once to x's
dtype, and the statistic is taken from the rounded y, exactly the tensor a
separate rms_norm pass would read.

On a CUDA tensor the wrapper launches the hand-written GEMM of
csrc/matmul_stat.cu (one persistent wgmma + TMA kernel that takes the
statistic in its epilogue) or raises; a CPU tensor takes the plain version.
Under grad (an input needs a gradient) the plain math runs through torch
autograd, as the JAX custom_vjp runs its reference math under jax.grad.
"""

from __future__ import annotations

import ctypes

import torch

from versecrafter_tpu_torch.kernels import _build
from versecrafter_tpu_torch.kernels.flash_attention import _check_cuda, _needs_grad

# The kernel's geometry (csrc/matmul_stat.cu): row blocks of BM rows, each
# swept by one cluster of two CTAs over N tiles of BN columns (alternate
# tiles a CTA; the last of BN_TAIL when N % BN == BN_TAIL), K slices of BK;
# N must be a multiple of BN_TAIL and at most MAX_N (the bias row sits in
# shared memory beside the ring).
BM, BN, BN_TAIL, BK, MAX_N = 128, 256, 128, 64, 8192

# Kernel launches since the last reset (comparison launches count too; a
# caller measuring a path resets first).
LAUNCHES = {"linear_rstat": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def linear_rstat_plain(x, w, bias=None, eps: float = 1e-6):
    """Plain PyTorch version over x [M, K], w [K, N]: an fp32 product of x
    and w rounded to x's dtype (on the card with TF32 off, torch's default),
    plus the bias in fp32, one rounding to x.dtype, then the statistic of the
    rounded y. Returns (y [M, N], rs [M, 1] fp32); differentiable."""
    y32 = torch.matmul(x.float(), w.to(x.dtype).float())
    if bias is not None:
        y32 = y32 + bias.float()
    y = y32.to(x.dtype)
    rs = torch.rsqrt(y.float().square().mean(-1, keepdim=True) + eps)
    return y, rs


def _kernel_fn():
    fn = _build.load("matmul_stat").vc_linear_rstat
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def check_shape(M: int, K: int, N: int) -> None:
    """Raises ValueError for a product [M, K] x [K, N] the kernel does not
    take: K a multiple of BK, N of BN_TAIL and at most MAX_N, M > 0."""
    if K <= 0 or K % BK or N <= 0 or N % BN_TAIL or N > MAX_N or M <= 0:
        raise ValueError(f"the linear_rstat kernel needs K % {BK} == 0, N % {BN_TAIL} == 0, "
                         f"N <= {MAX_N} and M > 0, got M={M} K={K} N={N}")


def _launch(x, w, bias, eps):
    M, K = x.shape
    N = w.shape[1]
    check_shape(M, K, N)
    _check_cuda("x", x, torch.bfloat16)
    _check_cuda("w", w, torch.bfloat16, (K, N))
    if bias is not None:
        _check_cuda("bias", bias, torch.float32, (N,))
    for name, t in (("w", w), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    rs = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel_fn()(x.data_ptr(), w.data_ptr(),
                           bias.data_ptr() if bias is not None else None,
                           y.data_ptr(), rs.data_ptr(), M, N, K, float(eps), stream)
    if err >= 100000:
        raise RuntimeError(f"linear_rstat kernel: tensor map refused, CUresult {err - 100000}")
    if err != 0:
        raise RuntimeError(f"linear_rstat kernel launch failed: cudaError {err}")
    LAUNCHES["linear_rstat"] += 1
    return y, rs


def linear_rstat(p, x: torch.Tensor, eps: float = 1e-6):
    """(y [..., N], rs [..., 1] fp32): the dense layer `p` applied to x
    [..., K] and the row-RMS statistic of its rounded output. Only for plain
    tensor kernels (quantized leaves keep the separate passes)."""
    w, bias = p["kernel"], p.get("bias")
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu" or _needs_grad(x, w, bias):
        y, rs = linear_rstat_plain(x2d, w, bias, eps)
    else:
        y, rs = _launch(x2d.contiguous(), w.to(x.dtype).contiguous(),
                        None if bias is None else bias.float().contiguous(), eps)
    return y.reshape(*lead, -1), rs.reshape(*lead, 1)
