"""Shared layers of the perception models: NHWC activations with torch-layout
conv kernels ([O, I, kh, kw]), linear kernels [in, out], fp32 layer-norm
statistics and softmaxes, and the weights of ``jax.image.resize``
"bilinear"."""

from __future__ import annotations

import contextlib
import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_fp32():
    """TF32 off for cuBLAS matmuls and cuDNN convolutions inside the block:
    fp32 perception forwards keep full precision on the card, as the JAX
    package computes them."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def ln(x, p, eps=1e-6):
    """LayerNorm over the last axis, fp32 statistics, output in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["weight"].float() + p["bias"].float()).to(x.dtype)


def lin(p, x, kernel="weight"):
    """x @ W (+ b) with W [in, out], weights cast to x's dtype."""
    y = torch.matmul(x, p[kernel].to(x.dtype))
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def conv(p, x, stride=1, pad=0, pad_mode="zeros"):
    """NHWC conv with a torch [O, I, kh, kw] kernel; pad_mode "replicate"
    pads the edges (jnp.pad mode="edge")."""
    k = p["weight"].to(x.dtype)
    xc = x.permute(0, 3, 1, 2)
    if pad and pad_mode == "replicate":
        xc = F.pad(xc, (pad, pad, pad, pad), mode="replicate")
        pad = 0
    y = F.conv2d(xc, k, None, stride, pad).permute(0, 2, 3, 1)
    return y + p["bias"].to(y.dtype)


def conv_transpose2x2(p, x):
    """ConvTranspose2d(kernel=2, stride=2), torch [I, O, 2, 2] kernel, NHWC:
    each input pixel expands into its own 2x2 block."""
    w = p["weight"].to(x.dtype)
    b, h, ww, _ = x.shape
    y = torch.einsum("bhwi,ioac->bhawco", x, w).reshape(b, h * 2, ww * 2, w.shape[1])
    return y + p["bias"].to(y.dtype)


def attention(q, k, v, heads, mask=None):
    """[B, N, H*hd] tokens -> softmax attention per head (fp32 softmax, the
    probabilities cast back to q's dtype); `mask` is an additive bias
    broadcastable to [B, heads, Nq, Nk]."""
    b, nq, d = q.shape
    hd = d // heads
    qh = q.reshape(b, nq, heads, hd).transpose(1, 2)
    kh = k.reshape(b, k.shape[1], heads, hd).transpose(1, 2)
    vh = v.reshape(b, v.shape[1], heads, hd).transpose(1, 2)
    s = torch.einsum("bnqd,bnkd->bnqk", qh, kh) / math.sqrt(hd)
    if mask is not None:
        s = s + mask.to(s.dtype)
    a = F.softmax(s.float(), -1).to(q.dtype)
    o = torch.einsum("bnqk,bnkd->bnqd", a, vh)
    return o.transpose(1, 2).reshape(b, nq, vh.shape[1] * vh.shape[-1])


@lru_cache(maxsize=64)
def linear_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] float32 weights of jax.image.resize(..., "bilinear")
    along one axis (scale_and_translate semantics, antialias on): half-pixel
    sample positions, the triangle kernel widened by 1 / scale when it
    shrinks, each row renormalised to sum 1, rows whose sample falls outside
    the input zeroed. Upsampling this is the clamped bilinear of
    F.interpolate(align_corners=False); shrinking it is not."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0), np.float32(1) - x).astype(np.float32)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).T.astype(np.float32).copy()


def resize_bilinear(x: torch.Tensor, h: int, w: int, axes=(1, 2)) -> torch.Tensor:
    """jax.image.resize(x, ..., "bilinear") along two spatial axes of x
    (NHWC by default); an axis whose size does not change is left as it is,
    as jax does."""
    for ax, n_out in zip(axes, (h, w)):
        n_in = x.shape[ax]
        if n_in == n_out:
            continue
        wm = torch.from_numpy(linear_resize_weights(n_in, n_out)).to(x.device, x.dtype)
        x = torch.movedim(torch.tensordot(x, wm, dims=([ax], [1])), -1, ax)
    return x


def normal(gen, shape, std, dtype):
    """N(0, std^2) drawn from `gen` on its device (fp32, then cast)."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return (t.normal_(generator=gen) * std).to(dtype)


def zeros(shape, dtype, gen):
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def ones(shape, dtype, gen):
    return torch.ones(shape, dtype=dtype, device=gen.device)
