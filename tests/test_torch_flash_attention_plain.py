"""Port parity: the plain flash attention (forward, stats, FA2 backward, the
autograd path) and the fused functions' grad routing against the jitted JAX
package on the CPU (Pallas kernels in interpret mode)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused_attention_setup import fused_attention_inputs
from versecrafter_tpu_torch.kernels import flash_attention as tfa
from versecrafter_tpu_torch.kernels import flash_attention_bwd as tfab

jfa = importlib.import_module("versecrafter_tpu.kernels.flash_attention")
jfab = importlib.import_module("versecrafter_tpu.kernels.flash_attention_bwd")

CASES = [  # (B, N, Sq, Skv, k_lens, window)
    (1, 2, 130, 200, None, (-1, -1)),
    (2, 2, 130, 200, (0, 150), (-1, -1)),
    (1, 2, 256, 256, None, (64, 64)),
    (1, 2, 256, 256, None, (-1, 0)),
    # lengths that straddle 64- and 128-row tiles in both directions (the
    # card kernels' warpgroup and CTA tile heights)
    (1, 2, 193, 321, None, (-1, -1)),
    (2, 2, 129, 64, (64, 1), (-1, -1)),
    (1, 2, 384, 384, None, (100, 27)),
]
IDS = ["ragged", "k_lens", "window64", "causal", "straddle193x321", "straddle129x64_k_lens",
       "straddle384_window"]


def _inputs(B, N, Sq, Skv, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((B, N, Sq, 128), (B, N, Skv, 128), (B, N, Skv, 128),
                  (B, N, Sq, 128)))


def _rel(got, ref):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _kl(k_lens):
    return None if k_lens is None else np.asarray(k_lens, np.int32)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_matches_jax_pallas(case):
    B, N, Sq, Skv, k_lens, window = case
    q, k, v, _ = _inputs(B, N, Sq, Skv)
    kl = _kl(k_lens)
    ref = jax.jit(lambda q, k, v, kl: jfa.flash_attention(
        q, k, v, k_lens=kl, impl="pallas", window_size=window))(q, k, v, kl)
    tq, tk, tv = _t(q, k, v)
    tkl = None if kl is None else torch.from_numpy(kl)
    got = tfa.flash_attention(tq, tk, tv, k_lens=tkl, window_size=window)
    assert _rel(got, ref) <= 1e-4
    # the stats flavor (what autograd runs) computes the same function
    out, m, l = tfa.flash_attention_plain(tq, tk, tv, tkl, None, window, stats=True)
    assert _rel(out, ref) <= 1e-4
    if k_lens is not None:  # a batch element that sees no key: zeros, not NaN
        assert torch.isfinite(got).all()
        for b, n in enumerate(k_lens):
            if n == 0:
                assert got[b].abs().max().item() == 0.0
                assert (l[b] == 0).all() and (m[b] == tfa.NEG_INF).all()


def test_with_stats_matches_jax_pallas():
    q, k, v, _ = _inputs(1, 2, 130, 200)
    ref = jax.jit(lambda q, k, v: jfa.flash_attention_with_stats(
        q, k, v, impl="pallas"))(q, k, v)
    got = tfa.flash_attention_with_stats(*_t(q, k, v))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert _rel(g, r) <= 1e-5


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fa_backward_plain_matches_jax(case):
    """The plain version of the dQ and dK/dV kernels against the Pallas
    backward (interpret mode) on the same residuals."""
    B, N, Sq, Skv, k_lens, window = case
    q, k, v, do = _inputs(B, N, Sq, Skv, seed=1)
    kl = _kl(k_lens) if k_lens is not None else np.full((B,), Skv, np.int32)
    sm = 128 ** -0.5
    out, m, l = jax.jit(lambda q, k, v, kl: jfa._flash_attention_pallas(
        q, k, v, kl, sm_scale=sm, block_q=128, block_kv=128, interpret=True,
        return_stats=True, window=window, masked=True))(q, k, v, kl)
    ref = jax.jit(lambda *a: jfab.fa_backward(
        *a, sm_scale=sm, block_q=128, block_kv=128, interpret=True,
        window=window, masked=True))(q, k, v, out, m, l, do, kl)
    got = tfab.fa_backward(*_t(q, k, v, out, m, l, do, kl), sm_scale=sm,
                           window_size=window)
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        assert _rel(g, r) <= 1e-4, name


def _loss_weights(shape):
    return np.random.default_rng(99).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_autograd_matches_jax_grad(case):
    B, N, Sq, Skv, k_lens, window = case
    q, k, v, _ = _inputs(B, N, Sq, Skv, seed=2)
    kl = _kl(k_lens)
    w = _loss_weights((B, N, Sq, 128))

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, k_lens=kl, impl="pallas",
                                  window_size=window)
        return jnp.sum(out * w)

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = tfa.flash_attention(tq, tk, tv, k_lens=None if kl is None else torch.from_numpy(kl),
                              window_size=window)
    (out * torch.from_numpy(w)).sum().backward()
    for g, r, name in zip((tq.grad, tk.grad, tv.grad), ref, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-3, atol=2e-3,
                                   err_msg=f"d{name}")
    if k_lens is not None:  # masked keys get exactly zero dK/dV
        for g in (tk.grad, tv.grad):
            for b, n in enumerate(k_lens):
                if n < Skv:
                    assert g[b, :, n:].abs().max().item() == 0.0


def test_backward_computes_only_what_autograd_asks_for(monkeypatch):
    calls = []
    real = tfab.fa_backward_plain

    def spy(*a, **kw):
        calls.append((a[-2], a[-1]))  # need_dq, need_dkv
        return real(*a, **kw)

    monkeypatch.setattr(tfab, "fa_backward_plain", spy)
    q, k, v, _ = _inputs(1, 2, 64, 32)
    tq = torch.from_numpy(q).requires_grad_()
    tfa.flash_attention(tq, *_t(k, v)).sum().backward()
    assert calls == [(True, False)] and tq.grad.abs().max().item() > 0


def _fused_inputs():
    q, k, v, cos, sin, gq, gk, N, HD = fused_attention_inputs(S=260, N=2, HD=128)
    return [np.asarray(a) for a in (q, k, v, cos[:260], sin[:260], gq, gk)], N


@pytest.mark.parametrize("window", [(-1, -1), (64, 32)])
def test_fused_self_grad_routes_through_flash(window):
    """Under grad the port's fused self-attention runs the unfused math over
    the differentiable flash attention; its gradients match jax.grad of the
    JAX fused function (whose custom_vjp also differentiates the unfused
    math)."""
    (q, k, v, cos, sin, gq, gk), N = _fused_inputs()
    w = _loss_weights(q.shape)

    def jloss(q, k, v, gq, gk):
        out = jfa.fused_rope_rms_attention(q, k, v, cos, sin, gq, gk, num_heads=N,
                                           window_size=window, impl="pallas")
        return jnp.sum(out * w)

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(q, k, v, gq, gk)
    ins = [t.requires_grad_() for t in _t(q, k, v, gq, gk)]
    tcos, tsin = _t(cos, sin)
    out = tfa.fused_rope_rms_attention(ins[0], ins[1], ins[2], tcos, tsin, ins[3],
                                       ins[4], num_heads=N, window_size=window)
    (out * torch.from_numpy(w)).sum().backward()
    for t, r, name in zip(ins, ref, ("dq", "dk", "dv", "dgq", "dgk")):
        assert t.grad.abs().max().item() > 0, name
        assert _rel(t.grad, r) <= 1e-3, name


def test_fused_cross_grad_routes_through_flash():
    (q, k, v, _, _, gq, gk), N = _fused_inputs()
    k, v = k[:, :77], v[:, :77]
    w = _loss_weights(q.shape)

    def jloss(q, k, v, gq, gk):
        return jnp.sum(jfa.fused_rms_cross_attention(
            q, k, v, gq, gk, num_heads=N, impl="pallas") * w)

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(q, k, v, gq, gk)
    ins = [t.requires_grad_() for t in _t(q, k, v, gq, gk)]
    out = tfa.fused_rms_cross_attention(*ins, num_heads=N)
    (out * torch.from_numpy(w)).sum().backward()
    for t, r, name in zip(ins, ref, ("dq", "dk", "dv", "dgq", "dgk")):
        assert t.grad.abs().max().item() > 0, name
        assert _rel(t.grad, r) <= 1e-3, name


def test_fused_inference_unchanged_without_grad():
    """Under no_grad (or with no input needing a gradient) the fused
    functions keep the fused math: the unfused references agree with it only
    to bf16-scale rounding, and the fused path is what serving runs."""
    (q, k, v, cos, sin, gq, gk), N = _fused_inputs()
    tq, tk, tv, tcos, tsin, tgq, tgk = _t(q, k, v, cos, sin, gq, gk)
    fused = tfa.fused_rope_rms_attention(tq, tk, tv, tcos, tsin, tgq, tgk, num_heads=N)
    ref = jax.jit(lambda *a: jfa.fused_rope_rms_attention(
        *a, num_heads=N, impl="pallas"))(q, k, v, cos, sin, gq, gk)
    assert _rel(fused, ref) <= 1e-4
    unfused = tfa._unfused_rope_rms_attention(tq, tk, tv, tcos, tsin, tgq, tgk, N,
                                              1e-6, 128 ** -0.5, (-1, -1))
    jref = jax.jit(lambda *a: jfa._unfused_rope_rms_attention(
        *a, N, 1e-6, 128 ** -0.5, (-1, -1), "pallas"))(q, k, v, cos, sin, gq, gk)
    assert _rel(unfused, jref) <= 1e-4
