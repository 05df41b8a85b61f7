"""Port parity for the producer-statistic path: linear_rstat (its plain
version, what the CPU runs) against the JAX linear_rstat in Pallas interpret
mode and its reference math, its gradients, the rstats=/rq= attention
flavors, PROJ_STAT_FUSION at model level and in one train step (CPU)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused_attention_setup import fused_attention_inputs, tiny_wan_setup
from versecrafter_tpu.kernels import matmul_stat as jms
from versecrafter_tpu.models import wan_dit as jwan
from versecrafter_tpu_torch.core import config as tconfig
from versecrafter_tpu_torch.core.convert import params_from_jax
from versecrafter_tpu_torch.kernels import flash_attention as tfa
from versecrafter_tpu_torch.kernels import matmul_stat as tms
from versecrafter_tpu_torch.models import wan_dit as twan

jfa = importlib.import_module("versecrafter_tpu.kernels.flash_attention")

BF16_ULP = 2.0 ** -8  # one bf16 ulp, relative to max|y|


def _t(a):
    a = jnp.asarray(a)
    out = torch.from_numpy(np.array(a.astype(jnp.float32)))
    return out.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else out


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def _mk(m, k=64, n=128, dtype=jnp.bfloat16, bias=True, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((2, m, k)), dtype)
    p = {"kernel": jnp.asarray(rng.standard_normal((k, n)) * 0.1, dtype)}
    if bias:
        p["bias"] = jnp.asarray(rng.standard_normal(n) * 0.1, dtype)
    return x, p


def _port_p(p):
    return {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("m", [96, 97])  # 97: the Pallas kernel's pad path
def test_linear_rstat_matches_jax(m, bias, dtype):
    x, p = _mk(m, dtype=dtype, bias=bias)
    y_i, rs_i = jax.jit(lambda x: jms.linear_rstat(p, x, 1e-6, interpret=True))(x)
    y_r, rs_r = jax.jit(lambda x: jms._linear_rstat_ref(
        x, p["kernel"], p.get("bias"), 1e-6))(x)
    y, rs = tms.linear_rstat(_port_p(p), _t(x), 1e-6)
    assert y.dtype == _t(x).dtype and rs.dtype == torch.float32
    assert tuple(y.shape) == y_i.shape and tuple(rs.shape) == rs_i.shape == (2, m, 1)
    bar = BF16_ULP if dtype == jnp.bfloat16 else 1e-5
    for ref_y, ref_rs in ((y_i, rs_i), (y_r, rs_r)):
        ref_y, ref_rs = _np(ref_y), _np(ref_rs)
        assert np.abs(_np(y) - ref_y).max() <= bar * np.abs(ref_y).max()
        assert np.abs(_np(rs) - ref_rs).max() <= 1e-5 * np.abs(ref_rs).max()


def test_linear_rstat_grads_match_jax():
    x, p = _mk(64, 32, 48, dtype=jnp.float32)

    def loss(p, x):
        y, rs = jms._linear_rstat_ref(x, p["kernel"], p["bias"], 1e-6)
        return jnp.sum(y ** 2) + jnp.sum(rs ** 2)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    tx = _t(x).requires_grad_()
    y, rs = tms.linear_rstat(tp, tx, 1e-6)
    (y.square().sum() + rs.square().sum()).backward()
    for got, ref in ((tp["kernel"].grad, gp["kernel"]), (tp["bias"].grad, gp["bias"]),
                     (tx.grad, gx)):
        ref = _np(ref)
        assert np.abs(_np(got) - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


def test_linear_rstat_cpu_launches_no_kernel():
    x, p = _mk(33, dtype=jnp.float32)
    tms.reset_launch_counts()
    tms.linear_rstat(_port_p(p), _t(x))
    assert tms.LAUNCHES == {"linear_rstat": 0}


def _stat(x):
    xf = x.astype(jnp.float32)
    return jax.lax.rsqrt(jnp.mean(xf * xf, -1, keepdims=True) + 1e-6)


@pytest.mark.parametrize("window", [(-1, -1), (64, 32)])
def test_self_rstats_matches_jax(window):
    q, k, v, cos, sin, gq, gk, N, HD = fused_attention_inputs()
    rq, rk = _stat(q) * 1.01, _stat(k) * 0.99  # producer stats, not re-derivable
    ref = jax.jit(lambda *a: jfa.fused_rope_rms_attention(
        *a[:7], num_heads=N, window_size=window, impl="pallas",
        rstats=a[7:]))(q, k, v, cos, sin, gq, gk, rq, rk)
    got = tfa.fused_rope_rms_attention(
        *(_t(a) for a in (q, k, v, cos, sin, gq, gk)), num_heads=N,
        window_size=window, rstats=(_t(rq), _t(rk)))
    assert np.abs(_np(got) - _np(ref)).max() <= 1e-4 * np.abs(_np(ref)).max()


def test_cross_rq_matches_jax():
    q, k, v, _, _, gq, gk, N, HD = fused_attention_inputs()
    k, v = k[:, :77], v[:, :77]
    rq = _stat(q) * 1.01
    ref = jax.jit(lambda *a: jfa.fused_rms_cross_attention(
        *a[:5], num_heads=N, impl="pallas", rq=a[5]))(q, k, v, gq, gk, rq)
    got = tfa.fused_rms_cross_attention(*(_t(a) for a in (q, k, v, gq, gk)),
                                        num_heads=N, rq=_t(rq))
    assert np.abs(_np(got) - _np(ref)).max() <= 1e-4 * np.abs(_np(ref)).max()


@pytest.mark.parametrize("flavor", ["self", "cross"])
def test_rs_grad_path_matches_jax(flavor):
    """Under grad the producer-statistic flavors run the `_rs` unfused math;
    gradients reach q, the statistics and the norm scales."""
    q, k, v, cos, sin, gq, gk, N, HD = fused_attention_inputs(S=130)
    cos, sin = cos[:130], sin[:130]
    w = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    rq, rk = _stat(q) * 1.01, _stat(k) * 0.99

    if flavor == "self":
        def jf(q, rq, rk, gq):
            return jnp.sum(jfa.fused_rope_rms_attention(
                q, k, v, cos, sin, gq, gk, num_heads=N, impl="pallas",
                rstats=(rq, rk)) * w)
    else:
        def jf(q, rq, rk, gq):
            return jnp.sum(jfa.fused_rms_cross_attention(
                q, k[:, :77], v[:, :77], gq, gk, num_heads=N, impl="pallas",
                rq=rq) * w)
    refs = jax.jit(jax.grad(jf, argnums=(0, 1, 2, 3)))(q, rq, rk, gq)

    tq, trq, trk, tgq = (_t(a).requires_grad_() for a in (q, rq, rk, gq))
    tk, tv, tgk = _t(k), _t(v), _t(gk)
    if flavor == "self":
        out = tfa.fused_rope_rms_attention(tq, tk, tv, _t(cos), _t(sin), tgq, tgk,
                                           num_heads=N, rstats=(trq, trk))
    else:
        out = tfa.fused_rms_cross_attention(tq, tk[:, :77], tv[:, :77], tgq, tgk,
                                            num_heads=N, rq=trq)
    (out * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tq, trq, trk, tgq), refs):
        ref = _np(ref)
        if flavor == "cross" and got is trk:
            assert got.grad is None and not ref.any()
            continue
        assert np.abs(_np(got.grad) - ref).max() <= 1e-4 * np.abs(ref).max()


def _port_cfg(cfg):
    return tconfig.WanDiTConfig(**dataclasses.asdict(cfg))


def _flags(module, **values):
    """Set module globals; returns the previous values."""
    old = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    return old


def test_model_proj_stat_fusion_matches_jax():
    cfg, params, (x, t, ctx, cos, sin) = tiny_wan_setup()
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    args = [torch.from_numpy(np.array(a)) for a in (x, t, ctx, cos, sin)]
    old_j = _flags(jwan, PROJ_STAT_FUSION=True)
    old_t = _flags(twan, PROJ_STAT_FUSION=True)
    try:
        ref = jax.jit(lambda p, *a: jwan.wan_dit_forward(p, cfg, *a, attn_impl="pallas"))(
            params, x, t, ctx, cos, sin)
        on = twan.wan_dit_forward(tp, _port_cfg(cfg), *args)
        twan.PROJ_STAT_FUSION = False
        off = twan.wan_dit_forward(tp, _port_cfg(cfg), *args)
    finally:
        _flags(jwan, **old_j)
        _flags(twan, **old_t)
    ref = _np(ref)
    assert np.abs(_np(on) - ref).max() <= 1e-4 * np.abs(ref).max()
    assert np.abs(_np(on) - _np(off)).max() <= 1e-4 * np.abs(_np(off)).max()


def test_model_proj_stat_fusion_calls_linear_rstat(monkeypatch):
    """2 self q/k + 1 cross q statistic per block, none with the flag off."""
    calls = []
    real = twan.linear_rstat
    monkeypatch.setattr(twan, "linear_rstat", lambda *a: calls.append(1) or real(*a))
    cfg, params, (x, t, ctx, cos, sin) = tiny_wan_setup()
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    args = [torch.from_numpy(np.array(a)) for a in (x, t, ctx, cos, sin)]
    twan.wan_dit_forward(tp, _port_cfg(cfg), *args)
    assert calls == []
    monkeypatch.setattr(twan, "PROJ_STAT_FUSION", True)
    twan.wan_dit_forward(tp, _port_cfg(cfg), *args)
    assert len(calls) == 3 * cfg.num_layers


def test_train_step_with_proj_stat_fusion_matches_jax():
    """One GeoAdapter train step with PROJ_STAT_FUSION on in both packages:
    loss and per-leaf gradients at the bars of test_torch_train_step.py."""
    import optax
    from test_torch_train_step import CFG, TCFG, _flat, _setup
    from versecrafter_tpu.parallel import train_step as jts
    from versecrafter_tpu_torch.parallel import train_step as tts

    params, (x0, ctx, cos, sin, geo) = _setup(seed=6)
    key = jax.random.key(4)
    train, frozen = jts.split_trainable(params)
    k_sig, k_eps = jax.random.split(key)
    sig = np.asarray(jax.random.uniform(k_sig, (1,), jnp.float32))
    noise = np.asarray(jax.random.normal(k_eps, x0.shape, jnp.float32))
    old_j = _flags(jwan, PROJ_STAT_FUSION=True)
    old_t = _flags(twan, PROJ_STAT_FUSION=True)
    try:
        loss, grads = jax.jit(jax.value_and_grad(lambda tr: jts.flow_matching_loss(
            {**frozen, **tr}, CFG, key, x0, ctx, cos, sin, geoada_context=geo)))(train)
        tp = params_from_jax(params)
        ttrain, _ = tts.split_trainable(tp)
        tstep = tts.make_train_step(TCFG, tts.make_optimizer(ttrain, 1e-3, 1e-2))
        tloss = tstep(tp, *(torch.from_numpy(a) for a in (x0, ctx, cos, sin, geo)),
                      sig=torch.from_numpy(sig), noise=torch.from_numpy(noise))
    finally:
        _flags(jwan, **old_j)
        _flags(twan, **old_t)
    assert abs(float(tloss) - float(loss)) <= 1e-5 * abs(float(loss))
    got = {k: v.grad for k, v in _flat(ttrain).items()}
    ref = _flat(params_from_jax(jax.tree.map(np.asarray, grads)))
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        r = _np(r)
        assert np.abs(_np(got[k]) - r).max() <= 1e-3 * np.abs(r).max() + 1e-12, k
