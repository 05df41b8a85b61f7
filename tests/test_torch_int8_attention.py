"""Port parity for int8 QK^T scoring: the fused RoPE flavor's int8 plain
version (what the CPU runs) against the JAX fused kernel with
int8_score=True in Pallas interpret mode, its envelope against the exact
flavor, its no-op under grad, INT8_QK_SCORE at model level, and the
per-request serving toggle (CPU)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused_attention_setup import fused_attention_inputs, tiny_wan_setup
from versecrafter_tpu.models import wan_dit as jwan
from versecrafter_tpu_torch.core import config as tconfig
from versecrafter_tpu_torch.core.convert import params_from_jax
from versecrafter_tpu_torch.kernels import flash_attention as tfa
from versecrafter_tpu_torch.models import wan_dit as twan
from versecrafter_tpu_torch.serve import model_server as tserve

jfa = importlib.import_module("versecrafter_tpu.kernels.flash_attention")

BF16_BAR = 2 * 2.0 ** -8


def _t(a):
    a = jnp.asarray(a)
    out = torch.from_numpy(np.array(a.astype(jnp.float32)))
    return out.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else out


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def _envelope(got, ref):
    """tests/test_int8_attention.py's bar: max error < 3 % of max|ref| and
    correlation > 0.999."""
    got, ref = _np(got), _np(ref)
    err = np.abs(got - ref).max()
    corr = np.corrcoef(got.ravel(), ref.ravel())[0, 1]
    assert err < 0.03 * np.abs(ref).max() and corr > 0.999, (err, corr)


def _kernel_inputs(dtype=jnp.bfloat16):
    """The JAX kernel's direct inputs and the port's, from one seed."""
    q, k, v, cos, sin, gq, gk, N, HD = fused_attention_inputs()
    q, k, v = (a.astype(dtype) for a in (q, k, v))
    sm = HD ** -0.5
    rq = jax.lax.rsqrt(jnp.mean(jnp.square(q.astype(jnp.float32)), -1, keepdims=True)
                       + 1e-6) * (sm * jfa.LOG2E)
    rk = jax.lax.rsqrt(jnp.mean(jnp.square(k.astype(jnp.float32)), -1, keepdims=True)
                       + 1e-6)
    ci, si = jfa.prepare_fused_rope_tables(cos, sin)
    return q, k, v, rq, rk, ci, si, gq, gk, N, HD


def _jax_int8(q, k, v, rq, rk, ci, si, gq, gk, N, HD, resident, int8=True):
    kl = jnp.full((q.shape[0],), q.shape[1], jnp.int32)
    return jfa._flash_attention_fused_pallas(
        q, k, v, kl, rq, rk, ci, si, gq.reshape(N, 1, HD), gk.reshape(N, 1, HD),
        head_dim=HD, block_q=128, block_kv=128, interpret=True, masked=True,
        window=(-1, -1), resident_kv=resident, int8_score=int8)


def _port_int8(q, k, v, rq, rk, ci, si, gq, gk, N, HD, int8=True):
    return tfa.fused_attention_plain(
        _t(q), _t(k), _t(v), _t(rq)[..., 0], _t(rk)[..., 0], _t(gq), _t(gk),
        _t(ci), _t(si), num_heads=N, int8_score=int8)


def _code_mismatch(q, rq, ci, si, gq, N, HD):
    """Share of q's int8 codes that differ between the port (its transform,
    its quantizer) and the JAX kernel's transform and quantizer formula."""
    B, S, _ = q.shape
    t = tfa._qk_transform(_t(q), _t(rq)[..., 0], _t(gq), _t(ci), _t(si), N)
    got = tfa.quantize_rows(t.view(B, S, N, HD))[0].numpy()
    differ = 0
    for b in range(B):
        for h in range(N):
            t = jfa._qk_transform(q[b, :, h * HD:(h + 1) * HD], rq[b],
                                  gq[h * HD:(h + 1) * HD], ci[:S], si[:S],
                                  interpret=True).astype(jnp.float32)
            sc = jnp.maximum(jnp.max(jnp.abs(t), -1, keepdims=True), 1e-20) / 127.0
            differ += int((np.asarray(jnp.round(t / sc)) != got[b, :, h]).sum())
    return differ / got.size


@pytest.mark.parametrize("resident", [False, True])
def test_int8_plain_matches_jax_kernel(resident):
    args = _kernel_inputs()
    ref = _jax_int8(*args, resident=resident)
    got = _port_int8(*args)
    assert got.dtype == torch.bfloat16
    ref = _np(ref)
    assert np.abs(_np(got) - ref).max() <= BF16_BAR * np.abs(ref).max()
    q, k, v, rq, rk, ci, si, gq, gk, N, HD = args
    share = _code_mismatch(q, rq, ci, si, gq, N, HD)
    print(f"share of q int8 codes that differ from the JAX kernel's: {share:.3g}")
    assert share <= 1e-3


def test_int8_envelope_against_exact_flavor():
    q, k, v, cos, sin, gq, gk, N, HD = fused_attention_inputs()
    q, k, v = (_t(a.astype(jnp.bfloat16)) for a in (q, k, v))
    args = (q, k, v, _t(cos), _t(sin), _t(gq), _t(gk))
    exact = tfa.fused_rope_rms_attention(*args, num_heads=N)
    got = tfa.fused_rope_rms_attention(*args, num_heads=N, int8_score=True)
    _envelope(got, exact)
    assert not torch.equal(got, exact)


def test_int8_matches_jax_public_function():
    q, k, v, cos, sin, gq, gk, N, HD = fused_attention_inputs()
    q, k, v = (a.astype(jnp.bfloat16) for a in (q, k, v))
    ref = jax.jit(lambda *a: jfa.fused_rope_rms_attention(
        *a, num_heads=N, impl="pallas", int8_score=True))(q, k, v, cos, sin, gq, gk)
    got = tfa.fused_rope_rms_attention(*(_t(a) for a in (q, k, v, cos, sin, gq, gk)),
                                       num_heads=N, int8_score=True)
    ref = _np(ref)
    assert np.abs(_np(got) - ref).max() <= BF16_BAR * np.abs(ref).max()


def test_int8_flag_ignored_by_cross_flavor():
    q, k, v, _, _, gq, gk, N, HD = fused_attention_inputs()
    args = [_t(a) for a in (q, k[:, :77], v[:, :77])]
    rq, rk, gqv, gkv = tfa._stats_and_scales(*args[:2], _t(gq), _t(gk), 1e-6, HD ** -0.5)
    a = tfa.fused_attention(*args, rq, rk, gqv, gkv, num_heads=N)
    b = tfa.fused_attention(*args, rq, rk, gqv, gkv, num_heads=N, int8_score=True)
    assert torch.equal(a, b)


def test_int8_is_a_noop_under_grad():
    q, k, v, cos, sin, gq, gk, N, HD = fused_attention_inputs(S=130)
    cos, sin = cos[:130], sin[:130]
    grads = []
    for int8 in (False, True):
        ins = [_t(a).requires_grad_() for a in (q, k, v)]
        out = tfa.fused_rope_rms_attention(*ins, _t(cos), _t(sin), _t(gq), _t(gk),
                                           num_heads=N, int8_score=int8)
        out.square().sum().backward()
        grads.append([t.grad for t in ins])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def test_int8_cpu_launches_no_kernel():
    args = _kernel_inputs()
    before = dict(tfa.LAUNCHES)
    q, k, v, *_ , N, HD = args
    tfa.fused_rope_rms_attention(_t(q), _t(k), _t(v), *(
        _t(a) for a in fused_attention_inputs()[3:7]), num_heads=N, int8_score=True)
    assert tfa.LAUNCHES == before


def _port_cfg(cfg):
    return tconfig.WanDiTConfig(**dataclasses.asdict(cfg))


def test_model_int8_matches_jax():
    cfg, params, (x, t, ctx, cos, sin) = tiny_wan_setup()
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    args = [torch.from_numpy(np.array(a)) for a in (x, t, ctx, cos, sin)]
    old_j, old_t = jwan.INT8_QK_SCORE, twan.INT8_QK_SCORE
    try:
        jwan.INT8_QK_SCORE = twan.INT8_QK_SCORE = True
        ref = jax.jit(lambda p, *a: jwan.wan_dit_forward(p, cfg, *a, attn_impl="pallas"))(
            params, x, t, ctx, cos, sin)
        on = twan.wan_dit_forward(tp, _port_cfg(cfg), *args)
        twan.INT8_QK_SCORE = False
        off = twan.wan_dit_forward(tp, _port_cfg(cfg), *args)
    finally:
        jwan.INT8_QK_SCORE, twan.INT8_QK_SCORE = old_j, old_t
    ref = _np(ref)
    assert np.abs(_np(on) - ref).max() <= 1e-3 * np.abs(ref).max()
    assert not torch.equal(on, off)  # the flag reached the attention
    corr = np.corrcoef(_np(on).ravel(), _np(off).ravel())[0, 1]
    assert corr > 0.999, corr


@pytest.fixture(scope="module")
def tiny_pipe():
    return tserve.default_pipeline_factory(scale="tiny", device="cpu", seed=0)()


def _tiny_request(n=5, h=16, w=16):
    rng = np.random.default_rng(0)
    controls = [rng.random((1, 3, n, h, w)).astype(np.float32) for _ in range(4)]
    mask = np.ones((1, 1, n, h, w), np.float32)
    params = {"prompt": "x", "num_inference_steps": 1, "guidance_scale": 2.0,
              "height": h, "width": w, "num_frames": n, "seed": 1}
    return params, controls, mask


def test_serving_toggle_sets_and_restores(tiny_pipe, monkeypatch):
    params, controls, mask = _tiny_request()
    seen = []
    real = tserve._call_pipe
    monkeypatch.setattr(tserve, "_call_pipe", lambda *a: seen.append(
        twan.INT8_QK_SCORE) or real(*a))
    old = twan.INT8_QK_SCORE
    try:
        twan.INT8_QK_SCORE = False
        out = tserve.run_loaded_request(tiny_pipe, {**params, "int8_attention": True},
                                        controls, mask)
        assert out.dtype == np.uint8 and out.shape == (1, 5, 16, 16, 3)
        assert seen == [True] and twan.INT8_QK_SCORE is False
        twan.INT8_QK_SCORE = True
        # a false quantize flag asks for nothing, as on the JAX server
        tserve.run_loaded_request(tiny_pipe, {**params, "int8_attention": False,
                                              "quantize_int8": False}, controls, mask)
        assert seen == [True, False] and twan.INT8_QK_SCORE is True
    finally:
        twan.INT8_QK_SCORE = old


@pytest.mark.parametrize("bad", [{"teacache_threshold": 0.1}, {"cfg_skip_ratio": 0.2},
                                 {"quantize_bits": 4}, {"int8_compute": True},
                                 {"quantize_int8": True}])
def test_serving_toggle_restored_when_request_raises(tiny_pipe, bad):
    """The TeaCache and cfg-skip params serve the request. A quantization
    param that asks for another mode than the one the resident pipeline was
    quantized in raises ValueError. Either way every toggle is restored
    afterwards."""
    params, controls, mask = _tiny_request()
    old = twan.INT8_QK_SCORE
    before = (tiny_pipe.teacache_threshold, tiny_pipe.teacache_skip_start,
              tiny_pipe.teacache_coefficients, tiny_pipe.cfg_skip_ratio)
    saved_dit = tiny_pipe.dit_params
    try:
        twan.INT8_QK_SCORE = False
        request = {**params, "int8_attention": True, **bad}
        if "teacache_threshold" in bad or "cfg_skip_ratio" in bad:
            out = tserve.run_loaded_request(tiny_pipe, request, controls, mask)
            assert out.dtype == np.uint8 and out.shape == (1, 5, 16, 16, 3)
        else:  # resident in another (bits, int8_compute) mode than asked
            resident = (4, False) if "quantize_int8" in bad else (8, False)
            tiny_pipe.quantize_weights(bits=resident[0])
            tiny_pipe._quantized = resident
            with pytest.raises(ValueError, match="already quantized"):
                tserve.run_loaded_request(tiny_pipe, request, controls, mask)
        assert twan.INT8_QK_SCORE is False
        assert (tiny_pipe.teacache_threshold, tiny_pipe.teacache_skip_start,
                tiny_pipe.teacache_coefficients, tiny_pipe.cfg_skip_ratio) == before
    finally:
        twan.INT8_QK_SCORE = old
        tiny_pipe.dit_params = saved_dit
        tiny_pipe.__dict__.pop("_quantized", None)


def test_pipeline_enable_int8_attention(tiny_pipe):
    old = twan.INT8_QK_SCORE
    try:
        tiny_pipe.enable_int8_attention()
        assert twan.INT8_QK_SCORE is True
        tiny_pipe.enable_int8_attention(False)
        assert twan.INT8_QK_SCORE is False
    finally:
        twan.INT8_QK_SCORE = old
