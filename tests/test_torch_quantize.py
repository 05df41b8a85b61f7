"""Port parity for quantization (utils/quantize.py and its users): the
port's quantize_tree, dequantize_*, int8_compute_dot (every scale mode,
W4A8, chunked), tag_int8_compute and fit_act_scales against the jitted JAX
functions bit for bit; calibration stats; the DiT + GeoAdapter forward in
the five modes (int8, int4, W8A8 dynamic, W8A8 static, W4A8) within
1e-4 * max (fp32); a W8A8 TeaCache + cfg-skip pipeline request giving the
JAX schedule and latents; params_from_jax and checkpoints of quantized
trees; the safetensors writer; and the serving / CLI / subprocess-tier
quantize params (CPU).

The JAX package decides what to quantize on its stacked [L, ...] blocks;
the tiny models here have small kernels, so MIN_SIZE is lowered in both
packages, as the JAX package's own tests lower it."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import _inputs, _rel_err, pipes  # noqa: F401 (fixture)
from test_torch_teacache import (SHIFT, SKIP_START, STEPS, THRESHOLD, _configure,
                                 _expected_schedule, _reset, _tea_run)
from test_torch_wan_dit import GEO_CFG, _geo_setup, _port_cfg
from versecrafter_tpu.models.wan_dit import wan_dit_forward
from versecrafter_tpu.utils import quantize as jq
from versecrafter_tpu_torch.core import checkpoint as tckpt
from versecrafter_tpu_torch.core import convert as tconvert
from versecrafter_tpu_torch.core.convert import params_from_jax
from versecrafter_tpu_torch.models import wan_dit as twan
from versecrafter_tpu_torch.serve import model_server as tserve
from versecrafter_tpu_torch.utils import quantize as tq

SMALL = 1 << 10


@pytest.fixture
def small_min_size(monkeypatch):
    monkeypatch.setattr(jq, "MIN_SIZE", SMALL)
    monkeypatch.setattr(tq, "MIN_SIZE", SMALL)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_equal(got, want, path=""):
    """Same structure, and every leaf the same dtype, shape and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, sorted(got))
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_trees_equal(a, b, f"{path}[{i}]")
    else:
        assert (got.dtype, tuple(got.shape)) == (want.dtype, tuple(want.shape)), path
        assert torch.equal(got, want), path


def _tree(dtype, seed=0):
    """A stacked tree in the JAX layout: block kernels (one with an odd
    contracting dim), stacked biases / norm scales / modulation, fp32 time
    kernels and a bf16-or-fp32 text embedding, numpy leaves."""
    rng = np.random.default_rng(seed)

    def arr(*shape, dt=dtype):
        return jnp.asarray(rng.standard_normal(shape), dt)

    L = 3
    return _np_tree({
        "blocks": {"ffn_in": {"kernel": arr(L, 256, 160), "bias": arr(L, 160)},
                   "ffn_out": {"kernel": arr(L, 160, 256)},
                   "self_attn": {"q": {"kernel": arr(L, 96, 96)},
                                 "norm_q": {"scale": arr(L, 96, dt=jnp.float32)}},
                   "odd": {"kernel": arr(L, 129, 64)},
                   "modulation": arr(L, 6, 256, dt=jnp.float32)},
        "time_embedding": {"fc1": {"kernel": arr(32, 256, dt=jnp.float32)}},
        "time_projection": {"kernel": arr(256, 192, dt=jnp.float32)},
        "text_embedding": {"fc1": {"kernel": arr(48, 64)}},
        "head": {"modulation": arr(2, 256, dt=jnp.float32)},
    })


QUANT_CASES = [(8, None), (4, None), (4, 0), (8, 32), (4, 64)]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("bits,group_size", QUANT_CASES)
def test_quantize_and_dequantize_match_jax(small_min_size, bits, group_size, dtype):
    tree = _tree(dtype)
    ref = jax.jit(lambda t: jq.quantize_tree(t, bits=bits, group_size=group_size))(tree)
    got = tq.quantize_tree(params_from_jax(tree), bits, group_size)
    _assert_trees_equal(got, params_from_jax(_np_tree(ref)))
    blocks = got["blocks"][1]
    # biases, norm scales and modulation stay; an odd K stays under int4
    assert isinstance(blocks["ffn_in"]["bias"], torch.Tensor)
    assert isinstance(blocks["self_attn"]["norm_q"]["scale"], torch.Tensor)
    assert isinstance(blocks["modulation"], torch.Tensor)
    assert isinstance(blocks["odd"]["kernel"], dict) == (bits == 8)
    # the fp32 time kernels keep their dtype in the token
    assert got["time_projection"]["kernel"]["qdtype"].dtype == torch.float32
    assert got["text_embedding"]["fc1"]["kernel"]["qdtype"].dtype == getattr(
        torch, jnp.dtype(dtype).name)
    for out_dtype in (None, jnp.bfloat16):
        deq = jax.jit(lambda t: jq.dequantize_tree(t, dtype=out_dtype))(ref)
        tdt = None if out_dtype is None else torch.bfloat16
        _assert_trees_equal(tq.dequantize_tree(got, tdt), params_from_jax(_np_tree(deq)))
    leaf = got["blocks"][0]["ffn_in"]["kernel"]
    want = jax.jit(jq.dequantize_leaf)(jax.tree.map(
        lambda a: a if a.ndim == 1 and a.shape[0] == 0 else a[0],
        ref["blocks"]["ffn_in"]["kernel"]))
    assert torch.equal(tq.dequantize_leaf(leaf), params_from_jax(np.asarray(want)))


def test_min_size_counts_the_block_list_as_a_stack():
    """At the default MIN_SIZE a [64, 512] kernel (32,768 elements) is too
    small alone but not as a stack of 2 (65,536), as in the JAX package."""
    tree = _tree(jnp.float32)
    tree["blocks"] = {"ffn_in": {"kernel": np.ones((2, 64, 512), np.float32)}}
    tree["solo"] = {"kernel": np.ones((64, 512), np.float32)}
    got = tq.quantize_tree(params_from_jax(tree))
    assert tq._is_quantized(got["blocks"][1]["ffn_in"]["kernel"])
    assert isinstance(got["solo"]["kernel"], torch.Tensor)
    assert tq.has_quantized(got) and not tq.has_quantized(params_from_jax(tree))
    assert tq.tree_bytes(got["blocks"][0]) == 64 * 512 + 4 * 512
    with pytest.raises(ValueError, match="8 or 4"):
        tq.quantize_tree(params_from_jax(tree), bits=3)


def _leaf_pair(bits, act_scale=None, K=256, N=160, seed=0):
    """A compute-tagged leaf in both packages (JAX: unstacked)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32)
    scales = None if act_scale is None else {"ffn_in/kernel": np.float32(act_scale)}
    gs = 0 if bits == 4 else None
    jl = jax.jit(lambda t: jq.tag_int8_compute(jq.quantize_tree(t, bits, gs), scales,
                                               stacked=False))({"ffn_in": {"kernel": w}})
    tl = tq.tag_int8_compute(tq.quantize_tree({"ffn_in": {"kernel": torch.from_numpy(w)}},
                                              bits, gs), scales)
    return jl["ffn_in"]["kernel"], tl["ffn_in"]["kernel"]


def _x(shape, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[..., ::7, :] *= 8.0  # outlier rows
    jx = jnp.asarray(x, dtype)
    return jx, torch.from_numpy(np.array(jx, np.float32)).to(getattr(torch, jnp.dtype(dtype).name))


DOT_MODES = ["row", "tensor", "static"]


def _jit_dot(leaf, x):
    """The jitted JAX int8_compute_dot, traced afresh (it reads the module
    flags while tracing, and jax.jit caches by function)."""
    return jax.jit(lambda lf, xx: jq.int8_compute_dot(lf, xx))(leaf, x)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mode", DOT_MODES)
@pytest.mark.parametrize("rows", [(2, 40), (1, 9)])
def test_int8_compute_dot_matches_jax(monkeypatch, small_min_size, mode, bits, dtype, rows):
    monkeypatch.setattr(jq, "ROW_ACT_SCALES", mode == "row")
    monkeypatch.setattr(tq, "ROW_ACT_SCALES", mode == "row")
    jl, tl = _leaf_pair(bits, 0.05 if mode == "static" else None)
    assert ("a_scale" in tl) == (mode == "static") and ("q4values" in tl) == (bits == 4)
    jx, tx = _x((*rows, 256), dtype)
    ref = np.asarray(_jit_dot(jl, jx).astype(jnp.float32))
    got = tq.int8_compute_dot(tl, tx)
    assert got.dtype == tx.dtype and tuple(got.shape) == (*rows, 160)
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("mode", DOT_MODES)
def test_int8_compute_dot_chunked_matches_jax(monkeypatch, small_min_size, mode):
    """With the gate below the rows (64 -> 8-row chunks of 83 rows, the last
    one short) in both packages: still the JAX package's bits, and the
    unchunked result's."""
    monkeypatch.setattr(jq, "ROW_ACT_SCALES", mode == "row")
    monkeypatch.setattr(tq, "ROW_ACT_SCALES", mode == "row")
    jl, tl = _leaf_pair(8, 0.05 if mode == "static" else None)
    jx, tx = _x((83, 256), jnp.bfloat16)
    whole = tq.int8_compute_dot(tl, tx)
    monkeypatch.setattr(jq, "INT8_DOT_CHUNK_ROWS", 64)
    monkeypatch.setattr(tq, "INT8_DOT_CHUNK_ROWS", 64)
    ref = np.asarray(_jit_dot(jl, jx).astype(jnp.float32))
    got = tq.int8_compute_dot(tl, tx)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    assert torch.equal(got, whole)


@pytest.mark.parametrize("sites", [None, ("ffn",)])
@pytest.mark.parametrize("bits,group_size", [(8, None), (4, 0), (4, None)])
def test_tag_int8_compute_matches_jax(small_min_size, sites, bits, group_size):
    tree = _tree(jnp.float32)
    tree["blocks"]["cross_attn"] = {"k": {"kernel": tree["blocks"]["self_attn"]["q"]["kernel"]}}
    scales = {"blocks/ffn_in/kernel": np.asarray([0.1, 0.2, 0.3], np.float32)}
    ref = jax.jit(lambda t: jq.tag_int8_compute(
        jq.quantize_tree(t, bits, group_size), scales, sites=sites))(tree)
    got = tq.tag_int8_compute(tq.quantize_tree(params_from_jax(tree), bits, group_size),
                              scales, sites=sites)
    _assert_trees_equal(got, params_from_jax(_np_tree(ref)))
    b = got["blocks"][2]
    if bits == 4 and group_size is None:  # K = 256: group-wise, left storage-only
        assert not tq.is_compute_tagged(b["ffn_in"]["kernel"])
    else:
        assert float(b["ffn_in"]["kernel"]["a_scale"]) == np.float32(0.3)
        assert ("a_dyn" in b["self_attn"]["q"]["kernel"]) == (sites is None)
    assert not tq.is_compute_tagged(got["text_embedding"]["fc1"]["kernel"])


def test_tag_rejects_scales_of_another_depth(small_min_size):
    q = tq.quantize_tree(params_from_jax(_tree(jnp.float32)))
    with pytest.raises(ValueError, match="expected"):
        tq.tag_int8_compute(q, {"blocks/ffn_in/kernel": torch.ones(4)})


def _forward_pair(seed=0):
    params, (x, t, ctx, cos, sin, g) = _geo_setup(seed)
    args = tuple(torch.from_numpy(a) for a in (x, t, ctx, cos, sin))
    return params, (x, t, ctx, cos, sin, g), args, torch.from_numpy(g)


def _jax_forward(params, inputs, calibrate=False):
    x, t, ctx, cos, sin, g = inputs
    return jax.jit(lambda p, *a: wan_dit_forward(
        p, GEO_CFG, *a[:5], geoada_context=a[5], geoada_scale=0.7, attn_impl="pallas",
        calibrate=calibrate))(params, x, t, ctx, cos, sin, g)


def test_calibration_stats_and_fit_match_jax():
    """calibrate=True gives the JAX stats tree (same sites and [L] / [G]
    shapes; absmaxes of activations that agree to fp32 rounding), and
    fit_act_scales maps the same stats to the same scales bit for bit."""
    params, inputs, args, g = _forward_pair()
    ref_out, ref_stats = _jax_forward(params, inputs, calibrate=True)
    tp = params_from_jax(params)
    out, stats = twan.wan_dit_forward(tp, _port_cfg(GEO_CFG), *args, geoada_context=g,
                                      geoada_scale=0.7, calibrate=True)
    assert _rel_err(out, ref_out) <= 1e-4
    assert sorted(stats) == sorted(ref_stats) == ["blocks", "geoada_blocks"]
    for grp in stats:
        assert sorted(stats[grp]) == sorted(ref_stats[grp])
        for site, v in stats[grp].items():
            r = np.asarray(ref_stats[grp][site])
            assert tuple(v.shape) == r.shape == (len(tp[grp]),), (grp, site)
            np.testing.assert_allclose(v.numpy(), r, rtol=1e-5, err_msg=f"{grp}/{site}")
    # the same stats (the JAX ones, twice with a larger second) -> the same scales
    two = [ref_stats, jax.tree.map(lambda a: a * 1.5, ref_stats)]
    ref_fit = jax.jit(lambda s: jq.fit_act_scales(s, margin=1.1))(two)
    got_fit = tq.fit_act_scales([jax.tree.map(lambda a: torch.from_numpy(np.array(a)), s)
                                 for s in two], margin=1.1)
    assert sorted(got_fit) == sorted(ref_fit)
    for k, v in got_fit.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref_fit[k]))
    with pytest.raises(ValueError, match="remat"):
        twan.wan_dit_blocks(tp, _port_cfg(GEO_CFG), None, None, None, None, None,
                            remat=True, calibrate=True)


FORWARD_MODES = {"int8": (8, False, False), "int4": (4, False, False),
                 "w8a8_dynamic": (8, True, False), "w8a8_static": (8, True, True),
                 "w4a8": (4, True, False)}


def _share_activation_codes(monkeypatch):
    """Has the JAX package record the s8 activation codes of every W8A8
    product (in call order, through an ordered host callback) and the port
    take those codes instead of its own. Returns the per-product list of
    (codes that differed, their distance from a rounding boundary)."""
    from jax.experimental import io_callback

    recorded, flips = [], []
    real_j, real_t = jq._int8_dot_rows, tq._int8_dot_rows

    def record(xq):
        recorded.append(np.asarray(xq))
        return np.zeros((), np.int32)

    def jax_rows(leaf, x, a_global):
        a = a_global if a_global is not None else jnp.maximum(
            jnp.max(jnp.abs(x), axis=-1, keepdims=True).astype(jnp.float32), 1e-8) / 127.0
        xq = jnp.clip(jnp.round(x.astype(jnp.float32) / a), -127, 127).astype(jnp.int8)
        io_callback(record, jax.ShapeDtypeStruct((), jnp.int32), xq, ordered=True)
        return real_j(leaf, x, a_global)

    def port_rows(leaf, w, x, a_global):
        a, mine = tq._quantize_rows(x, a_global)
        r = x.float() / a
        theirs = torch.from_numpy(np.array(recorded[len(flips)]).reshape(x.shape))
        differ = mine != theirs
        flips.append((int(differ.sum()), ((r - r.floor() - 0.5).abs()[differ]).tolist()))
        return tq._rescale(tq._int_mm(theirs, w), a, leaf["qscales"], x.dtype)

    monkeypatch.setattr(jq, "_int8_dot_rows", jax_rows)
    monkeypatch.setattr(tq, "_int8_dot_rows", port_rows)
    return recorded, flips


@pytest.mark.parametrize("mode", list(FORWARD_MODES))
def test_forward_modes_match_jax(small_min_size, monkeypatch, mode):
    """The DiT + GeoAdapter forward (head randomized) with the JAX package's
    quantized tree carried across, and with the port quantizing the
    carried fp32 tree: both within 1e-4 * max of the JAX forward.

    In the W8A8 / W4A8 modes an activation that sits within an fp32 ulp of
    a rounding boundary takes the other int8 code when the two packages'
    fp32 activations differ in their last bit, and one such code moves the
    output by ~1e-3 * max. So there the port takes the JAX package's codes
    (_share_activation_codes), and the test requires that its own codes
    differ from them in at most 1 in 10,000 and only within 1e-3 of a
    boundary (the codes are up to 127, where an fp32 ulp is 7.6e-6)."""
    bits, compute, static = FORWARD_MODES[mode]
    params, inputs, args, g = _forward_pair()
    scales = None
    if static:
        scales = jq.fit_act_scales([_jax_forward(params, inputs, calibrate=True)[1]])
    gs = 0 if bits == 4 and compute else None

    def jquant(p):
        p = jq.quantize_tree(p, bits, gs)
        return jq.tag_int8_compute(p, scales) if compute else p

    qparams = jax.jit(jquant)(params)
    flips = None
    if compute:
        recorded, flips = _share_activation_codes(monkeypatch)
    ref = _jax_forward(qparams, inputs)
    tscales = None if scales is None else {k: torch.from_numpy(np.asarray(v))
                                           for k, v in scales.items()}
    mine = tq.quantize_tree(params_from_jax(params), bits, gs)
    if compute:
        mine = tq.tag_int8_compute(mine, tscales)
    carried = params_from_jax(_np_tree(qparams))
    _assert_trees_equal(mine, carried)
    leaf = mine["blocks"][0]["ffn_in"]["kernel"]
    assert tq.is_compute_tagged(leaf) == compute and ("a_scale" in leaf) == static
    got = twan.wan_dit_forward(mine, _port_cfg(GEO_CFG), *args, geoada_context=g,
                               geoada_scale=0.7)
    assert _rel_err(got, ref) <= 1e-4
    if compute:  # every product's codes shared, few of them differing
        assert len(flips) == len(recorded) == 60  # 10 a block, 6 blocks
        codes = sum(a.size for a in recorded)
        assert sum(n for n, _ in flips) <= codes // 10_000, flips
        assert all(d < 1e-3 for _, ds in flips for d in ds), flips
    # quantization moved the result (the modes are not a no-op)
    plain = twan.wan_dit_forward(params_from_jax(params), _port_cfg(GEO_CFG), *args,
                                 geoada_context=g, geoada_scale=0.7)
    assert _rel_err(got, plain) > 1e-4


def test_ffn_chunking_is_exact(monkeypatch):
    """Above FFN_CHUNK_ROWS the block FFN runs in row chunks (an eighth of
    the gate): the same result, also under autograd, up to the GEMMs'
    summation order (a BLAS may block a 2-row product differently from a
    24-row one), so within 1e-6 of max in fp32."""
    params, inputs, args, g = _forward_pair()
    tp = params_from_jax(params)
    whole = twan.wan_dit_forward(tp, _port_cfg(GEO_CFG), *args, geoada_context=g)
    monkeypatch.setattr(twan, "FFN_CHUNK_ROWS", 20)
    calls = []
    real = twan._ffn
    monkeypatch.setattr(twan, "_ffn", lambda p, x: calls.append(x.shape[0]) or real(p, x))
    chunked = twan.wan_dit_forward(tp, _port_cfg(GEO_CFG), *args, geoada_context=g)
    assert _rel_err(chunked, whole.numpy()) <= 1e-6
    assert calls[:12] == [2] * 12  # 24 rows: ceil(24 / (20 // 8)) chunks of 2
    x = torch.randn(2, 12, 64, generator=torch.Generator().manual_seed(3)).requires_grad_()
    blk = tp["blocks"][0]
    y = twan._ffn_chunked(blk, x)
    y.sum().backward()
    grad = x.grad.clone()
    x.grad = None
    y_whole = real(blk, x)
    y_whole.sum().backward()
    assert _rel_err(y.detach(), y_whole.detach().numpy()) <= 1e-6
    assert _rel_err(grad, x.grad.numpy()) <= 1e-6


def test_pipeline_w8a8_teacache_request_matches_jax(pipes, small_min_size):
    """A tiny batched-CFG request in W8A8 with TeaCache and cfg-skip: the
    JAX skip schedule and latents within 1e-4 * max."""
    jp, tp = pipes
    saved = jp.dit_params, tp.dit_params
    try:
        jp.quantize_weights(int8_compute=True)
        tp.quantize_weights(int8_compute=True)
        assert tq.is_compute_tagged(tp.dit_params["blocks"][0]["ffn_in"]["kernel"])
        assert not tq.is_compute_tagged(tp.dit_params["time_projection"]["kernel"])
        calc = _expected_schedule(jp, 0.34)
        for pipe in (jp, tp):
            _configure(pipe, True, 0.34)
        ref = _tea_run(jp, jnp.float32)
        got = _tea_run(tp, torch.float32)
        hist_j, hist_t = jp.teacache_accum_history, tp.teacache_accum_history
    finally:
        for pipe in (jp, tp):
            _reset(pipe)
        jp.dit_params, tp.dit_params = saved
        jp._jit_cache.clear()
    assert _rel_err(got, ref) <= 1e-4
    assert len(hist_t) == len(hist_j) == STEPS
    for i, (a, b) in enumerate(zip(hist_t, hist_j)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=0)
        assert bool(np.all(a == 0.0)) == calc[i], f"step {i}"
    assert (SHIFT, SKIP_START, THRESHOLD) == (3.0, 1, 20000.0)


def test_quantize_weights_options(pipes, small_min_size):
    _, tp = pipes
    saved = tp.dit_params
    try:
        # a resident high-noise expert takes its own act_scales_high, the low
        # one dynamic scales (tests/test_torch_extras.py holds the pair to the
        # JAX package)
        tp.dit_params_high = saved
        tp.quantize_weights(int8_compute=True, bits=4, int8_sites=("ffn",),
                            act_scales_high={"blocks/ffn_in/kernel":
                                             torch.full((len(saved["blocks"]),), 0.05)})
        hi = tp.dit_params_high["blocks"][3]["ffn_in"]["kernel"]
        assert "a_scale" in hi and float(hi["a_scale"]) == np.float32(0.05)
        assert "a_dyn" in tp.dit_params["blocks"][3]["ffn_in"]["kernel"]
        b = tp.dit_params["blocks"][3]
        assert "q4values" in b["ffn_out"]["kernel"] and tq.is_compute_tagged(b["ffn_out"]["kernel"])
        assert b["ffn_out"]["kernel"]["qscales"].ndim == 2  # per channel under W4A8
        assert not tq.is_compute_tagged(b["self_attn"]["q"]["kernel"])
        assert saved["blocks"][3]["ffn_out"]["kernel"].dtype == torch.float32  # not mutated
        assert tq.tree_bytes(tp.dit_params) < tq.tree_bytes(saved)
    finally:
        tp.dit_params = saved
        tp.dit_params_high = None


def test_params_from_jax_carries_a_quantized_tree(small_min_size):
    """A JAX quantize_tree + tag_int8_compute tree (qdtype tokens, [L]
    a_dyn / a_scale) carried across is the port's quantization of the
    carried bf16 tree, and runs the same forward bit for bit."""
    params, inputs, args, g = _forward_pair()
    bf16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16)
                        if a.dtype == jnp.float32 and a.ndim >= 2 else a, params)
    scales = {"blocks/ffn_in/kernel": np.linspace(0.01, 0.04, 4, dtype=np.float32)}
    ref = jax.jit(lambda p: jq.tag_int8_compute(jq.quantize_tree(p), scales))(bf16)
    carried = params_from_jax(_np_tree(ref))
    mine = tq.tag_int8_compute(tq.quantize_tree(params_from_jax(_np_tree(bf16))), scales)
    _assert_trees_equal(carried, mine)
    blk = carried["blocks"][2]["ffn_in"]["kernel"]
    assert blk["qdtype"].shape == (0,) and blk["qdtype"].dtype == torch.bfloat16
    assert blk["a_scale"].shape == () and float(blk["a_scale"]) == np.float32(0.03)
    x, t, ctx = (a.to(torch.bfloat16) if a.is_floating_point() and a.ndim > 1 else a
                 for a in args[:3])
    runs = [twan.wan_dit_forward(tree, _port_cfg(GEO_CFG), x, t, ctx, *args[3:],
                                 geoada_context=g.to(torch.bfloat16))
            for tree in (carried, mine)]
    assert torch.equal(*runs)


def test_checkpoint_round_trips_a_w4a8_tree(tmp_path, small_min_size):
    params, *_ = _forward_pair()
    tree = tq.tag_int8_compute(tq.quantize_tree(params_from_jax(params), 4, 0))
    assert "q4values" in tree["blocks"][0]["ffn_in"]["kernel"]
    path = str(tmp_path / "q" / "step_000001.pt")
    tckpt.save_checkpoint(path, {"params": tree})
    back = tckpt.load_checkpoint(path, template={"params": tree})
    _assert_trees_equal(back["params"], tree)
    bad = tq.quantize_tree(params_from_jax(params), 8)
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(path, template={"params": bad})


def test_save_safetensors_read_back_by_the_library(tmp_path):
    from safetensors import safe_open

    rng = np.random.default_rng(0)
    want = {"a.bf16": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
            .to(torch.bfloat16),
            "b.f32": torch.from_numpy(rng.standard_normal(7).astype(np.float32)),
            "c.i8": torch.from_numpy(rng.integers(-128, 128, (4, 4)).astype(np.int8)),
            "d.u8": torch.from_numpy(rng.integers(0, 256, (9,)).astype(np.uint8)),
            "e.t": torch.arange(12, dtype=torch.float32).reshape(3, 4).t()}
    path = str(tmp_path / "w.safetensors")
    size = tconvert.save_safetensors(path, want)
    assert size == (tmp_path / "w.safetensors").stat().st_size
    with safe_open(path, framework="pt") as f:
        assert sorted(f.keys()) == sorted(want)
        for k, v in want.items():
            t = f.get_tensor(k)
            assert t.dtype == v.dtype and torch.equal(t, v), k
    back = tconvert.load_torch_state_dict(path)
    for k, v in want.items():
        assert torch.equal(back[k], v), k
    with pytest.raises(ValueError, match="dtype"):
        tconvert.save_safetensors(path, {"x": torch.zeros(2, dtype=torch.complex64)})


@pytest.fixture
def tiny_pipe():
    return tserve.default_pipeline_factory(scale="tiny", device="cpu", seed=0)()


def _tiny_request():
    rng = np.random.default_rng(0)
    controls = [rng.random((1, 3, 5, 16, 16)).astype(np.float32) for _ in range(4)]
    params = {"prompt": "x", "num_inference_steps": 1, "guidance_scale": 2.0,
              "height": 16, "width": 16, "num_frames": 5, "seed": 1}
    return params, controls, np.ones((1, 1, 5, 16, 16), np.float32)


def test_serving_quantizes_once_and_refuses_another_mode(tiny_pipe):
    """The first request with quantize params quantizes the resident DiT;
    the same mode again serves; another mode raises ValueError with every
    toggle restored; a bare quantize_bits means weight quantization."""
    params, controls, mask = _tiny_request()
    assert tserve._requested_quant_mode({"quantize_bits": 4}) == (4, False)
    assert tserve._requested_quant_mode({"int8_compute": True}) == (8, True)
    assert tserve._requested_quant_mode({"quantize_int8": False}) is None
    before = (tiny_pipe.teacache_threshold, tiny_pipe.cfg_skip_ratio, twan.INT8_QK_SCORE)
    out = tserve.run_loaded_request(tiny_pipe, {**params, "int8_compute": True},
                                    controls, mask)
    assert out.dtype == np.uint8 and out.shape == (1, 5, 16, 16, 3)
    assert tiny_pipe._quantized == (8, True)
    assert tq.is_compute_tagged(tiny_pipe.dit_params["blocks"][0]["ffn_in"]["kernel"])
    tserve.run_loaded_request(tiny_pipe, {**params, "quantize_int8": True,
                                          "int8_compute": True}, controls, mask)
    with pytest.raises(ValueError, match="already quantized"):
        tserve.run_loaded_request(tiny_pipe, {**params, "quantize_bits": 4,
                                              "teacache_threshold": 0.1,
                                              "cfg_skip_ratio": 0.5,
                                              "int8_attention": True}, controls, mask)
    assert (tiny_pipe.teacache_threshold, tiny_pipe.cfg_skip_ratio,
            twan.INT8_QK_SCORE) == before


def test_subprocess_tier_passes_quantize_flags(tmp_path):
    from versecrafter_tpu_torch.serve import api_server as tapi

    server = tapi.ApiServer(workdir=str(tmp_path), device="cpu")
    base = {"rendering_maps_path": "/m"}
    tail = ["--teacache_threshold", "0"]
    for params, flags in (({"quantize_bits": 4}, ["--quantize_int8", "--quantize_bits", "4"]),
                          ({"int8_compute": True},
                           ["--quantize_int8", "--quantize_bits", "8", "--int8_compute"]),
                          ({"quantize_int8": False}, [])):
        argv = server._build_subprocess_argv({**base, **params})
        i = argv.index("--teacache_threshold")
        assert argv[i:i + 2] == tail and argv[i + 2:-2] == flags, argv
        assert argv[-2:] == ["--device", "cpu"] and argv[0] == sys.executable
