"""Port parity for the DiT and pipeline extras against the jitted JAX
functions on the same numpy inputs (CPU, fp32, bar 1e-4 * max unless a test
says otherwise): img_emb, the i2v cross-attention, the SimpleAdapter, the
forward with y + clip_fea + y_camera + the GeoAdapter, the JAX package's stacked hint
order, the Wan2.2 timestep-MoE (resident pair, expert swap, TeaCache,
act_scales_high), subject reference frames, the masked init video and the
ValueError cases."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versecrafter_tpu.core.config import T5Config, VAEConfig, WanDiTConfig
from versecrafter_tpu.kernels.rope import grid_cos_sin, rope_3d_angles
from versecrafter_tpu.models import wan_dit as jwan
from versecrafter_tpu.models.t5 import init_t5
from versecrafter_tpu.models.vae import init_vae
from versecrafter_tpu.sampling import pipeline as jpipe
from versecrafter_tpu_torch.core import config as tconfig
from versecrafter_tpu_torch.core.convert import params_from_jax
from versecrafter_tpu_torch.models import wan_dit as twan
from versecrafter_tpu_torch.sampling import pipeline as tpipe
from versecrafter_tpu_torch.utils import quantize as tq
from versecrafter_tpu_torch.utils.tokenizer import HashTokenizer

# i2v (4 noise + 4 conditioning channels) + img_emb + SimpleAdapter +
# GeoAdapter, tiny widths
I2V_CFG = WanDiTConfig(
    model_type="i2v", in_dim=8, dim=64, ffn_dim=128, freq_dim=32, text_dim=32,
    out_dim=4, num_heads=2, num_layers=4, text_len=16, add_img_emb=True,
    img_emb_dim=20, add_control_adapter=True, in_dim_control_adapter=3,
    downscale_factor_control_adapter=4, control_adapter_residual_blocks=2,
    geoada_layers=(), geoada_in_dim=12)
VAE_CFG = VAEConfig(base_dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
                    temporal_downsample=(True,), spatial_compression_ratio=2,
                    temporal_compression_ratio=2, use_latent_stats=False)
T5_CFG = T5Config(vocab=256, dim=32, dim_attn=32, dim_ffn=64, num_heads=4,
                  num_layers=2, num_buckets=8, text_length=16)
MOE_CFG = WanDiTConfig(in_dim=4, dim=64, ffn_dim=128, freq_dim=32, text_dim=32,
                       out_dim=4, num_heads=2, num_layers=2, text_len=16,
                       geoada_layers=(), geoada_in_dim=12)


def _port(cfg, cls=tconfig.WanDiTConfig):
    return cls(**dataclasses.asdict(cfg))


def _to_port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def _rel_err(got, ref):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _t(a):
    return torch.from_numpy(np.asarray(a))


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


def _live(cfg, seed):
    """JAX init with every zero-init projection made random (head,
    GeoAdapter before / after projections) so each stage reaches the
    output."""
    p = jwan.init_wan_dit(jax.random.key(seed), cfg, jnp.float32)
    for i, path in enumerate((("head", "head"), ("geoada_before_proj",),
                              ("geoada_blocks", "after_proj"))):
        leaf = p
        for key in path:
            leaf = leaf[key]
        leaf["kernel"] = jax.random.normal(jax.random.key(seed + 50 + i),
                                           leaf["kernel"].shape) * 0.05
    return p


def _i2v_inputs(seed=6, b=2, f=3, h=4, w=4):
    rng = np.random.default_rng(seed)
    ds = I2V_CFG.downscale_factor_control_adapter
    x = rng.standard_normal((b, 4, f, 2 * h, 2 * w)).astype(np.float32)
    y = rng.standard_normal((b, 4, f, 2 * h, 2 * w)).astype(np.float32)
    clip = rng.standard_normal((b, 7, I2V_CFG.img_emb_dim)).astype(np.float32)
    cam = rng.standard_normal((b, 3, f, 2 * h * ds, 2 * w * ds)).astype(np.float32)
    geo = rng.standard_normal((b, 12, f, 2 * h, 2 * w)).astype(np.float32)
    ctx = rng.standard_normal((b, 16, 32)).astype(np.float32)
    t = np.asarray([700.0, 120.5][:b], np.float32)
    ang = tuple(jnp.asarray(a) for a in rope_3d_angles(32, max_pos=16))
    cos, sin = grid_cos_sin(ang, f, h, w)
    return dict(x=x, y=y, clip=clip, cam=cam, geo=geo, ctx=ctx, t=t,
                cos=np.array(cos), sin=np.array(sin))


def test_img_emb_matches_jax():
    """LayerNorm -> fc1 -> exact (erf) GELU -> fc2 -> LayerNorm, bar 1e-5 *
    max: the tanh GELU would be ~1e-3 off."""
    params = _live(I2V_CFG, 0)
    a = _i2v_inputs()
    ref = jax.jit(lambda p, x, t, c, f: jwan.wan_dit_embed(
        p, I2V_CFG, x, t, c, f)[4])(params, np.concatenate([a["x"], a["y"]], 1), a["t"],
                                    a["ctx"], a["clip"])
    got = twan.img_embedding(_to_port(params), _t(a["clip"]), torch.float32)
    assert tuple(got.shape) == ref.shape == (2, 7, 64)
    assert _rel_err(got, ref) <= 1e-5
    tanh = twan._linear(_to_port(params)["img_emb"]["fc1"], _t(a["clip"]))
    assert not torch.equal(torch.nn.functional.gelu(tanh, approximate="tanh"),
                           torch.nn.functional.gelu(tanh))


def test_i2v_cross_attention_matches_jax():
    """The plain path: q / k RMS-normed, head-major, attention over the text
    keys plus attention over the image keys."""
    params = _live(I2V_CFG, 1)
    blk = jax.tree.map(lambda a: a[1], params["blocks"])["cross_attn"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, 64)).astype(np.float32)
    img = rng.standard_normal((2, 9, 64)).astype(np.float32)
    ref = jax.jit(lambda p, x, c, i: jwan._cross_attention(
        p, x, c, 2, True, 1e-6, "auto", context_img=i))(blk, x, ctx, img)
    calib = {}
    got = twan._cross_attention(_to_port(blk), _t(x), _t(ctx), _port(I2V_CFG), calib,
                                context_img=_t(img))
    assert _rel_err(got, ref) <= 1e-4
    assert {"cross_attn/k_img/kernel", "cross_attn/v_img/kernel"} <= set(calib)
    assert float(calib["cross_attn/k_img/kernel"]) == float(np.abs(img).max())


def test_simple_adapter_matches_jax():
    p = jwan.init_simple_adapter(jax.random.key(3), I2V_CFG, jnp.float32)
    cam = np.random.default_rng(3).standard_normal((2, 3, 3, 32, 48)).astype(np.float32)
    ref = jax.jit(lambda p, c: jwan.simple_adapter(p, c, (2, 2), 4))(p, cam)
    got = twan.simple_adapter(_to_port(p), _t(cam), (2, 2), 4)
    assert tuple(got.shape) == ref.shape == (2, 3 * 4 * 6, 64)
    assert _rel_err(got, ref) <= 1e-4


@pytest.mark.parametrize("stacked", [False, True], ids=["interleaved", "stacked"])
def test_i2v_camera_geoada_forward_matches_jax(stacked, monkeypatch):
    """wan_dit_forward with y + clip_fea + y_camera + the GeoAdapter against
    the JAX package in both of its hint orders (its GEOADA_STACKED_HINTS
    patched, a fresh trace); the port has the interleaved order only."""
    params = _live(I2V_CFG, 4)
    a = _i2v_inputs()
    monkeypatch.setattr(jwan, "GEOADA_STACKED_HINTS", stacked)
    ref = jax.jit(lambda p, x, t, c, cs, sn, g, y, f, cam: jwan.wan_dit_forward(
        p, I2V_CFG, x, t, c, cs, sn, geoada_context=g, geoada_scale=0.7, y=y,
        clip_fea=f, y_camera=cam))(params, a["x"], a["t"], a["ctx"], a["cos"], a["sin"],
                                   a["geo"], a["y"], a["clip"], a["cam"])
    got = twan.wan_dit_forward(
        _to_port(params), _port(I2V_CFG), *(_t(a[k]) for k in ("x", "t", "ctx", "cos", "sin")),
        geoada_context=_t(a["geo"]), geoada_scale=0.7, y=_t(a["y"]), clip_fea=_t(a["clip"]),
        y_camera=_t(a["cam"]))
    assert tuple(got.shape) == ref.shape == (2, 4, 3, 8, 8)
    assert _rel_err(got, ref) <= 1e-4


def test_stacked_hints_equal_interleaved(monkeypatch):
    """The JAX package's stacked hint order (GEOADA_STACKED_HINTS on, the
    reference's all-hints-first order) gives the port's interleaved result
    within 1e-4*max, and the port also calibrates on that order (which the
    JAX stacked order refuses): the calibrated forward's velocity is the
    plain one bit for bit."""
    params = _live(I2V_CFG, 5)
    a = _i2v_inputs(seed=7)
    monkeypatch.setattr(jwan, "GEOADA_STACKED_HINTS", True)
    ref = jax.jit(lambda p, x, t, c, cs, sn, g, y, f, cam: jwan.wan_dit_forward(
        p, I2V_CFG, x, t, c, cs, sn, geoada_context=g, geoada_scale=0.7, y=y,
        clip_fea=f, y_camera=cam))(params, a["x"], a["t"], a["ctx"], a["cos"], a["sin"],
                                   a["geo"], a["y"], a["clip"], a["cam"])
    args = (_to_port(params), _port(I2V_CFG),
            *(_t(a[k]) for k in ("x", "t", "ctx", "cos", "sin")))
    kw = dict(geoada_context=_t(a["geo"]), geoada_scale=0.7, y=_t(a["y"]),
              clip_fea=_t(a["clip"]), y_camera=_t(a["cam"]))
    inter = twan.wan_dit_forward(*args, **kw)
    assert _rel_err(inter, ref) <= 1e-4
    calibrated, stats = twan.wan_dit_forward(*args, **kw, calibrate=True)
    assert torch.equal(calibrated, inter)
    assert set(stats) == {"blocks", "geoada_blocks"}


def test_init_matches_jax_tree():
    """The port's init builds the JAX tree (k_img / v_img / norm_k_img on
    base blocks only, img_emb, control_adapter), shapes and dtypes."""
    ref = _to_port(jwan.init_wan_dit(jax.random.key(0), I2V_CFG, jnp.bfloat16))
    got = twan.init_wan_dit(_port(I2V_CFG), torch.Generator().manual_seed(0))
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_r] == [p for p, _ in flat_g]
    for (path, x), (_, y) in zip(flat_r, flat_g):
        assert (x.shape, x.dtype) == (y.shape, y.dtype), path
    assert "k_img" not in got["geoada_blocks"][0]["cross_attn"]


def test_y_camera_without_adapter_raises():
    """wan_dit_embed refuses camera maps a tree without a SimpleAdapter
    would ignore, with the JAX package's message."""
    cfg = dataclasses.replace(I2V_CFG, add_control_adapter=False)
    params = jax.tree.map(np.asarray, jwan.init_wan_dit(jax.random.key(0), cfg, jnp.float32))
    a = _i2v_inputs(b=1)
    args = (np.concatenate([a["x"], a["y"]], 1), a["t"], a["ctx"])
    with pytest.raises(ValueError, match="no 'control_adapter' entry") as ej:
        jwan.wan_dit_embed(params, cfg, *args, y_camera=a["cam"])
    with pytest.raises(ValueError, match="no 'control_adapter' entry") as et:
        twan.wan_dit_embed(_to_port(params), _port(cfg), *(_t(v) for v in args),
                           y_camera=_t(a["cam"]))
    assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------

def _pipes(cfg, dit, dit_high=None, **kw):
    vae = init_vae(jax.random.key(1), VAE_CFG, jnp.float32)
    t5 = init_t5(jax.random.key(2), T5_CFG, jnp.float32)
    jp = jpipe.VerseCrafterPipeline(
        dit_params=dit, dit_cfg=cfg, vae_params=vae, vae_cfg=VAE_CFG, t5_params=t5,
        t5_cfg=T5_CFG, attn_impl="pallas", tokenizer=HashTokenizer(T5_CFG.vocab),
        dit_params_high=dit_high, **kw)
    tp = tpipe.VerseCrafterPipeline(
        dit_params=_to_port(dit), dit_cfg=_port(cfg), vae_params=_to_port(vae),
        vae_cfg=_port(VAE_CFG, tconfig.VAEConfig), t5_params=_to_port(t5),
        t5_cfg=_port(T5_CFG, tconfig.T5Config), device="cpu",
        dit_params_high=None if dit_high is None else _to_port(dit_high), **kw)
    return jp, tp


@pytest.fixture(scope="module")
def moe_pipes():
    return _pipes(MOE_CFG, _live(MOE_CFG, 0), _live(MOE_CFG, 7), moe_boundary=0.5)


def _moe_run(pipe, dtype, steps=4, **kw):
    rng = np.random.default_rng(0)
    return pipe("x", control_videos=[rng.random((1, 3, 5, 8, 8)).astype(np.float32)
                                     for _ in range(2)],
                mask_video=np.ones((1, 1, 5, 8, 8), np.float32), height=8, width=8,
                num_frames=5, num_inference_steps=steps, guidance_scale=2.0, shift=8.0,
                seed=3, dtype=dtype, output_type="latent", **kw)


@pytest.mark.parametrize("case", ["selects_high_early", "boundary_above_one_is_identity",
                                  "identical_experts_match_single"])
def test_moe_cases(moe_pipes, case):
    """The port's tests/test_moe.py cases, each also held to the JAX
    pipeline's latents."""
    jp, tp = moe_pipes
    saved = (tp.dit_params_high, tp.moe_boundary, jp.dit_params_high, jp.moe_boundary)
    try:
        single = _moe_run(dataclasses.replace(tp, dit_params_high=None), torch.float32)
        if case == "boundary_above_one_is_identity":
            tp.moe_boundary = jp.moe_boundary = 1.01
        elif case == "identical_experts_match_single":
            tp.dit_params_high, jp.dit_params_high = tp.dit_params, jp.dit_params
        got = _moe_run(tp, torch.float32)
        ref = _moe_run(jp, jnp.float32)
        assert _rel_err(got, ref) <= 1e-4
        if case == "selects_high_early":
            assert (got - single).abs().max() > 1e-6
        elif case == "boundary_above_one_is_identity":
            assert torch.equal(got, single)
        else:
            torch.testing.assert_close(got, single, rtol=1e-5, atol=1e-6)
    finally:
        tp.dit_params_high, tp.moe_boundary, jp.dit_params_high, jp.moe_boundary = saved


def test_staged_expert_swap_matches_resident_moe(moe_pipes):
    """expert_swap gives the resident pair's latents bit for bit, builds each
    expert once in the order the schedule needs them, and drops the resident
    expert before it builds the other."""
    _, tp = moe_pipes
    resident = _moe_run(tp, torch.float32)
    high, low = tp.dit_params_high, tp.dit_params
    calls = []
    shell = dataclasses.replace(tp, dit_params=None, dit_params_high=None)

    def swap(which):
        assert shell.dit_params is None  # the old expert was dropped first
        calls.append(which)
        return high if which == "high" else low

    shell.expert_swap = swap
    staged = _moe_run(shell, torch.float32)
    assert calls == ["high", "low"]
    assert torch.equal(staged, resident)
    with pytest.raises(ValueError, match="mutually exclusive"):
        _moe_run(dataclasses.replace(tp, expert_swap=swap), torch.float32)


@pytest.mark.parametrize("cfg_parallel", [True, False], ids=["batched", "sequential"])
def test_generate_staged_expert_swap_matches_resident_pair(moe_pipes, cfg_parallel):
    """The expert swap under staged residency (sampling/staged.py: umT5, the
    VAE and each expert built and freed in turn) gives the resident pair's
    frames bit for bit, high expert first, no dit_build stage."""
    from versecrafter_tpu_torch.sampling import staged as tstaged

    _, tp = moe_pipes
    rng = np.random.default_rng(0)
    kw = dict(control_videos=[rng.random((1, 3, 5, 8, 8)).astype(np.float32) for _ in range(2)],
              mask_video=np.ones((1, 1, 5, 8, 8), np.float32), height=8, width=8,
              num_frames=5, num_inference_steps=4, guidance_scale=2.0, shift=8.0, seed=3,
              dtype=torch.float32, output_type="numpy")
    ref = dataclasses.replace(tp, cfg_parallel=cfg_parallel)("x", **kw)
    high, low, calls = tp.dit_params_high, tp.dit_params, []
    shell = dataclasses.replace(tp, dit_params=None, dit_params_high=None, vae_params=None,
                                t5_params=None, cfg_parallel=cfg_parallel)
    shell.expert_swap = lambda which: calls.append(which) or (high if which == "high" else low)
    factories = tstaged.StageFactories(lambda: tp.t5_params, lambda: tp.vae_params,
                                       lambda: low, 0)
    got = tstaged.generate_staged(shell, factories, "x", **kw)
    assert calls == ["high", "low"] and "dit_build" not in shell.last_stage_profile
    assert np.array_equal(got, ref)
    assert shell.dit_params is None and shell.vae_params is None


@pytest.mark.parametrize("cfg_parallel", [True, False], ids=["batched", "sequential"])
def test_moe_teacache_cfg_skip_matches_jax(moe_pipes, cfg_parallel):
    """TeaCache + cfg-skip across the expert boundary: the JAX schedule
    (the accumulator history: C S C S S C at 30,000, the random weights'
    rescaled e0 distances being ~5,000-14,000 a step) and latents; each
    skipped step's accumulator stays 5 % clear of the threshold."""
    jp, tp = moe_pipes
    try:
        for p in (jp, tp):
            p.enable_teacache(30000.0, skip_start=1)
            p.enable_cfg_skip(0.25)
            p.cfg_parallel = cfg_parallel
            p.teacache_debug = True
        ref = _moe_run(jp, jnp.float32, steps=6)
        got = _moe_run(tp, torch.float32, steps=6)
        hist_j = [np.asarray(a) for a in jp.teacache_accum_history]
        hist_t = tp.teacache_accum_history
    finally:
        for p in (jp, tp):
            p.disable_teacache()
            p.enable_cfg_skip(0.0)
            p.cfg_parallel = True
            p.teacache_debug = False
    assert len(hist_t) == len(hist_j) == 6
    calc = [bool(np.all(a == 0.0)) for a in hist_j]
    assert any(calc[1:]) and not all(calc), calc
    for a, b in zip(hist_t, hist_j):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
        assert np.all((b == 0) | (np.abs(b - 30000.0) > 0.05 * 30000.0)), b
    assert _rel_err(got, ref) <= 1e-4


@pytest.mark.parametrize("scales", ["dynamic", "own"])
def test_quantize_act_scales_high_matches_jax(moe_pipes, scales, monkeypatch):
    """quantize_weights(int8_compute=True) quantizes the resident high
    expert with its own calibrated scales, or dynamic ones without them:
    both experts' trees equal the jitted JAX quantize_tree +
    tag_int8_compute bit for bit (the JAX pipeline's quantize_weights runs
    them eagerly, and eager JAX divides by 127 where XLA multiplies by the
    reciprocal). The request's latents are not held to JAX's: an activation
    one ulp from an int8 rounding boundary may take the other code (ROADMAP
    §3; tests/test_torch_quantize.py shares the codes for that); the high
    expert's own scales must change them."""
    from versecrafter_tpu.utils import quantize as jq
    monkeypatch.setattr(jq, "MIN_SIZE", 1 << 10)
    monkeypatch.setattr(tq, "MIN_SIZE", 1 << 10)
    jp, tp = moe_pipes
    jp2 = dataclasses.replace(jp)
    tp2 = dataclasses.replace(tp)
    low = {"blocks/ffn_in/kernel": np.full((2,), 3.0 / 127, np.float32)}
    high = ({"blocks/ffn_in/kernel": np.full((2,), 9.0 / 127, np.float32)}
            if scales == "own" else None)

    def port(sc):
        return None if sc is None else {k: torch.from_numpy(v) for k, v in sc.items()}

    def jq_w8a8(tree, sc):  # the jitted JAX quantize + tag (XLA's / 127)
        return jax.jit(lambda p: jq.tag_int8_compute(jq.quantize_tree(p), sc))(tree)

    jp2.dit_params = jq_w8a8(jp.dit_params, low)
    jp2.dit_params_high = jq_w8a8(jp.dit_params_high, high)
    tp2.quantize_weights(int8_compute=True, act_scales=port(low), act_scales_high=port(high))
    for name in ("dit_params", "dit_params_high"):
        _assert_trees_equal(getattr(tp2, name), _to_port(getattr(jp2, name)), name)
    a_high = tp2.dit_params_high["blocks"][1]["ffn_in"]["kernel"]
    assert ("a_scale" in a_high) == (scales == "own")
    assert tq.is_compute_tagged(tp2.dit_params_high["blocks"][0]["ffn_in"]["kernel"])
    assert tp.dit_params_high["blocks"][0]["ffn_in"]["kernel"].dtype == torch.float32
    got = _moe_run(tp2, torch.float32)
    assert torch.isfinite(got).all()
    if scales == "own":
        tp3 = dataclasses.replace(tp)
        tp3.quantize_weights(int8_compute=True, act_scales=port(low))
        assert (_moe_run(tp3, torch.float32) - got).abs().max() > 1e-4


def test_factory_builds_a_quantized_expert_pair():
    """default_pipeline_factory(moe=True, quantize=(8, True)) builds the
    resident pair (low expert from seed, high from seed + 1) and quantizes
    each as it is built: its trees, and a 2-step request across the
    boundary, equal a bf16 pair quantized afterwards by quantize_weights,
    bit for bit (the tiny scale's head, below MIN_SIZE and zero-init, made
    random alike in both, so the experts reach the latents)."""
    from versecrafter_tpu_torch.serve import model_server as tserver

    def factory(**kw):
        pipe = tserver.default_pipeline_factory(scale="tiny", device="cpu", seed=3,
                                                moe=True, **kw)()
        for name in ("dit_params", "dit_params_high"):
            w = getattr(pipe, name)["head"]["head"]["kernel"]
            w.copy_(torch.randn(w.shape, generator=torch.Generator().manual_seed(5)))
        return pipe

    got = factory(quantize=(8, True))
    ref = factory()
    ref.quantize_weights(int8_compute=True)
    for name in ("dit_params", "dit_params_high"):
        _assert_trees_equal(getattr(got, name), getattr(ref, name), name)
    assert got._quantized == (8, True)
    assert tq.is_compute_tagged(got.dit_params_high["blocks"][0]["ffn_in"]["kernel"])
    geo = np.random.default_rng(4).standard_normal((1, 128, 2, 2, 2)).astype(np.float32)
    kw = dict(geoada_context=torch.from_numpy(geo), height=16, width=16, num_frames=5,
              timesteps=[950.0, 500.0], seed=6, output_type="latent")
    lat = got("x", **kw)
    assert torch.isfinite(lat).all() and torch.equal(lat, ref("x", **kw))


@pytest.fixture(scope="module")
def i2v_pipes():
    return _pipes(I2V_CFG, _live(I2V_CFG, 0), scheduler_name="euler")


def _cond_inputs(seed=0, f=2):
    rng = np.random.default_rng(seed)
    hl = wl = 4
    return dict(
        y=rng.standard_normal((1, 4, f, hl, wl)).astype(np.float32),
        clip_fea=rng.standard_normal((1, 5, 20)).astype(np.float32),
        camera_video=rng.standard_normal((1, 3, f, hl * 4, wl * 4)).astype(np.float32),
        geoada_context=rng.standard_normal((1, 12, f, hl, wl)).astype(np.float32))


@pytest.mark.parametrize("teacache", [False, True])
def test_conditioning_request_matches_jax(i2v_pipes, teacache):
    """y / clip_fea / camera_video through the whole request (plain and
    TeaCache paths), each input changing the result."""
    jp, tp = i2v_pipes
    kw = dict(height=8, width=8, num_inference_steps=3, guidance_scale=2.0, shift=3.0,
              seed=0, output_type="latent")
    a = _cond_inputs()
    try:
        if teacache:
            jp.enable_teacache(0.05, skip_start=1)
            tp.enable_teacache(0.05, skip_start=1)
        ref = jp("a prompt", dtype=jnp.float32, **a, **kw)
        got = tp("a prompt", dtype=torch.float32, **a, **kw)
        assert _rel_err(got, ref) <= 1e-4
        for drop in ("clip_fea", "camera_video"):
            other = tp("a prompt", dtype=torch.float32,
                       **{k: v for k, v in a.items() if k != drop}, **kw)
            assert (other - got).abs().max() > 1e-7, drop
    finally:
        jp.disable_teacache()
        tp.disable_teacache()


def test_clip_image_request_matches_jax(i2v_pipes):
    """clip_image= encoded by the pipelines' CLIP towers (TEST_TINY widths
    feeding an img_emb_dim of 32), broadcast to the batch."""
    from versecrafter_tpu.models import clip as jclip
    jp, tp = i2v_pipes
    cfg = dataclasses.replace(I2V_CFG, img_emb_dim=32)
    dit = _live(cfg, 3)
    clip = jclip.init_clip_vision(jax.random.key(4), jclip.TEST_TINY)
    jp2 = dataclasses.replace(jp, dit_params=dit, dit_cfg=cfg, clip_params=clip,
                              clip_cfg=jclip.TEST_TINY)
    tp2 = dataclasses.replace(tp, dit_params=_to_port(dit), dit_cfg=_port(cfg),
                              clip_params=_to_port(clip), clip_cfg=jclip.TEST_TINY)
    img = (np.random.default_rng(8).random((30, 40, 3)) * 255).astype(np.uint8)
    a = {k: v for k, v in _cond_inputs(1).items() if k != "clip_fea"}
    kw = dict(height=8, width=8, num_inference_steps=2, guidance_scale=2.0, shift=3.0,
              seed=0, output_type="latent", clip_image=img, **a)
    ref = jp2(["p0", "p1"], negative_prompt="", dtype=jnp.float32,
              **{k: (np.concatenate([v, v]) if k in a else v) for k, v in kw.items()})
    got = tp2(["p0", "p1"], negative_prompt="", dtype=torch.float32,
              **{k: (np.concatenate([v, v]) if k in a else v) for k, v in kw.items()})
    assert tuple(got.shape) == (2, 4, 2, 4, 4)
    assert _rel_err(got, ref) <= 1e-4
    assert "clip_encode" in tp2.last_wall_profile


@pytest.mark.parametrize("case", ["clip_image_without_tower", "camera_without_adapter",
                                  "video_without_mask"])
def test_pipeline_value_errors_match_jax(i2v_pipes, case):
    jp, tp = i2v_pipes
    cfg = dataclasses.replace(I2V_CFG, add_control_adapter=False)
    dit = jwan.init_wan_dit(jax.random.key(0), cfg, jnp.float32)
    pipes = (dataclasses.replace(jp, dit_params=dit, dit_cfg=cfg),
             dataclasses.replace(tp, dit_params=_to_port(dit), dit_cfg=_port(cfg)))
    kw = {"clip_image_without_tower": dict(clip_image=np.zeros((32, 32, 3), np.uint8)),
          "camera_without_adapter": dict(camera_video=np.zeros((1, 3, 2, 16, 16),
                                                               np.float32)),
          "video_without_mask": dict(video=np.zeros((1, 3, 3, 8, 8), np.float32))}[case]
    match = {"clip_image_without_tower": "clip_params",
             "camera_without_adapter": "control_adapter",
             "video_without_mask": "needs mask_video"}[case]
    for pipe, dtype in zip(pipes, (jnp.float32, torch.float32)):
        geo = None if case == "video_without_mask" else np.zeros((1, 12, 2, 4, 4), np.float32)
        with pytest.raises(ValueError, match=match):
            pipe("x", geoada_context=geo, height=8, width=8, num_frames=3,
                 num_inference_steps=1, dtype=dtype, output_type="latent", **kw)


@pytest.fixture(scope="module")
def t2v_pipes():
    return _pipes(MOE_CFG, _live(MOE_CFG, 2))


def test_subject_ref_images_request_matches_jax(t2v_pipes):
    """One reference frame prepended: the noise is drawn at T' + 1 latent
    frames, the slot stripped before the decode; latents and frames equal
    the JAX pipeline's."""
    jp, tp = t2v_pipes
    rng = np.random.default_rng(5)
    controls = [rng.random((1, 3, 5, 8, 8)).astype(np.float32) for _ in range(2)]
    ref_img = [rng.random((1, 3, 1, 8, 8)).astype(np.float32)]
    mask = np.ones((1, 1, 5, 8, 8), np.float32)
    ctx_j, n_j = jp.encode_controls(controls, mask, jnp.float32, subject_ref_images=ref_img)
    ctx_t, n_t = tp.encode_controls(controls, mask, torch.float32, subject_ref_images=ref_img)
    assert n_t == n_j == 1 and tuple(ctx_t.shape) == ctx_j.shape == (1, 12, 4, 4, 4)
    assert _rel_err(ctx_t, ctx_j) <= 1e-4
    kw = dict(control_videos=controls, mask_video=mask, subject_ref_images=ref_img,
              height=8, width=8, num_frames=5, num_inference_steps=2, guidance_scale=2.0,
              shift=3.0, seed=9)
    drawn = []
    orig = tpipe.prng.normal

    def spy(key, shape, dtype):
        drawn.append(tuple(shape))
        return orig(key, shape, dtype)

    tpipe.prng.normal = spy
    try:
        got = tp("x", dtype=torch.float32, output_type="latent", **kw)
        frames = tp("x", dtype=torch.float32, output_type="numpy", **kw)
    finally:
        tpipe.prng.normal = orig
    assert drawn[0] == (1, 4, 4, 4, 4)  # T' + R = 3 + 1 latent frames
    ref = jp("x", dtype=jnp.float32, output_type="latent", **kw)
    assert tuple(got.shape) == ref.shape == (1, 4, 3, 4, 4)
    assert _rel_err(got, ref) <= 1e-4
    ref_frames = jp("x", dtype=jnp.float32, output_type="numpy", **kw)
    assert frames.shape == ref_frames.shape == (1, 5, 8, 8, 3)
    assert _rel_err(frames, ref_frames) <= 1e-4


def test_masked_init_video_request_matches_jax(t2v_pipes):
    """video= with mask_video and no control videos: v * keep + 0.5 *
    (1 - keep) becomes the single control video (a GeoAdapter taking one
    control's 4 channels plus the 64 mask channels)."""
    jp, tp = t2v_pipes
    cfg = dataclasses.replace(MOE_CFG, geoada_in_dim=8)
    dit = _live(cfg, 3)
    jp2 = dataclasses.replace(jp, dit_params=dit, dit_cfg=cfg)
    tp2 = dataclasses.replace(tp, dit_params=_to_port(dit), dit_cfg=_port(cfg))
    rng = np.random.default_rng(6)
    video = rng.random((1, 3, 5, 8, 8)).astype(np.float32)
    mask = (rng.random((1, 1, 5, 8, 8)) > 0.5).astype(np.float32)
    kw = dict(video=video, mask_video=mask, height=8, width=8, num_frames=5,
              num_inference_steps=2, guidance_scale=2.0, shift=3.0, seed=4,
              output_type="latent")
    ref = jp2("x", dtype=jnp.float32, **kw)
    got = tp2("x", dtype=torch.float32, **kw)
    assert _rel_err(got, ref) <= 1e-4
    plain = tp2("x", dtype=torch.float32, **dict(kw, mask_video=np.ones_like(mask)))
    assert (plain - got).abs().max() > 1e-6
