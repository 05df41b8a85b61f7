"""Port parity for staged weight residency (sampling/staged.py) on the
CPU: the port's generate_staged against the JAX package's on the same tiny
components (uint8 frames within one level, [0, 1] frames and recorded
latents within 1e-4 * max, both packages in fp32), staged against resident
in the port bit for bit, each stage's weights freed, the quantized fresh
init against the eager quantize and the JAX init_wan_dit_quantized, the
memory model against the JAX function's form and the card's measured
points, and the 720p geometry against the jitted JAX functions."""

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_pipeline import DIT_CFG, T5_CFG, VAE_CFG, _port
from versecrafter_tpu.kernels import rope as jrope
from versecrafter_tpu.models import wan_dit as jwan
from versecrafter_tpu.models.t5 import init_t5
from versecrafter_tpu.models.vae import init_vae
from versecrafter_tpu.sampling import pipeline as jpipe
from versecrafter_tpu.sampling import staged as jstaged
from versecrafter_tpu.utils import quantize as jq
from versecrafter_tpu_torch.core import config as tconfig
from versecrafter_tpu_torch.core.convert import params_from_jax
from versecrafter_tpu_torch.kernels import rope as trope
from versecrafter_tpu_torch.models import wan_dit as twan
from versecrafter_tpu_torch.sampling import pipeline as tpipe
from versecrafter_tpu_torch.sampling import staged as tstaged
from versecrafter_tpu_torch.utils import quantize as tq
from versecrafter_tpu_torch.utils.tokenizer import HashTokenizer
from tests.jax_prng import threefry_default  # noqa: F401

KW = dict(height=8, width=8, num_frames=5, num_inference_steps=3, guidance_scale=2.0,
          shift=3.0, seed=7)


@pytest.fixture(scope="module")
def components():
    """(JAX, port) trees of the tiny DiT (head and GeoAdapter projections
    made random), VAE and umT5."""
    dit = jwan.init_wan_dit(jax.random.key(0), DIT_CFG, jnp.float32)
    for i, path in enumerate((("head", "head"), ("geoada_before_proj",),
                              ("geoada_blocks", "after_proj"))):
        leaf = dit
        for key in path:
            leaf = leaf[key]
        leaf["kernel"] = jax.random.normal(jax.random.key(90 + i), leaf["kernel"].shape) * 0.05
    jtrees = (dit, jax.jit(lambda k: init_vae(k, VAE_CFG, jnp.float32))(jax.random.key(1)),
              jax.jit(lambda k: init_t5(k, T5_CFG, jnp.float32))(jax.random.key(2)))
    return jtrees, tuple(params_from_jax(jax.tree.map(np.asarray, t)) for t in jtrees)


def _inputs():
    rng = np.random.default_rng(0)
    controls = [rng.random((1, 3, 5, 8, 8)).astype(np.float32) for _ in range(2)]
    mask = np.zeros((1, 1, 5, 8, 8), np.float32)
    mask[:, :, :, 2:6, 2:6] = 1.0
    return dict(control_videos=controls, mask_video=mask)


def _jax_shell(cfg_parallel):
    return jpipe.VerseCrafterPipeline(
        dit_params=None, dit_cfg=DIT_CFG, vae_params=None, vae_cfg=VAE_CFG, t5_params=None,
        t5_cfg=T5_CFG, scheduler_name="unipc", cfg_parallel=cfg_parallel,
        tokenizer=HashTokenizer(T5_CFG.vocab))


def _port_pipe(cfg_parallel, trees=(None, None, None), **kw):
    dit, vae, t5 = trees
    return tpipe.VerseCrafterPipeline(
        dit_params=dit, dit_cfg=_port(DIT_CFG, tconfig.WanDiTConfig), vae_params=vae,
        vae_cfg=_port(VAE_CFG, tconfig.VAEConfig), t5_params=t5,
        t5_cfg=_port(T5_CFG, tconfig.T5Config), scheduler_name="unipc",
        cfg_parallel=cfg_parallel, device="cpu", **kw)


def _factories(module, trees):
    """Factories of the given trees; the port's build a fresh copy per
    call, as the real factories do, so a freed stage leaves nothing alive."""
    dit, vae, t5 = trees
    if module is tstaged:
        def fresh(tree):
            return lambda: jax.tree.map(torch.clone, tree)
        return module.StageFactories(fresh(t5), fresh(vae), fresh(dit), 0)
    return module.StageFactories(lambda: t5, lambda: vae, lambda: dit, 0)


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("cfg_parallel,out", [(True, "numpy"), (False, "uint8")],
                         ids=["batched", "sequential"])
def test_generate_staged_matches_jax(components, cfg_parallel, out):
    """The JAX package's generate_staged and the port's on the same
    factories: [0, 1] frames within 1e-4 * max (batched CFG), uint8 frames
    within one level (sequential CFG; the fp32 packages agree to ~1e-6, so
    a value at a rounding boundary may land one level apart), the stage
    profile's keys."""
    (jt, tt), kw = components, _inputs()
    ref = np.asarray(jstaged.generate_staged(
        _jax_shell(cfg_parallel), _factories(jstaged, jt), "a car", "static",
        output_type=out, dtype=jnp.float32, **kw, **KW))
    tp = _port_pipe(cfg_parallel)
    got = tstaged.generate_staged(tp, _factories(tstaged, tt), "a car", "static",
                                  output_type=out, dtype=torch.float32, **kw, **KW)
    assert got.shape == ref.shape == (1, 5, 8, 8, 3) and got.dtype == ref.dtype
    if out == "numpy":
        assert _rel_err(got, ref) <= 1e-4
    else:
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert set(tp.last_stage_profile) == {
        "t5_build", "t5_encode", "vae_build", "encode_controls", "dit_build", "denoise",
        "vae_rebuild", "decode", "total", "denoise_wall"}
    assert tp.t5_params is None and tp.vae_params is None and tp.dit_params is None


def test_record_teacache_matches_jax(components):
    """record_teacache=True: rel_e0, rel_residual and last_record_latents
    (reference slots stripped) against the JAX package's, within 1e-4 *
    max; the latents decode to the ungated generation (the JAX test's
    claim, tests/test_staged.py:159)."""
    (jt, tt), kw = components, _inputs()
    rec = dict(KW, num_inference_steps=4)
    jshell = _jax_shell(False)
    jref = jstaged.generate_staged(jshell, _factories(jstaged, jt), "a car", "static",
                                   record_teacache=True, dtype=jnp.float32, **kw, **rec)
    tp = _port_pipe(False)
    got = tstaged.generate_staged(tp, _factories(tstaged, tt), "a car", "static",
                                  record_teacache=True, dtype=torch.float32, **kw, **rec)
    for g, r in zip(got, jref):
        assert g.shape == np.asarray(r).shape == (3, 1)
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-6)
    assert _rel_err(tp.last_record_latents, jshell.last_record_latents) <= 1e-4
    assert set(tp.last_stage_profile) == {"t5_build", "t5_encode", "vae_build",
                                          "encode_controls", "dit_build", "record", "total"}
    ungated = _port_pipe(False, tt)("a car", "static", output_type="numpy",
                                    dtype=torch.float32, **kw, **rec)
    tp.vae_params = tt[1]
    assert np.array_equal(tp.decode_latents(tp.last_record_latents, "numpy"), ungated)


@pytest.mark.parametrize("cfg_parallel", [True, False], ids=["batched", "sequential"])
def test_staged_equals_resident_and_frees(components, cfg_parallel, monkeypatch):
    """Staged against the resident pipeline on the same trees, bit for bit
    in fp32; after each stage no reference to the freed tree is left (a
    weakref to one of its leaves is dead)."""
    _, tt = components
    kw = _inputs()
    resident = _port_pipe(cfg_parallel, tt)("a car", "static", output_type="numpy",
                                            dtype=torch.float32, **kw, **KW)
    free, freed = tstaged._free, []

    def checked_free(pipe, attr):
        leaf = weakref.ref(jax.tree.leaves(getattr(pipe, attr))[0])
        free(pipe, attr)
        gc.collect()
        freed.append(attr)
        assert leaf() is None, f"{attr} outlived its stage"

    monkeypatch.setattr(tstaged, "_free", checked_free)
    tp = _port_pipe(cfg_parallel)
    staged = tstaged.generate_staged(tp, _factories(tstaged, tt), "a car", "static",
                                     output_type="numpy", dtype=torch.float32, **kw, **KW)
    assert np.array_equal(staged, resident)
    assert freed == ["t5_params", "vae_params", "dit_params", "vae_params"]


def _quant_cfg():
    return tconfig.WanDiTConfig(in_dim=4, dim=128, ffn_dim=256, freq_dim=32, text_dim=32,
                                out_dim=4, num_heads=4, num_layers=3, text_len=16,
                                geoada_layers=(), geoada_in_dim=12)


def _assert_equal_trees(got, want, path=""):
    if isinstance(want, dict):
        assert list(got) == list(want), path  # the same keys in the same order
        for k in want:
            _assert_equal_trees(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_equal_trees(a, b, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path


@pytest.mark.parametrize("bits,int8_compute", [(8, False), (8, True), (4, False), (4, True)])
def test_quantized_init_equals_eager(bits, int8_compute, monkeypatch):
    """init_wan_dit_quantized == quantize_dit(init_wan_dit) bit for bit
    (same generator state, bf16), key order included. Its peak on the CPU
    (torch.profiler memory events) is at most the quantized tree, plus one
    unquantized part (a bf16 block, or the top-level leaves drawn first,
    whichever is larger), plus the quantizer's working set (two fp32
    copies of the largest leaf); the eager path holds the whole bf16 tree."""
    monkeypatch.setattr(tq, "MIN_SIZE", 1 << 10)
    cfg = _quant_cfg()
    whole = twan.init_wan_dit(cfg, torch.Generator().manual_seed(3))
    eager = tq.quantize_dit(dict(whole, blocks=list(whole["blocks"]),
                                 geoada_blocks=list(whole["geoada_blocks"])), bits, int8_compute)
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        built = twan.init_wan_dit_quantized(cfg, torch.Generator().manual_seed(3),
                                            bits=bits, int8_compute=int8_compute)
    _assert_equal_trees(built, eager)
    assert tq.has_quantized(built)
    live = peak = 0
    for e in sorted(prof.profiler.kineto_results.events(), key=lambda e: e.start_ns()):
        if e.name() == "[memory]":
            live += e.nbytes()
            peak = max(peak, live)
    part = max(tq.tree_bytes(whole["blocks"][0]), tq.tree_bytes(
        {k: v for k, v in whole.items() if not isinstance(v, list)}))
    working = 2 * 4 * max(t.numel() for t in jax.tree.leaves(whole))
    assert peak <= tq.tree_bytes(built) + part + working, (peak, tq.tree_bytes(built), part)
    assert peak < tq.tree_bytes(whole)


@pytest.mark.parametrize("bits,int8_compute", [(8, False), (4, True)])
def test_quantized_init_matches_jax(bits, int8_compute, monkeypatch):
    """The JAX init_wan_dit_quantized's leaves through params_from_jax
    against the port's quantize_dit of the JAX init_wan_dit's tree (the
    JAX test's bar, tests/test_staged.py:95: a scale ulp may flip one code,
    other leaves within 1e-5 relative)."""
    monkeypatch.setattr(tq, "MIN_SIZE", 1 << 10)
    monkeypatch.setattr(jq, "MIN_SIZE", 1 << 10)
    cfg = dataclasses.replace(DIT_CFG, dim=128, ffn_dim=256, num_heads=4)
    key = jax.random.key(3)
    jinc = params_from_jax(jax.tree.map(np.asarray, jwan.init_wan_dit_quantized(
        key, cfg, jnp.float32, bits=bits, int8_compute=int8_compute)))
    mine = tq.quantize_dit(params_from_jax(jax.tree.map(
        np.asarray, jwan.init_wan_dit(key, cfg, jnp.float32))), bits, int8_compute)
    flat_j = jax.tree_util.tree_flatten_with_path(jinc)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    codes = 0
    for (path, a), (_, b) in zip(flat_j, flat_t):
        name = jax.tree_util.keystr(path)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if "values" in name:
            codes += 1
            assert (a.int() - b.int()).abs().max() <= 1, name
        elif a.is_floating_point():
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7, msg=name)
        else:
            assert torch.equal(a, b), name
    assert codes >= cfg.num_layers


# -- the memory model ------------------------------------------------------------

JAX_MODEL = tstaged.MemoryModel(
    bytes_per_param={0: 2.14, 8: 1.14, 4: 0.602}, row_bytes=12.0,
    ffn_row_bytes={0: 4.0, 8: 4.0, 4: 4.0},
    geoada_factor=1.3, chunk_rows=jwan.FFN_CHUNK_ROWS, chunk_div=4,
    fits_gb=jstaged.BATCHED_CFG_FITS_EST_GB)


def test_memory_model_has_the_jax_form(monkeypatch):
    """Fed the JAX package's constants, the port's estimate and decision
    equal the JAX functions' on configs with an explicit GeoAdapter layer
    list or none. geoada_layers=() (every 2nd layer) is the recorded
    difference: the JAX estimate counts len(()) = 0 GeoAdapter blocks there,
    the port the resolved ones, so the port on versecrafter_14b() equals the
    JAX estimate on the same layers spelled out."""
    monkeypatch.setattr(tstaged, "CARD_MODEL", JAX_MODEL)
    cfg14 = tconfig.versecrafter_14b()
    spelled = dataclasses.replace(cfg14, geoada_layers=cfg14.resolved_geoada_layers)
    configs = [tconfig.WAN21_14B, tconfig.WAN21_1_3B, spelled,
               dataclasses.replace(tconfig.WAN21_1_3B, geoada_layers=(0, 3, 6), geoada_in_dim=128)]
    for cfg in configs:
        jcfg = _port(cfg, type(DIT_CFG))
        for bits in (0, 8, 4):
            for tokens in (1560, 14040, 32760, 75600):
                for cfg_batch in (1, 2):
                    want = jstaged.estimate_denoise_gb(jcfg, bits, tokens, cfg_batch)
                    got = tstaged.estimate_denoise_gb(cfg, bits, tokens, cfg_batch)
                    assert got == pytest.approx(want, rel=1e-12), (cfg, bits, tokens, cfg_batch)
                assert (tstaged.auto_cfg_parallel(cfg, bits, tokens)
                        == jstaged.auto_cfg_parallel(jcfg, bits, tokens))
    j14 = _port(cfg14, type(DIT_CFG))
    assert tstaged.estimate_denoise_gb(cfg14, 4, 75600, 2) == pytest.approx(
        jstaged.estimate_denoise_gb(_port(spelled, type(DIT_CFG)), 4, 75600, 2))
    assert tstaged.estimate_denoise_gb(cfg14, 4, 75600, 2) > \
        jstaged.estimate_denoise_gb(j14, 4, 75600, 2)


# the card's points (PERF.md §5; scripts/calibrate_torch_staged_memory.py on
# an NVIDIA H100 80GB HBM3, 700.00 W): (bits, tokens, CFG batch, GiB resident
# beside the DiT, the measured peak in GiB); every one ran
CARD_POINTS = [(0, 32760, 2, 0.0, 51.27), (0, 32760, 1, 0.0, 46.21),
               (0, 75600, 2, 0.0, 64.52), (0, 75600, 1, 0.0, 52.84),
               (8, 32760, 2, 0.0, 35.78), (8, 32760, 1, 0.0, 28.54),
               (8, 75600, 2, 0.0, 44.66), (8, 75600, 1, 0.0, 32.98),
               (4, 32760, 2, 0.0, 25.67), (4, 75600, 2, 0.0, 34.48),
               (0, 75600, 1, 11.05, 63.89), (0, 75600, 2, 11.05, 75.58)]


def test_card_model_separates_the_measured_points():
    """Every point measured to run is at or under the card model's bar, and
    the estimate is never below the measured peak; so the staged 720p
    request runs batched CFG in bf16, W8A8 and W4A8."""
    cfg = tconfig.versecrafter_14b()
    for bits, tokens, batch, beside, peak in CARD_POINTS:
        est = tstaged.estimate_denoise_gb(cfg, bits, tokens, batch) + beside
        assert peak <= est <= tstaged.CARD_MODEL.fits_gb, (bits, tokens, batch, est)
    for bits in (0, 8, 4):
        assert tstaged.auto_cfg_parallel(cfg, bits, 75600)


# -- the 720p geometry -------------------------------------------------------------

GRID_720P = (21, 45, 80)  # latent frames, patch rows, patch columns at 720x1280x81


def test_rope_grid_at_720p():
    """grid_cos_sin at the 21 x 45 x 80 grid (75,600 rows) against the
    jitted JAX function."""
    ang_t = trope.rope_3d_angles(128)
    ang_j = jrope.rope_3d_angles(128)
    cos_j, sin_j = jax.jit(lambda a: jrope.grid_cos_sin(a, *GRID_720P))(ang_j)
    cos_t, sin_t = trope.grid_cos_sin(ang_t, *GRID_720P)
    assert tuple(cos_t.shape) == (75600, 64)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), rtol=0, atol=1e-6)


def test_patchify_at_720p():
    """patchify of a [1, 16, 21, 90, 160] latent (the 720p request's) and
    unpatchify of the head's [1, 75,600, 64] tokens against the jitted JAX
    functions, exactly."""
    x = np.random.default_rng(0).standard_normal((1, 16, 21, 90, 160)).astype(np.float32)
    pj = jax.jit(lambda a: jwan.patchify(a, (1, 2, 2)))(x)
    pt = twan.patchify(torch.from_numpy(x), (1, 2, 2))
    assert tuple(pt.shape) == (1, 75600, 64)
    assert np.array_equal(pt.numpy(), np.asarray(pj))
    back_j = jax.jit(lambda a: jwan.unpatchify(a, GRID_720P, (1, 2, 2), 16))(pj)
    back_t = twan.unpatchify(pt, GRID_720P, (1, 2, 2), 16)
    assert tuple(back_t.shape) == x.shape
    assert np.array_equal(back_t.numpy(), np.asarray(back_j))


@pytest.mark.parametrize("cfg_batch", [2, 1])
def test_ffn_chunks_at_720p(cfg_batch, monkeypatch):
    """_ffn_chunked's split at 151,200 (CFG-2) and 75,600 rows equals the
    memory model's FFN row count, and the chunks cover every row once."""
    rows = 75600 * cfg_batch
    seen = []
    monkeypatch.setattr(twan, "_ffn", lambda p, x: (seen.append(x.shape[0]), x * 2)[1])
    x = torch.arange(rows, dtype=torch.float32).reshape(cfg_batch, 75600, 1)
    out = twan._ffn_chunked({}, x)
    assert torch.equal(out, x * 2)
    assert rows > twan.FFN_CHUNK_ROWS and sum(seen) == rows
    assert max(seen) == tstaged.denoise_rows(75600, cfg_batch)[1]
