"""Port parity for the whole slice: the port's VerseCrafterPipeline against
the JAX pipeline (attn_impl='pallas', the fused kernel in interpret mode)
with the same weights, noise and prompts, on the tiny configs of
tests/test_pipeline.py (CPU)."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versecrafter_tpu.core.config import T5Config, VAEConfig, WanDiTConfig
from versecrafter_tpu.models.t5 import init_t5
from versecrafter_tpu.models.vae import init_vae
from versecrafter_tpu.models.wan_dit import init_wan_dit
from versecrafter_tpu.sampling import pipeline as jpipe
from versecrafter_tpu_torch.core import config as tconfig
from versecrafter_tpu_torch.core.convert import params_from_jax
from versecrafter_tpu_torch.sampling import pipeline as tpipe
from versecrafter_tpu_torch.serve import model_server as tserve
from versecrafter_tpu_torch.utils.tokenizer import HashTokenizer
from tests.jax_prng import threefry_default  # noqa: F401

VAE_CFG = VAEConfig(base_dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
                    temporal_downsample=(True,), spatial_compression_ratio=2,
                    temporal_compression_ratio=2, use_latent_stats=False)
T5_CFG = T5Config(vocab=256, dim=32, dim_attn=32, dim_ffn=64, num_heads=4,
                  num_layers=2, num_buckets=8, text_length=16)
DIT_CFG = WanDiTConfig(in_dim=4, dim=64, ffn_dim=128, freq_dim=32,
                       text_dim=32, out_dim=4, num_heads=2, num_layers=4,
                       text_len=16, geoada_layers=(), geoada_in_dim=12)


def _port(cfg, cls):
    return cls(**dataclasses.asdict(cfg))


def _rel_err(got, ref):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def pipes():
    dit = init_wan_dit(jax.random.key(0), DIT_CFG, jnp.float32)
    # un-zero the head and the GeoAdapter projections so every stage matters
    for i, path in enumerate((("head", "head"), ("geoada_before_proj",),
                              ("geoada_blocks", "after_proj"))):
        leaf = dit
        for key in path:
            leaf = leaf[key]
        leaf["kernel"] = jax.random.normal(jax.random.key(90 + i),
                                           leaf["kernel"].shape) * 0.05
    vae = init_vae(jax.random.key(1), VAE_CFG, jnp.float32)
    t5 = init_t5(jax.random.key(2), T5_CFG, jnp.float32)
    # both pipelines tokenize with the port's hash tokenizer: the JAX
    # package's hashes words with the process's salted hash()
    jp = jpipe.VerseCrafterPipeline(
        dit_params=dit, dit_cfg=DIT_CFG, vae_params=vae, vae_cfg=VAE_CFG,
        t5_params=t5, t5_cfg=T5_CFG, scheduler_name="unipc", attn_impl="pallas",
        tokenizer=HashTokenizer(T5_CFG.vocab))
    to_t = lambda tree: params_from_jax(jax.tree.map(np.asarray, tree))
    tp = tpipe.VerseCrafterPipeline(
        dit_params=to_t(dit), dit_cfg=_port(DIT_CFG, tconfig.WanDiTConfig),
        vae_params=to_t(vae), vae_cfg=_port(VAE_CFG, tconfig.VAEConfig),
        t5_params=to_t(t5), t5_cfg=_port(T5_CFG, tconfig.T5Config),
        scheduler_name="unipc", device="cpu")
    return jp, tp


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    controls = [rng.random((1, 3, 5, 8, 8)).astype(np.float32) for _ in range(2)]
    mask = np.zeros((1, 1, 5, 8, 8), np.float32)
    mask[:, :, :, 2:6, 2:6] = 1.0
    noise = rng.standard_normal((1, 4, 3, 4, 4)).astype(np.float32)
    return controls, mask, noise


def _run(pipe, dtype, output_type, guidance=2.0, steps=3, seed=0):
    controls, mask, noise = _inputs(seed)
    return pipe("a car drives left", negative_prompt="static",
                control_videos=controls, mask_video=mask, latents=noise,
                height=8, width=8, num_frames=5, num_inference_steps=steps,
                guidance_scale=guidance, shift=3.0, dtype=dtype,
                output_type=output_type)


@pytest.mark.parametrize("guidance", [2.0, 1.0])
def test_latents_match_jax(pipes, guidance):
    jp, tp = pipes
    ref = _run(jp, jnp.float32, "latent", guidance)
    got = _run(tp, torch.float32, "latent", guidance)
    assert tuple(got.shape) == tuple(ref.shape)
    assert _rel_err(got, ref) <= 1e-4


@pytest.mark.parametrize("seed", [0, 2025])
def test_seeded_request_matches_jax(pipes, seed):
    """No latents=: both pipelines draw their noise from `seed` (threefry),
    so the same seed gives the same video."""
    jp, tp = pipes
    controls, mask, _ = _inputs()
    kw = dict(negative_prompt="static", control_videos=controls, mask_video=mask,
              height=8, width=8, num_frames=5, num_inference_steps=3,
              guidance_scale=2.0, shift=3.0, seed=seed)
    ref = jp("a car drives left", dtype=jnp.float32, output_type="latent", **kw)
    got = tp("a car drives left", dtype=torch.float32, output_type="latent", **kw)
    assert _rel_err(got, ref) <= 1e-4
    ref = jp("a car drives left", dtype=jnp.float32, output_type="numpy", **kw)
    got = tp("a car drives left", dtype=torch.float32, output_type="numpy", **kw)
    assert got.shape == ref.shape == (1, 5, 8, 8, 3)
    assert _rel_err(got, ref) <= 1e-4


def test_frames_match_jax(pipes):
    jp, tp = pipes
    ref = _run(jp, jnp.float32, "numpy")
    got = _run(tp, torch.float32, "numpy")
    assert got.shape == ref.shape == (1, 5, 8, 8, 3)
    assert _rel_err(got, ref) <= 1e-4


def test_stages_match_jax(pipes):
    jp, tp = pipes
    controls, mask, _ = _inputs()
    ref = jp.encode_prompt("a car", "static")
    got = tp.encode_prompt("a car", "static")
    assert _rel_err(got, ref) <= 1e-4
    ref, n_ref = jp.encode_controls(controls, mask, jnp.float32)
    got, n_got = tp.encode_controls(controls, mask, torch.float32)
    assert n_got == n_ref == 0
    assert _rel_err(got, ref) <= 1e-4


def test_hash_tokenizer_repeats_across_processes():
    """A prompt gives the same ids in two fresh interpreters with different
    hash salts (Python's hash() would not): the same request and seed give
    the same video in every process."""
    code = ("from versecrafter_tpu_torch.utils.tokenizer import HashTokenizer; "
            "print(HashTokenizer()(['a red car drives left', 'blurry'], max_length=8)"
            "['input_ids'].tolist())")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = [subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                           text=True, check=True, timeout=120,
                           env={**os.environ, "PYTHONHASHSEED": salt}).stdout
            for salt in ("1", "2")]
    assert outs[0] == outs[1] and outs[0].strip()
    assert outs[0].strip() == str(HashTokenizer()(["a red car drives left", "blurry"],
                                                  max_length=8)["input_ids"].tolist())


def test_mask_pixelshuffle_matches_jax():
    m = np.random.default_rng(5).random((2, 1, 9, 8, 12)) > 0.5
    m = m.astype(np.float32)
    for lt, stride in ((3, (4, 4, 4)), (5, (2, 2, 2))):
        ref = jpipe.encode_mask_pixelshuffle(jnp.asarray(m), lt, stride)
        got = tpipe.encode_mask_pixelshuffle(torch.from_numpy(m), lt, stride)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_uint8_request_through_call_pipe(pipes):
    _, tp = pipes
    controls, mask, _ = _inputs()
    out = tserve._call_pipe(tp, {"prompt": "x", "num_inference_steps": 2,
                                 "guidance_scale": 2.0, "seed": 3},
                            controls, mask, 8, 8, 5, None)
    assert out.dtype == np.uint8 and out.shape == (1, 5, 8, 8, 3)


def test_runtime_features_apply(pipes):
    """TeaCache and cfg-skip: the toggles set the pipeline's fields and a
    request runs with them. clip_fea reaches a DiT without img_emb as the
    JAX package passes it: ignored, the latents those of the request
    without it."""
    jp, tp = pipes
    try:
        tp.enable_teacache(0.1, skip_start=1)
        tp.enable_cfg_skip(0.5)
        tp.teacache_debug = True
        assert (tp.teacache_threshold, tp.teacache_skip_start, tp.cfg_skip_ratio) == \
            (0.1, 1, 0.5)
        _run(tp, torch.float32, "latent", steps=3)
        # one accumulator snapshot a step; the rows shrink to the cond half
        # when the cfg-skip window starts (steps i >= 3 * (1 - 0.5))
        assert [len(a) for a in tp.teacache_accum_history] == [2, 2, 1]
    finally:
        tp.disable_teacache()
        tp.enable_cfg_skip(0.0)
        tp.teacache_debug = False
    assert tp.teacache_threshold == 0.0 and tp.cfg_skip_ratio == 0.0
    clip = np.random.default_rng(1).standard_normal((1, 257, 1280)).astype(np.float32)
    controls, mask, noise = _inputs()
    kw = dict(control_videos=controls, mask_video=mask, latents=noise, height=8, width=8,
              num_frames=5, num_inference_steps=2, output_type="latent")
    got = tp("x", dtype=torch.float32, clip_fea=clip, **kw)
    assert torch.equal(got, tp("x", dtype=torch.float32, **kw))
    assert _rel_err(got, jp("x", dtype=jnp.float32, clip_fea=clip, **kw)) <= 1e-4


def test_entry_points_need_cuda_unless_cpu(monkeypatch, pipes):
    _, tp = pipes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(dit_params=tp.dit_params, dit_cfg=tp.dit_cfg,
              vae_params=tp.vae_params, vae_cfg=tp.vae_cfg,
              t5_params=tp.t5_params, t5_cfg=tp.t5_cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.VerseCrafterPipeline(**kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.default_pipeline_factory(scale="tiny")()
    assert tpipe.VerseCrafterPipeline(**kw, device="cpu").device.type == "cpu"
