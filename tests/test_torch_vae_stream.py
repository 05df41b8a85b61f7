"""Port parity for the streaming VAE: the port's vae_encode_chunked /
vae_decode_chunked / vae_decode_stream against the jitted JAX ones and the
port's own full-sequence path, on the tiny config of
tests/test_vae_stream.py and on the Wan topology at a small spatial size;
and the pipeline's gate (VAE_STREAM_THRESHOLD set low in both packages):
the streamed control latents, frames and overlapped download equal the JAX
pipeline's. fp32, bar 1e-4 * max|ref| (CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versecrafter_tpu.core.config import T5Config, VAEConfig, WanDiTConfig
from versecrafter_tpu.models import vae as jvae
from versecrafter_tpu.models import vae_stream as jstream
from versecrafter_tpu.models.t5 import init_t5
from versecrafter_tpu.models.wan_dit import init_wan_dit
from versecrafter_tpu.sampling import pipeline as jpipe
from versecrafter_tpu_torch.core import config as tconfig
from versecrafter_tpu_torch.core.convert import params_from_jax
from versecrafter_tpu_torch.models import vae as tvae
from versecrafter_tpu_torch.models import vae_stream as tstream
from versecrafter_tpu_torch.sampling import pipeline as tpipe
from versecrafter_tpu_torch.utils.tokenizer import HashTokenizer

# tests/test_vae_stream.py's tiny Wan-topology config: two temporal
# downsamples (4x), three stages
TINY = VAEConfig(base_dim=8, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1,
                 temporal_downsample=(False, True, True),
                 spatial_compression_ratio=8, temporal_compression_ratio=4,
                 use_latent_stats=False)
BAR = 1e-4


def _port(cfg, cls):
    return cls(**dataclasses.asdict(cfg))


def _to_t(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def _rel_err(got, ref):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def tiny():
    params = jvae.init_vae(jax.random.key(0), TINY, dtype=jnp.float32)
    return params, _to_t(params)


@pytest.fixture(scope="module")
def wan():
    cfg = VAEConfig(use_latent_stats=True)
    params = jvae.init_vae(jax.random.key(1), cfg, jnp.float32)
    return cfg, params, _to_t(params)


@pytest.mark.parametrize("frame_chunk", [4, 8])
def test_encode_chunked_matches_jax_and_full(tiny, frame_chunk):
    jp, tp = tiny
    x = np.random.default_rng(frame_chunk).standard_normal((1, 3, 17, 16, 16)).astype(np.float32)
    ref = jstream.vae_encode_chunked(jp, TINY, jnp.asarray(x), frame_chunk=frame_chunk)
    cfg = _port(TINY, tconfig.VAEConfig)
    got = tstream.vae_encode_chunked(tp, cfg, torch.from_numpy(x), frame_chunk=frame_chunk)
    assert _rel_err(got, ref) <= BAR
    assert _rel_err(got, tvae.vae_encode(tp, cfg, torch.from_numpy(x))) <= BAR


def test_encode_chunk_must_be_a_multiple_of_the_ratio(tiny):
    _, tp = tiny
    with pytest.raises(ValueError, match="multiple"):
        tstream.vae_encode_chunked(tp, _port(TINY, tconfig.VAEConfig),
                                   torch.zeros(1, 3, 9, 16, 16), frame_chunk=6)


@pytest.mark.parametrize("latent_chunk", [1, 2])
def test_decode_chunked_matches_jax_and_full(tiny, latent_chunk):
    jp, tp = tiny
    z = np.random.default_rng(2).standard_normal((1, 4, 5, 2, 2)).astype(np.float32)
    ref = jstream.vae_decode_chunked(jp, TINY, jnp.asarray(z), latent_chunk=latent_chunk)
    cfg = _port(TINY, tconfig.VAEConfig)
    got = tstream.vae_decode_chunked(tp, cfg, torch.from_numpy(z), latent_chunk=latent_chunk)
    assert _rel_err(got, ref) <= BAR
    assert _rel_err(got, tvae.vae_decode(tp, cfg, torch.from_numpy(z))) <= BAR


def test_decode_stream_yields_chunks_in_order(tiny):
    jp, tp = tiny
    z = np.random.default_rng(3).standard_normal((1, 4, 4, 2, 2)).astype(np.float32)
    refs = list(jstream.vae_decode_stream(jp, TINY, jnp.asarray(z)))
    gots = list(tstream.vae_decode_stream(tp, _port(TINY, tconfig.VAEConfig),
                                          torch.from_numpy(z)))
    assert [g.shape[2] for g in gots] == [r.shape[2] for r in refs] == [1, 4, 4, 4]
    for got, ref in zip(gots, refs):
        assert _rel_err(got, ref) <= BAR


def test_wan_topology_small(wan):
    """VAEConfig() itself (96 base channels, latent statistics) at 9 x 32 x 32."""
    cfg, jp, tp = wan
    tcfg = _port(cfg, tconfig.VAEConfig)
    x = np.random.default_rng(3).standard_normal((1, 3, 9, 32, 32)).astype(np.float32)
    ref = jstream.vae_encode_chunked(jp, cfg, jnp.asarray(x))
    got = tstream.vae_encode_chunked(tp, tcfg, torch.from_numpy(x))
    assert _rel_err(got, ref) <= BAR
    assert _rel_err(got, tvae.vae_encode(tp, tcfg, torch.from_numpy(x))) <= BAR
    y_ref = jstream.vae_decode_chunked(jp, cfg, ref)
    y_got = tstream.vae_decode_chunked(tp, tcfg, got)
    assert _rel_err(y_got, y_ref) <= BAR
    assert _rel_err(y_got, tvae.vae_decode(tp, tcfg, got)) <= BAR


# -- the pipeline's gate ------------------------------------------------------

# a tiny VAE whose encoder and decoder both compress 4x in time and 8x in
# space, as VAEConfig() does (TINY's decoder upsamples more than its encoder
# downsamples)
PIPE_VAE = VAEConfig(base_dim=8, z_dim=4, dim_mult=(1, 2, 2, 2), num_res_blocks=1,
                     temporal_downsample=(False, True, True), use_latent_stats=False)
DIT_CFG = WanDiTConfig(in_dim=PIPE_VAE.z_dim, dim=32, ffn_dim=64, freq_dim=16,
                       text_dim=16, out_dim=PIPE_VAE.z_dim, num_heads=2, num_layers=2,
                       text_len=8, geoada_layers=(), geoada_in_dim=2 * PIPE_VAE.z_dim + 64)
T5_CFG = T5Config(vocab=64, dim=16, dim_attn=16, dim_ffn=32, num_heads=2,
                  num_layers=1, num_buckets=4, text_length=8)


@pytest.fixture(scope="module")
def pipes():
    jvae_params = jvae.init_vae(jax.random.key(3), PIPE_VAE, dtype=jnp.float32)
    tvae_params = _to_t(jvae_params)
    dit = init_wan_dit(jax.random.key(0), DIT_CFG, jnp.float32)
    dit["head"]["head"]["kernel"] = jax.random.normal(
        jax.random.key(9), dit["head"]["head"]["kernel"].shape) * 0.05
    t5 = init_t5(jax.random.key(1), T5_CFG, jnp.float32)
    jp = jpipe.VerseCrafterPipeline(
        dit_params=dit, dit_cfg=DIT_CFG, vae_params=jvae_params, vae_cfg=PIPE_VAE,
        t5_params=t5, t5_cfg=T5_CFG, attn_impl="pallas",
        tokenizer=HashTokenizer(T5_CFG.vocab))
    tp = tpipe.VerseCrafterPipeline(
        dit_params=_to_t(dit), dit_cfg=_port(DIT_CFG, tconfig.WanDiTConfig),
        vae_params=tvae_params, vae_cfg=_port(PIPE_VAE, tconfig.VAEConfig),
        t5_params=_to_t(t5), t5_cfg=_port(T5_CFG, tconfig.T5Config), device="cpu")
    return jp, tp


@pytest.fixture
def stream_everything(monkeypatch):
    """Both pipelines stream every video of more than one frame, and the
    port's streaming calls are counted."""
    monkeypatch.setattr(jpipe.VerseCrafterPipeline, "VAE_STREAM_THRESHOLD", 1)
    monkeypatch.setattr(tpipe.VerseCrafterPipeline, "VAE_STREAM_THRESHOLD", 1)
    calls = {"encode": 0, "decode": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(tpipe, "vae_encode_chunked",
                        counted("encode", tpipe.vae_encode_chunked))
    monkeypatch.setattr(tpipe, "vae_decode_stream",
                        counted("decode", tpipe.vae_decode_stream))
    return calls


def _controls(seed=0, n=9, h=32, w=32):
    rng = np.random.default_rng(seed)
    controls = [rng.random((1, 3, n, h, w)).astype(np.float32) for _ in range(2)]
    mask = np.zeros((1, 1, n, h, w), np.float32)
    mask[:, :, :, 8:24, 8:24] = 1.0
    return controls, mask


def test_streamed_controls_match_jax(pipes, stream_everything):
    jp, tp = pipes
    controls, mask = _controls()
    ref = jp.encode_controls(controls, mask, jnp.float32)[0]
    got = tp.encode_controls(controls, mask, torch.float32)[0]
    assert stream_everything["encode"] == 2
    assert _rel_err(got, ref) <= BAR


@pytest.mark.parametrize("output_type", ["numpy", "uint8"])
def test_streamed_request_matches_jax(pipes, stream_everything, output_type):
    """A whole request with the streaming encode and the overlapped
    streaming decode in both packages; the wall profile names the download."""
    jp, tp = pipes
    controls, mask = _controls(1)
    noise = np.random.default_rng(4).standard_normal((1, 4, 3, 4, 4)).astype(np.float32)
    kw = dict(negative_prompt="static", control_videos=controls, mask_video=mask,
              latents=noise, height=32, width=32, num_frames=9, num_inference_steps=2,
              guidance_scale=2.0, shift=3.0, output_type=output_type)
    ref = jp("a car", dtype=jnp.float32, **kw)
    got = tp("a car", dtype=torch.float32, **kw)
    assert stream_everything == {"encode": 2, "decode": 1}
    assert got.shape == ref.shape == (1, 9, 32, 32, 3) and got.dtype == ref.dtype
    if output_type == "uint8":
        # one level where a pixel sits on a rounding edge of the truncation
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    else:
        assert _rel_err(got, ref) <= BAR
    assert set(tp.last_wall_profile) == {"text_encode", "encode_controls", "denoise",
                                         "vae_decode", "download"}


@pytest.mark.parametrize("output_type", ["numpy", "uint8"])
def test_overlapped_download_matches_jax_and_full(pipes, output_type):
    jp, tp = pipes
    lat = np.random.default_rng(5).standard_normal((1, 4, 3, 4, 4)).astype(np.float32)
    ref = jp._decode_stream_overlapped(jnp.asarray(lat), output_type)
    got = tp._decode_stream_overlapped(torch.from_numpy(lat), output_type)
    full = tp.decode_latents(torch.from_numpy(lat), output_type)  # below the threshold
    assert got.shape == ref.shape == full.shape == (1, 9, 32, 32, 3)
    if output_type == "uint8":
        assert got.dtype == np.uint8
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
        assert np.abs(got.astype(int) - full.astype(int)).max() <= 1
    else:
        assert _rel_err(got, ref) <= BAR and _rel_err(got, full) <= BAR


def test_overlapped_download_raises_the_workers_error(pipes, monkeypatch):
    """An error on the download thread reaches the caller."""
    _, tp = pipes

    class Boom(Exception):
        pass

    class Frames:  # a chunk whose move to the host fails
        def numpy(self):
            raise Boom("download failed")

    monkeypatch.setattr(tpipe, "_finalize_pixels", lambda y, output_type: Frames())
    with pytest.raises(Boom, match="download failed"):
        tp._decode_stream_overlapped(torch.zeros(1, 4, 2, 2, 2), "numpy")
