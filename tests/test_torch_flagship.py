"""The reference's flagship scale in the port, on the CPU: the '14b'
factory's configs against the JAX package's fresh_init_factories("14b",
bits=0) (no weights built), the DiT at 40 heads (the 14B head count) and
narrow widths against the jitted JAX forward, and enable_riflex's tables
and one denoise step against the JAX pipeline's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import _inputs, _rel_err, pipes  # noqa: F401 (fixture)
from versecrafter_tpu.core.config import WanDiTConfig
from versecrafter_tpu.kernels.rope import grid_cos_sin, rope_3d_angles
from versecrafter_tpu.models.wan_dit import init_wan_dit, wan_dit_forward
from versecrafter_tpu.sampling.staged import fresh_init_factories
from versecrafter_tpu_torch.core import config as tconfig
from versecrafter_tpu_torch.core.convert import params_from_jax
from versecrafter_tpu_torch.models import wan_dit as twan
from versecrafter_tpu_torch.serve import model_server as tserve


def test_14b_factory_configs_match_jax():
    """Wan2.1-T2V-14B + GeoAdapter (40 layers, dim 5120, 40 heads, ffn
    13,824, the GeoAdapter every 2nd layer with 128 control channels), the
    full umT5-xxl and the Wan VAE, field for field."""
    _, jdit, jvae, jt5 = fresh_init_factories(scale="14b", bits=0)
    dit, vae, t5 = tserve.pipeline_configs("14b")
    for got, ref in ((dit, jdit), (vae, jvae), (t5, jt5)):
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert (dit.num_layers, dit.dim, dit.num_heads, dit.ffn_dim, dit.head_dim) == \
        (40, 5120, 40, 13824, 128)
    assert dit.resolved_geoada_layers == tuple(range(0, 40, 2))
    assert dit.resolved_geoada_in_dim == 128 and dit.text_dim == t5.dim == 4096
    tserve.default_pipeline_factory(scale="14b")  # builds nothing until called
    with pytest.raises(ValueError, match="unknown scale"):
        tserve.default_pipeline_factory(scale="7b")


# 40 heads of 16 (the 14B head count at narrow width), 2 layers + GeoAdapter
CFG40 = WanDiTConfig(in_dim=4, dim=640, ffn_dim=256, freq_dim=32, text_dim=32, out_dim=4,
                     num_heads=40, num_layers=2, text_len=16, geoada_layers=(),
                     geoada_in_dim=12)


def test_dit_at_40_heads_matches_jax():
    params = init_wan_dit(jax.random.key(40), CFG40, jnp.float32)
    for i, leaf in enumerate((params["head"]["head"], params["geoada_before_proj"],
                              params["geoada_blocks"]["after_proj"])):
        leaf["kernel"] = jax.random.normal(jax.random.key(50 + i), leaf["kernel"].shape) * 0.05
    rng = np.random.default_rng(40)
    x = rng.standard_normal((2, 4, 3, 4, 4)).astype(np.float32)
    g = rng.standard_normal((2, 12, 3, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, 32)).astype(np.float32)
    t = np.asarray([990.0, 310.5], np.float32)
    cos, sin = (np.asarray(a) for a in grid_cos_sin(
        tuple(jnp.asarray(a) for a in rope_3d_angles(CFG40.head_dim, max_pos=16)), 3, 2, 2))
    ref = jax.jit(lambda p, *a: wan_dit_forward(p, CFG40, *a[:5], geoada_context=a[5],
                                                attn_impl="pallas"))(
        params, x, t, ctx, cos, sin, g)
    got = twan.wan_dit_forward(
        params_from_jax(jax.tree.map(np.asarray, params)),
        tconfig.WanDiTConfig(**dataclasses.asdict(CFG40)),
        *(torch.from_numpy(a) for a in (x, t, ctx, cos, sin)), geoada_context=torch.from_numpy(g))
    assert got.shape == ref.shape == (2, 4, 3, 4, 4)
    assert _rel_err(got, ref) <= 1e-4


def test_enable_riflex_matches_jax(pipes):
    """The RIFLEx temporal table and a one-step request with it."""
    jp, tp = pipes
    saved = jp._angles, tp._angles
    try:
        jp.enable_riflex(k=4, L_test=3, L_test_scale=1.5)
        tp.enable_riflex(k=4, L_test=3, L_test_scale=1.5)
        for got, ref in zip(tp._angles, jp._angles):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
        assert not np.array_equal(np.asarray(tp._angles[0]), np.asarray(saved[1][0]))
        controls, mask, noise = _inputs()
        kw = dict(negative_prompt="static", control_videos=controls, mask_video=mask,
                  latents=noise, height=8, width=8, num_frames=5, num_inference_steps=1,
                  guidance_scale=2.0, shift=3.0, output_type="latent")
        ref = jp("a car drives left", dtype=jnp.float32, **kw)
        got = tp("a car drives left", dtype=torch.float32, **kw)
        tp._angles = saved[1]
        plain = tp("a car drives left", dtype=torch.float32, **kw)
    finally:
        jp._angles, tp._angles = saved
    assert _rel_err(got, ref) <= 1e-4
    assert _rel_err(plain, ref) > 1e-3  # the tables moved the result
