"""Port parity: the Wan DiT + GeoAdapter forward, with weights converted by
params_from_jax, against the jitted JAX wan_dit_forward (CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused_attention_setup import tiny_wan_setup
from versecrafter_tpu.core.config import WanDiTConfig
from versecrafter_tpu.kernels.rope import grid_cos_sin, rope_3d_angles
from versecrafter_tpu.models.wan_dit import init_wan_dit, wan_dit_forward
from versecrafter_tpu_torch.core import config as tconfig
from versecrafter_tpu_torch.core.convert import params_from_jax
from versecrafter_tpu_torch.models import wan_dit as twan

# the tiny GeoAdapter config of tests/test_pipeline.py
GEO_CFG = WanDiTConfig(in_dim=4, dim=64, ffn_dim=128, freq_dim=32, text_dim=32,
                       out_dim=4, num_heads=2, num_layers=4, text_len=16,
                       geoada_layers=(), geoada_in_dim=12)


def _port_cfg(cfg):
    return tconfig.WanDiTConfig(**dataclasses.asdict(cfg))


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got.float().numpy() - ref).max() / np.abs(ref).max())


def _geo_setup(seed=0):
    params = init_wan_dit(jax.random.key(seed), GEO_CFG, jnp.float32)
    params["head"]["head"]["kernel"] = jax.random.normal(
        jax.random.key(seed + 99), params["head"]["head"]["kernel"].shape) * 0.05
    # after_proj / before_proj are zero-init too: randomize so hints matter
    for name in ("geoada_before_proj",):
        params[name]["kernel"] = jax.random.normal(
            jax.random.key(seed + 7), params[name]["kernel"].shape) * 0.05
    params["geoada_blocks"]["after_proj"]["kernel"] = jax.random.normal(
        jax.random.key(seed + 8),
        params["geoada_blocks"]["after_proj"]["kernel"].shape) * 0.05
    rng = np.random.default_rng(seed + 2)
    x = rng.standard_normal((2, 4, 3, 4, 4)).astype(np.float32)
    g = rng.standard_normal((2, 12, 3, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, 32)).astype(np.float32)
    t = np.asarray([700.0, 120.5], np.float32)
    ang = tuple(jnp.asarray(a) for a in rope_3d_angles(32, max_pos=16))
    cos, sin = grid_cos_sin(ang, 3, 2, 2)
    return params, (x, t, ctx, np.array(cos), np.array(sin), g)


@pytest.mark.parametrize("impl,tol", [("pallas", 1e-4), ("xla", 1e-3)])
def test_geoada_forward_matches_jax(impl, tol):
    params, (x, t, ctx, cos, sin, g) = _geo_setup()
    ref = jax.jit(lambda p, x, t, c, cs, sn, g: wan_dit_forward(
        p, GEO_CFG, x, t, c, cs, sn, geoada_context=g, geoada_scale=0.7,
        attn_impl=impl))(params, x, t, ctx, cos, sin, g)
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    got = twan.wan_dit_forward(
        tp, _port_cfg(GEO_CFG), *(torch.from_numpy(a) for a in (x, t, ctx, cos, sin)),
        geoada_context=torch.from_numpy(g), geoada_scale=0.7)
    assert got.shape == ref.shape
    assert _rel_err(got, ref) <= tol


def test_attn_impl_xla_matches_jax_xla():
    """attn_impl="xla" selects the reference attention math at every entry
    point, as the JAX package's does: within 1e-4 * max of the JAX xla
    forward (the default path above sits 1e-3 from it); "pallas" on CPU
    tensors raises ValueError naming CUDA."""
    params, (x, t, ctx, cos, sin, g) = _geo_setup()
    ref = jax.jit(lambda p, x, t, c, cs, sn, g: wan_dit_forward(
        p, GEO_CFG, x, t, c, cs, sn, geoada_context=g, geoada_scale=0.7,
        attn_impl="xla"))(params, x, t, ctx, cos, sin, g)
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    args = (tp, _port_cfg(GEO_CFG), *(torch.from_numpy(a) for a in (x, t, ctx, cos, sin)))
    got = twan.wan_dit_forward(*args, geoada_context=torch.from_numpy(g), geoada_scale=0.7,
                               attn_impl="xla")
    assert _rel_err(got, ref) <= 1e-4
    with pytest.raises(ValueError, match="CUDA"):
        twan.wan_dit_forward(*args, geoada_context=torch.from_numpy(g), attn_impl="pallas")


def test_plain_forward_matches_jax():
    cfg, params, (x, t, ctx, cos, sin) = tiny_wan_setup()
    ref = jax.jit(lambda p, *a: wan_dit_forward(p, cfg, *a, attn_impl="pallas"))(
        params, x, t, ctx, cos, sin)
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    got = twan.wan_dit_forward(tp, _port_cfg(cfg), *(
        torch.from_numpy(np.asarray(a)) for a in (x, t, ctx, cos, sin)))
    assert _rel_err(got, ref) <= 1e-4


def test_bf16_params_keep_dtype():
    params = init_wan_dit(jax.random.key(0), GEO_CFG, jnp.bfloat16)
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    assert len(tp["blocks"]) == 4 and len(tp["geoada_blocks"]) == 2
    assert tp["blocks"][0]["ffn_in"]["kernel"].dtype == torch.bfloat16
    assert tp["blocks"][0]["modulation"].dtype == torch.float32
    np.testing.assert_array_equal(
        tp["blocks"][3]["ffn_in"]["kernel"].float().numpy(),
        np.asarray(params["blocks"]["ffn_in"]["kernel"][3], np.float32))


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_init_matches_jax_tree(dtype):
    """The port's init builds the same tree, shapes and dtypes."""
    ref = params_from_jax(jax.tree.map(np.asarray, init_wan_dit(
        jax.random.key(0), GEO_CFG, dtype)))
    got = twan.init_wan_dit(_port_cfg(GEO_CFG), torch.Generator().manual_seed(0),
                            getattr(torch, jnp.dtype(dtype).name))
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_r] == [p for p, _ in flat_g]
    for (path, a), (_, b) in zip(flat_r, flat_g):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), path
    assert not got["head"]["head"]["kernel"].any()


def test_patchify_unpatchify_sinusoid():
    from versecrafter_tpu.models import wan_dit as jwan
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 6, 8)).astype(np.float32)
    p = twan.patchify(torch.from_numpy(x), (1, 2, 2))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jwan.patchify(x, (1, 2, 2))))
    back = twan.unpatchify(p, (4, 3, 4), (1, 2, 2), 3)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jwan.unpatchify(np.asarray(p), (4, 3, 4), (1, 2, 2), 3)))
    pos = np.asarray([0.0, 3.5, 999.0], np.float32)
    ref = jax.jit(jwan.sinusoidal_embedding_1d, static_argnums=0)(256, pos)
    # one fp32 ulp of a ~1000 rad angle is 6e-5: the libraries' pow ulps show
    assert _rel_err(twan.sinusoidal_embedding_1d(256, torch.from_numpy(pos)), ref) <= 1e-4


def test_not_ported_options_raise():
    """Non-uniform geoada_layers raise in both packages, with the same
    message (the i2v and SimpleAdapter branches it used to cover are
    ported: tests/test_torch_extras.py)."""
    cfg = dataclasses.replace(GEO_CFG, geoada_layers=(0, 1))
    params, (x, t, ctx, cos, sin, g) = _geo_setup()
    with pytest.raises(NotImplementedError, match="non-uniform geoada_layers") as ej:
        wan_dit_forward(params, cfg, x, t, ctx, cos, sin, geoada_context=g)
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    with pytest.raises(NotImplementedError, match="non-uniform geoada_layers") as et:
        twan.wan_dit_forward(tp, _port_cfg(cfg), *(torch.from_numpy(a) for a in
                                                   (x, t, ctx, cos, sin)),
                             geoada_context=torch.from_numpy(g))
    assert str(et.value) == str(ej.value)
