"""Seed -> noise parity: the port's threefry PRNG (utils/prng.py) against
jax.random on the CPU, and the batched-CFG combine against the jitted JAX
expression.

Comparisons: key and split words exact; uniform in fp32 and bf16 exact;
normal in bf16 exact; normal in fp32 within 1e-5 relative (torch's erfinv
and XLA's differ by a few ulp; 41 % of the draws are exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versecrafter_tpu_torch.sampling import pipeline as tpipe
from versecrafter_tpu_torch.utils import prng
from tests.jax_prng import threefry_default  # noqa: F401

LATENT_SHAPE = (1, 16, 21, 60, 104)  # 480x832x81 latents
SHAPES = [(1,), (7,), (3, 5, 7), (2, 4, 3, 5, 9), LATENT_SHAPE]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("seed", [0, 1, 3, 2025, 2**31 - 1, -5])
def test_key_and_split_match_jax(seed):
    k, t = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(t.numpy(), _words(k))
    for num in (2, 3):
        np.testing.assert_array_equal(prng.split(t, num).numpy(),
                                      _words(jax.random.split(k, num)))
    # a chain of splits, as a train loop takes it
    k2, t2 = jax.random.split(k)[1], prng.split(t)[1]
    np.testing.assert_array_equal(prng.split(t2)[0].numpy(),
                                  _words(jax.random.split(k2)[0]))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["fp32", "bf16"])
def test_uniform_matches_jax_exactly(shape, dtypes):
    jdt, tdt = dtypes
    ref = jax.random.uniform(jax.random.key(11), shape, jdt)
    got = prng.uniform(prng.key(11), shape, tdt)
    assert got.dtype == tdt and tuple(got.shape) == shape
    np.testing.assert_array_equal(_np(got), _np(ref))


@pytest.mark.parametrize("shape", SHAPES)
def test_normal_bf16_matches_jax_exactly(shape):
    ref = jax.random.normal(jax.random.key(2025), shape, jnp.bfloat16)
    got = prng.normal(prng.key(2025), shape, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_np(got), _np(ref))


@pytest.mark.parametrize("shape", SHAPES)
def test_normal_fp32_matches_jax(shape):
    ref = _np(jax.random.normal(jax.random.key(7), shape, jnp.float32))
    got = _np(prng.normal(prng.key(7), shape, torch.float32))
    assert got.shape == shape
    assert (np.abs(got - ref) <= 1e-5 * np.abs(ref)).all()


def test_unported_dtype_raises():
    with pytest.raises(ValueError):
        prng.normal(prng.key(0), (4,), torch.float16)


def test_cfg_combine_matches_jitted_jax_exactly():
    """The combine of bf16 predictions (|max| ~4.5) with g = 5: the jitted
    JAX step keeps cond - uncond in fp32, so a bf16-rounded difference
    misses it by up to ~1e-3 relative, far inside any tolerance test."""
    rng = np.random.default_rng(0)
    pred = jnp.asarray(rng.standard_normal((2, 16, 5, 6, 7)) * 1.15, jnp.bfloat16)
    assert 4.0 < float(jnp.abs(pred).max()) < 5.5

    @jax.jit
    def combine(pred, guidance):
        uncond, cond = jnp.split(pred, 2, axis=0)
        return uncond + guidance * (cond - uncond)

    ref = np.asarray(combine(pred, jnp.asarray(5.0, jnp.float32)))
    t = torch.from_numpy(_np(pred)).to(torch.bfloat16)
    got = tpipe.cfg_combine(*t.chunk(2, dim=0), 5.0)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
