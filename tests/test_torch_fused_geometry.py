"""The fused attention's plain version (what the CPU runs, and the yardstick
the card tests hold the CUDA kernel to) against the JAX fused kernel run in
Pallas interpret mode, at the geometries the port's kernel finds hardest:
lengths that straddle its 128-row q tiles and 128-key tiles in both
directions, keys shorter than a tile, per-batch key lengths and windows.

Rows that see no key at all are left out of the comparison: the port writes
0 there (asserted), the Pallas kernel an average over masked keys (ROADMAP
§3 lists the difference)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versecrafter_tpu.kernels.rope import grid_cos_sin, rope_3d_angles
from versecrafter_tpu_torch.kernels import flash_attention as tfa

jfa = importlib.import_module("versecrafter_tpu.kernels.flash_attention")

HD = 128
BF16_BAR = 2 * 2.0 ** -8

CASES = [  # (B, N, Sq, Skv, window, k_lens)
    (1, 2, 193, 321, (-1, -1), None),
    (2, 2, 129, 64, (-1, -1), (64, 1)),
    (1, 2, 200, 40, (-1, -1), None),
    (2, 1, 700, 77, (-1, -1), (77, 5)),
    (1, 2, 384, 384, (64, 32), None),
    (2, 1, 333, 333, (100, 27), (333, 150)),
    (1, 2, 300, 300, (-1, 0), None),
    (1, 1, 32760, 192, (-1, -1), None),  # 32,760 = 255 * 128 + 120
]


def _inputs(B, N, Sq, Skv, dtype, seed=0):
    """Raw projections, row statistics (sm_scale*log2(e) in rq), per-head
    norm scales and interleaved bf16 rope tables, as numpy-made JAX arrays."""
    rng = np.random.default_rng(seed)
    D = N * HD
    q = jnp.asarray(rng.standard_normal((B, Sq, D)), dtype)
    k = jnp.asarray(rng.standard_normal((B, Skv, D)), dtype)
    v = jnp.asarray(rng.standard_normal((B, Skv, D)), dtype)
    gq = jnp.asarray(rng.standard_normal(D) * 0.2 + 2.0, jnp.float32)
    gk = jnp.asarray(rng.standard_normal(D) * 0.1 + 1.0, jnp.float32)
    rows = max(Sq, Skv)
    ang = tuple(jnp.asarray(a) for a in rope_3d_angles(HD))
    cos, sin = grid_cos_sin(ang, -(-rows // 1560), 30, 52)
    ci, si = jfa.prepare_fused_rope_tables(cos[:rows], sin[:rows])

    def rstat(x):
        return jax.lax.rsqrt(jnp.mean(jnp.square(x.astype(jnp.float32)), -1, keepdims=True)
                             + 1e-6)

    return q, k, v, rstat(q) * (HD ** -0.5 * jfa.LOG2E), rstat(k), gq, gk, ci, si


def _t(a):
    a = jnp.asarray(a)
    out = torch.from_numpy(np.array(a.astype(jnp.float32)))
    return out.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else out


def _seen_rows(B, Sq, Skv, window, k_lens):
    """[B, Sq] bool: the query rows that see at least one key."""
    kl = torch.tensor(k_lens if k_lens is not None else (Skv,) * B, dtype=torch.int32)
    return tfa.visible_keys(0, Sq, Skv, kl, window).expand(B, 1, Sq, Skv)[:, 0].any(-1)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-4), (jnp.bfloat16, BF16_BAR)])
def test_plain_matches_jax_kernel_at_tile_edges(case, rope, dtype, tol):
    B, N, Sq, Skv, window, k_lens = case
    q, k, v, rq, rk, gq, gk, ci, si = _inputs(B, N, Sq, Skv, dtype)
    tabs = (ci, si) if rope else (None, None)
    kl = jnp.asarray(k_lens if k_lens is not None else (Skv,) * B, jnp.int32)
    ref = jfa._flash_attention_fused_pallas(
        q, k, v, kl, rq, rk, *tabs, gq.reshape(N, 1, HD), gk.reshape(N, 1, HD),
        head_dim=HD, block_q=128, block_kv=128, interpret=True, masked=True, window=window)
    got = tfa.fused_attention_plain(
        _t(q), _t(k), _t(v), _t(rq)[..., 0], _t(rk)[..., 0], _t(gq), _t(gk),
        *(_t(x) for x in tabs if x is not None), num_heads=N, window_size=window,
        k_lens=None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32))
    assert got.dtype == (torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    seen = _seen_rows(B, Sq, Skv, window, k_lens)
    if (~seen).any():  # rows that see no key write 0
        assert got[~seen].abs().max().item() == 0.0
    got, ref = got.float().numpy()[seen.numpy()], np.asarray(ref, np.float32)[seen.numpy()]
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
