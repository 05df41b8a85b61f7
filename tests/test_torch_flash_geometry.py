"""The geometry of the persistent attention schedule (csrc/attention_wgmma.cuh:
the plain head-major forward and the fused flavors) on the CPU, and the
plain flash-attention forward (what the CPU runs, and the yardstick the card
tests hold the CUDA kernel to) against the JAX kernel in Pallas interpret
mode at the same geometries: lengths that straddle the 128-row q tiles and
128-key tiles in both directions, keys shorter than a tile, per-batch key
lengths holding a 0, and windows.

The item walk (kernel_items, the kernels' `Item` arithmetic written out in
Python) must give every (b, h, q tile) once, q tile fastest, and load
exactly the key tiles that hold a key some row of the item can see; a tile
whose mask the softmax skips (tile_skips_mask, `tile_softmax`'s test) must
be visible to every row of the warpgroup. Rows that see no key are left
out of the JAX comparison: the port writes 0 there (asserted), the Pallas
kernel an average over masked keys (ROADMAP §3)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versecrafter_tpu_torch.kernels import flash_attention as tfa

jfa = importlib.import_module("versecrafter_tpu.kernels.flash_attention")

T = tfa.FUSED_TILE
CASES = [  # (B, N, Sq, Skv, window, k_lens)
    (1, 2, 193, 321, (-1, -1), None),
    (2, 2, 129, 64, (-1, -1), (64, 0)),
    (1, 2, 200, 40, (-1, -1), None),
    (1, 2, 384, 384, (64, 32), None),
    (2, 1, 333, 333, (100, 27), (333, 150)),
    (1, 1, 300, 300, (-1, 0), None),
]
IDS = ["193x321", "129x64_k_lens", "200x40", "window64_32", "window100_27_k_lens", "causal"]


def kernel_items(B, N, Sq, Skv, k_lens=None, window_size=(-1, -1)):
    """The work items of the persistent attention kernels (the fused
    flavors and the plain forward) as csrc/attention_wgmma.cuh `Item` and
    its launch compute them, in launch order, q tile fastest: (b, h, q0,
    n_lo, n_hi) for 128 q rows from q0 and the 128-key tiles [n_lo, n_hi)
    they load (up to k_len, and inside the window of at least one of the 128
    rows). CTA c of a grid of g walks items c, c + g, ..."""
    wl, wr = window_size
    q_tiles = -(-Sq // T)
    items = []
    for b in range(B):
        k_len = Skv if k_lens is None else min(max(int(k_lens[b]), 0), Skv)
        for h in range(N):
            for t in range(q_tiles):
                q0 = t * T
                n_lo, n_hi = 0, -(-k_len // T)
                if wl >= 0:
                    n_lo = max(q0 - wl, 0) // T
                if wr >= 0:
                    n_hi = min(n_hi, (q0 + T - 1 + wr) // T + 1)
                if wl >= 0 and q0 - wl >= k_len:  # every window starts past k_len
                    n_hi = n_lo
                items.append((b, h, q0, n_lo, n_hi))
    return items


def tile_skips_mask(q0w, n, k_len, window_size):
    """Whether the kernels' softmax skips the mask for key tile n of the
    consumer warpgroup whose 64 q rows start at q0w (csrc/attention_wgmma.cuh
    `tile_softmax`): the tile lies inside k_len and inside every row's
    window."""
    wl, wr = window_size
    kv0 = n * T
    return (kv0 + T <= k_len and (wl < 0 or kv0 >= q0w + T // 2 - 1 - wl)
            and (wr < 0 or kv0 + T - 1 <= q0w + wr))


def _k_len(Skv, k_lens, b):
    return Skv if k_lens is None else min(k_lens[b], Skv)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_item_walk_covers_each_q_tile_once(case):
    B, N, Sq, Skv, window, k_lens = case
    items = kernel_items(B, N, Sq, Skv, k_lens, window)
    q_tiles = -(-Sq // T)
    assert [(b, h, q0) for b, h, q0, _, _ in items] == [
        (b, h, t * T) for b in range(B) for h in range(N) for t in range(q_tiles)]
    for grid in (1, 3, 132):  # a persistent CTA c walks c, c + grid, ...
        walked = sorted(i for c in range(min(grid, len(items)))
                        for i in range(c, len(items), grid))
        assert walked == list(range(len(items)))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_item_loads_exactly_the_visible_tiles(case):
    """[n_lo, n_hi) is the set of key tiles holding a key that one of the
    item's 128 rows (rows past Sq included: the kernel computes them and
    does not write them) can see."""
    B, N, Sq, Skv, window, k_lens = case
    for b, h, q0, n_lo, n_hi in kernel_items(B, N, Sq, Skv, k_lens, window):
        kl = torch.tensor([_k_len(Skv, k_lens, b)], dtype=torch.int32)
        ok = tfa.visible_keys(q0, q0 + T, Skv, kl, window)[0, 0]  # [T, Skv]
        tiles = {j // T for j in range(Skv) if ok[:, j].any()}
        assert set(range(n_lo, n_hi)) == tiles, (b, h, q0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mask_skip_only_on_wholly_visible_tiles(case):
    B, N, Sq, Skv, window, k_lens = case
    skipped = 0
    for b, h, q0, n_lo, n_hi in kernel_items(B, N, Sq, Skv, k_lens, window):
        k_len = _k_len(Skv, k_lens, b)
        kl = torch.tensor([k_len], dtype=torch.int32)
        for q0w in (q0, q0 + T // 2):  # the two consumer warpgroups' rows
            ok = tfa.visible_keys(q0w, q0w + T // 2, max(Skv, (n_hi + 1) * T), kl, window)[0, 0]
            for n in range(n_lo, n_hi):
                if tile_skips_mask(q0w, n, k_len, window):
                    assert ok[:, n * T:(n + 1) * T].all(), (b, q0w, n)
                    skipped += 1
    if window == (-1, -1) and k_lens is None and Skv >= T:
        assert skipped > 0  # the fast path is taken where it can be


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("stats", [True, False], ids=["stats", "exp2"])
def test_plain_forward_matches_jax_kernel_at_tile_edges(case, stats):
    B, N, Sq, Skv, window, k_lens = case
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.standard_normal((B, N, S, 128)) * sc, jnp.bfloat16)
               for S, sc in ((Sq, 2.0), (Skv, 1.0), (Skv, 1.0)))
    kl = jnp.asarray(k_lens if k_lens is not None else (Skv,) * B, jnp.int32)
    sm = 128 ** -0.5
    ref = jfa._flash_attention_pallas(q, k, v, kl, sm_scale=sm, block_q=128, block_kv=128,
                                      interpret=True, return_stats=stats, window=window)
    ref = ref if stats else (ref,)
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
                  for x in (q, k, v))
    tkl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32)
    got = tfa.flash_attention_plain(tq, tk, tv, tkl, sm, window, stats=stats)
    got = got if stats else (got,)
    kl_t = torch.tensor(k_lens if k_lens is not None else (Skv,) * B, dtype=torch.int32)
    seen = tfa.visible_keys(0, Sq, Skv, kl_t, window).expand(B, N, Sq, Skv).any(-1)
    if (~seen).any():  # rows that see no key: 0, m = NEG_INF, l = 0
        assert got[0][~seen].abs().max().item() == 0.0
        if stats:
            assert (got[1][~seen] == tfa.NEG_INF).all() and (got[2][~seen] == 0).all()
    s = seen.numpy()
    o, r = got[0].float().numpy()[s], np.asarray(ref[0].astype(jnp.float32))[s]
    assert np.abs(o - r).max() <= 2 * 2.0 ** -8 * np.abs(r).max()
    if stats:  # m, l fp32: the same bf16 inputs, sums in another order
        np.testing.assert_allclose(got[1].numpy()[s], np.asarray(ref[1])[s], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got[2].numpy()[s], np.asarray(ref[2])[s], rtol=1e-4)
