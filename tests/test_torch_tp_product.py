"""The row-parallel W8A8 / W4A8 product on one process: utils/quantize's
int8_compute_dot on each of n tensor-parallel shards (quantize.tp_shard),
run one after another with torch.distributed.all_reduce replayed across
them (_replay: each round knows the reductions of the calls before it and
gathers the shards' contributions to the next), against the one-rank
product. The row absmax reduced with MAX and the s32 partials summed before
the one rescale give the one-rank product bit for bit; rescaling each
shard's partial and summing the results does not. A grouped int4
weight-only leaf cut where its 128-row groups straddle the shards
dequantizes to the whole leaf's rows. CPU, fp32 and bf16."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from versecrafter_tpu_torch.utils import quantize as tq


def _replay(monkeypatch, n, shard_fn):
    """Each shard's shard_fn(i), its all_reduce calls replayed across the
    n shards; returns (outputs, the reductions in call order)."""
    results = []
    while True:
        contrib = []
        outs = []
        for i in range(n):
            calls = [0]

            def all_reduce(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
                j = calls[0]
                calls[0] += 1
                if j < len(results):
                    t.copy_(results[j])
                elif j == len(results):
                    contrib.append((t.clone(), op))
            monkeypatch.setattr(dist, "all_reduce", all_reduce)
            outs.append(shard_fn(i))
        if not contrib:
            return outs, results
        ts = torch.stack([t for t, _ in contrib])
        results.append(ts.amax(0) if contrib[0][1] == dist.ReduceOp.MAX
                       else ts.sum(0, dtype=ts.dtype))


def _leaf(bits, k=512, n=96, seed=0):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(k, n, generator=g) * 0.05
    leaf = tq._quantize_leaf(w, bits, 0 if bits == 4 else None)
    return tq.tag_int8_compute({"ffn_out": {"kernel": leaf}})["ffn_out"]["kernel"]


def _x(dtype, rows=40, k=512, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(rows, k, generator=g) * torch.linspace(0.2, 3.0, k)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("row_scales", [True, False])
def test_row_parallel_product_is_the_one_rank_product(monkeypatch, dtype, bits, n,
                                                      row_scales):
    monkeypatch.setattr(tq, "ROW_ACT_SCALES", row_scales)
    leaf, x = _leaf(bits), _x(dtype)
    assert tq.is_compute_tagged(leaf) and ("q4values" in leaf) == (bits == 4)
    whole = tq.int8_compute_dot(leaf, x)
    kl = x.shape[1] // n
    shards = [tq.tp_shard(leaf, "row", i, n) for i in range(n)]
    for s in shards:
        assert tq.codes(s).shape[0] == tq.codes(leaf).shape[0] // n
    outs, red = _replay(monkeypatch, n, lambda i: tq.int8_compute_dot(
        shards[i], x[:, i * kl:(i + 1) * kl], row_group="tp", tensor_group="world"))
    for out in outs:
        assert out.dtype == dtype
        assert torch.equal(out, whole)
    # the summed s32 partials are the whole s32 product
    a, xq = tq._quantize_rows(x, None if row_scales else
                              tq._div(x.abs().amax().float().clamp_min(1e-8), 127.0))
    y32 = tq._int_mm(xq, tq._product_weight(leaf))
    assert red[-1].dtype == torch.int32 and torch.equal(red[-1], y32)
    if dtype == torch.float32:
        # rescaling each shard's partial and summing the fp32 results
        parts = [tq._rescale(tq._int_mm(xq[:, i * kl:(i + 1) * kl],
                                        tq._product_weight(s)), a, s["qscales"], dtype)
                 for i, s in enumerate(shards)]
        assert not torch.equal(torch.stack(parts).sum(0), whole)


@pytest.mark.parametrize("bits", [8, 4])
def test_column_shard_is_the_whole_products_columns(bits):
    leaf, x = _leaf(bits), _x(torch.float32)
    whole = tq.int8_compute_dot(leaf, x)
    for i in range(4):
        s = tq.tp_shard(leaf, "col", i, 4)
        assert tuple(s["qscales"].shape) == (1, 24)
        assert torch.equal(tq.int8_compute_dot(s, x), whole[:, 24 * i:24 * (i + 1)])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_grouped_int4_shards_straddling_a_group(n):
    """K = 384 in three 128-row groups: 192 / 96 / 48 rows a shard, and at
    each n some shard straddles a group boundary. Each shard keeps only its
    packed rows and the scale rows that cover them."""
    g = torch.Generator().manual_seed(2)
    w = torch.randn(384, 64, generator=g)
    leaf = tq._quantize_leaf(w, 4, None)
    assert tuple(leaf["qscales"].shape) == (3, 1, 64)
    whole = tq.dequantize_leaf(leaf, torch.float32)
    kl = 384 // n
    for i in range(n):
        s = tq.tp_shard(leaf, "row", i, n)
        assert tuple(s["q4values"].shape) == (kl // 2, 64)
        first, last = i * kl // 128, (i * kl + kl - 1) // 128
        assert tuple(s["qscales"].shape) == (last - first + 1, 1, 64)
        assert torch.equal(tq.dequantize_leaf(s, torch.float32), whole[i * kl:(i + 1) * kl])
    straddles = [i for i in range(n) if (i * kl) // 128 != (i * kl + kl - 1) // 128]
    assert straddles, n


def test_packed_rows_must_divide():
    """A row cut that does not divide int4's packed rows (K / 2 = 15 over
    2) is refused, not cut inside a byte."""
    w = torch.from_numpy(np.random.default_rng(3).standard_normal((30, 8)).astype(np.float32))
    leaf = tq._quantize_leaf(w, 4, 0)
    with pytest.raises(ValueError, match="do not divide"):
        tq.tp_shard(leaf, "row", 0, 2)
