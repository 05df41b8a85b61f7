"""The work walk of the persistent linear_rstat GEMM (csrc/matmul_stat.cu) on
the CPU, and the wrapper's shape check.

kernel_walk writes out in Python what the kernel's producer and consumer
loops compute: the grid is min(2 x row blocks, 132) CTAs rounded down to
even, in clusters of two; cluster q of the grid's g / 2 takes row blocks q,
q + g / 2, ..., and for each its CTA of rank r sweeps the N tiles r, r + 2,
... in column order (BN columns, the last BN_TAIL wide when N % BN ==
BN_TAIL), loading per K slice one x box of BM rows and one W box per 64
columns of the tile; each consumer thread (warpgroup c, warp w, lane group
g, quad index t) owns rows row0 = m0 + 64c + 16w + g and row0 + 8 of the
block, stores column groups 16h + 4m + t (8 columns each) of each
128-column half h of the tile, and stores only rows below M; rank 1 hands
its square-sums to rank 0, which adds them to its own and writes rs. The
tests hold that walk to: every element of y written exactly once, every
row's tiles taken by one cluster, each CTA's in column order, nothing
stored past M, every load inside the matrices and of the bytes the full
barrier expects."""

import numpy as np
import pytest
import torch

from versecrafter_tpu_torch.kernels import matmul_stat as ms

SMS = 132  # an H100's SMs: the persistent grid's upper bound
BOX_COLS = 64  # bf16 columns of a 128-byte swizzled box
MS_ = [1, 63, 64, 333, 32760, 65520]
NS_ = [128, 384, 1536, 5120]


def tile_widths(N):
    """The N tiles of a row block in sweep order: (n0, width)."""
    return [(n0, min(ms.BN, N - n0)) for n0 in range(0, N, ms.BN)]


def kernel_walk(M, N, sms=SMS):
    """{(cluster, rank): [(row block m0, [(n0, width), ...]), ...]} in the
    order each CTA takes its row blocks and tiles."""
    items = -(-M // ms.BM)
    pairs = min(2 * items, sms) // 2
    return {(q, r): [(i * ms.BM, tile_widths(N)[r::2]) for i in range(q, items, pairs)]
            for q in range(pairs) for r in (0, 1)}


def thread_rows(m0):
    """The rows of row block m0 the consumer threads own, one entry per
    (warpgroup, warp, lane group, accumulator row half)."""
    c, w, g, r2 = np.meshgrid(np.arange(2), np.arange(4), np.arange(8), np.arange(2),
                              indexing="ij")
    return (m0 + 64 * c + 16 * w + g + 8 * r2).ravel()


def thread_cols(n0, width):
    """The columns of a tile the quad threads store: store_row's 16-byte
    column groups 16h + 4m + t of each 128-column half h, 8 columns each."""
    h, m, t, e = np.meshgrid(np.arange(width // 128), np.arange(4), np.arange(4), np.arange(8),
                             indexing="ij")
    return (n0 + 128 * h + 8 * (4 * m + t) + e).ravel()


@pytest.mark.parametrize("N", NS_)
@pytest.mark.parametrize("M", MS_)
def test_walk_writes_every_element_once(M, N):
    walk = kernel_walk(M, N)
    items = -(-M // ms.BM)
    assert len(walk) == min(2 * items, SMS) // 2 * 2 <= SMS  # whole clusters, one CTA an SM
    tiles = tile_widths(N)
    # the tiles end to end in column order, each BN wide but a BN_TAIL-wide last one
    assert [n0 for n0, _ in tiles] == list(range(0, N, ms.BN))
    assert all(w == ms.BN for _, w in tiles[:-1]) and tiles[-1][1] in (ms.BN, ms.BN_TAIL)
    row_hits = np.zeros(M, np.int64)
    owner = {}
    for (q, rank), blocks in walk.items():
        assert [m0 for m0, _ in blocks] == sorted(m0 for m0, _ in blocks)
        # both CTAs of a cluster take the same row blocks in the same order
        assert [m0 for m0, _ in blocks] == [m0 for m0, _ in walk[(q, 1 - rank)]]
        for m0, own in blocks:
            assert owner.setdefault(m0, q) == q  # one cluster a row block: the whole row
            assert [n0 for n0, _ in own] == sorted(n0 for n0, _ in own)  # column order
            if rank == 1:
                continue
            rows = thread_rows(m0)
            assert np.array_equal(np.sort(rows), np.arange(m0, m0 + ms.BM))
            row_hits[rows[rows < M]] += 1  # store_row writes only rows below M
            if (rows >= M).any():  # only the last row block reaches past M
                assert m0 == (items - 1) * ms.BM
            both = own + dict(walk[(q, 1)])[m0]
            col_hits = np.bincount(np.concatenate([thread_cols(n0, w) for n0, w in both]),
                                   minlength=N)
            assert col_hits.shape == (N,) and (col_hits == 1).all()
    assert sorted(owner) == [i * ms.BM for i in range(items)]
    assert (row_hits == 1).all()


@pytest.mark.parametrize("K", [64, 256, 1536, 5120])
@pytest.mark.parametrize("N", NS_)
def test_loads_stay_inside_the_matrices(N, K):
    """The producer's boxes for one row block: the x box at (column k0, row
    m0) and W boxes at (column n0 + 64j, row k0) cover the K slices and the
    tile's columns exactly once, and the bytes the full barrier expects are
    the boxes' bytes (a box past M is zero-filled, still counted in full)."""
    sw_row = 128
    for n0, width in tile_widths(N):
        boxes = width // BOX_COLS
        cols = np.concatenate([np.arange(n0 + BOX_COLS * j, n0 + BOX_COLS * (j + 1))
                               for j in range(boxes)])
        assert np.array_equal(cols, np.arange(n0, n0 + width)) and cols.max() < N
        k0s = [kb * ms.BK for kb in range(K // ms.BK)]
        assert np.array_equal(np.concatenate([np.arange(k, k + ms.BK) for k in k0s]),
                              np.arange(K))
        expect_tx = ms.BM * sw_row + boxes * ms.BK * sw_row
        assert expect_tx == (ms.BM * ms.BK + ms.BK * width) * 2


@pytest.mark.parametrize("M,K,N", [(1, 64, 128), (333, 1536, 1536), (65520, 1536, 1536),
                                   (333, 5120, 5120), (7, 256, 384)])
def test_shape_check_takes_the_kernel_shapes(M, K, N):
    ms.check_shape(M, K, N)


@pytest.mark.parametrize("M,K,N", [(0, 64, 128), (16, 32, 128), (16, 224, 128),
                                   (16, 1536, 64), (16, 1536, 200), (16, 0, 128),
                                   (16, 64, 0), (16, 64, 8320)])
def test_shape_check_rejects_before_any_launch(M, K, N):
    """K % 64, N % 128, N <= 8192 and M > 0, raised by the wrapper before a library is
    loaded; the CPU path (the plain version) takes any shape."""
    with pytest.raises(ValueError):
        ms.check_shape(M, K, N)
    if M and K and N:
        x = torch.randn(M, K).to(torch.bfloat16)
        p = {"kernel": torch.randn(K, N).to(torch.bfloat16)}
        y, rs = ms.linear_rstat(p, x)
        assert y.shape == (M, N) and rs.shape == (M, 1)
