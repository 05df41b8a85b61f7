"""The port's CUDA kernels (fused attention with its int8 flavor, plain
flash attention and its FA2 backward, the linear_rstat GEMM) against their
plain PyTorch versions, and the W8A8 product against the CPU, on the card.

Every test here needs an NVIDIA GPU with nvcc and skips without one. This
module imports no JAX, so on a GPU machine without JAX it runs with the
repo's conftest switched off:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from versecrafter_tpu_torch.kernels import flash_attention as fa
from versecrafter_tpu_torch.kernels.rope import grid_cos_sin, rope_3d_angles

pytestmark = pytest.mark.cuda

BF16_BAR = 2 * 2.0 ** -8  # bf16: two roundings' worth, relative to max|plain|


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, B=2, S=520, N=2, Skv=None, seed=0):
    HD = fa.HEAD_DIM
    D = N * HD
    Skv = S if Skv is None else Skv
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0, shift=0.0, dtype=torch.bfloat16):
        return torch.as_tensor(rng.standard_normal(shape) * scale + shift,
                               dtype=torch.float32, device=dev).to(dtype)

    q, k, v = t((B, S, D)), t((B, Skv, D)), t((B, Skv, D))
    gq = t((D,), 0.1, 1.0, torch.float32)
    gk = t((D,), 0.1, 1.0, torch.float32)
    ang = rope_3d_angles(HD, max_pos=64)
    f = -(-max(S, Skv) // 52)
    cos, sin = grid_cos_sin(ang, f, 4, 13, device=dev)
    return q, k, v, gq, gk, cos[:max(S, Skv)], sin[:max(S, Skv)], N


def _stats(q, k, gq, gk):
    sm = fa.HEAD_DIM ** -0.5
    return fa._stats_and_scales(q, k, gq, gk, 1e-6, sm)


def _err(got, ref):
    return (got.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()


@pytest.mark.parametrize("window,k_lens", [((-1, -1), None), ((64, 32), None),
                                           ((-1, -1), (300, 0))])
def test_rope_flavor_matches_plain(dev, window, k_lens):
    q, k, v, gq, gk, cos, sin, N = _inputs(dev)
    rq, rk, gqv, gkv = _stats(q, k, gq, gk)
    ci, si = fa.prepare_fused_rope_tables(cos, sin)
    kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device=dev)
    before = fa.LAUNCHES["fused_rope_rms_attention"]
    got = fa.fused_attention(q, k, v, rq, rk, gqv, gkv, ci, si, num_heads=N,
                             window_size=window, k_lens=kl)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["fused_rope_rms_attention"] == before + 1
    ref = fa.fused_attention_plain(q, k, v, rq, rk, gqv, gkv, ci, si,
                                   num_heads=N, window_size=window, k_lens=kl)
    err, mx = _err(got, ref)
    assert err <= BF16_BAR * mx, (err, mx)
    if k_lens is not None:  # a batch element that sees no key writes zeros
        assert got[1].abs().max().item() == 0.0


def test_cross_flavor_matches_plain(dev):
    q, k, v, gq, gk, _, _, N = _inputs(dev, S=700, Skv=77)
    rq, rk, gqv, gkv = _stats(q, k, gq, gk)
    before = fa.LAUNCHES["fused_rms_cross_attention"]
    got = fa.fused_rms_cross_attention(q, k, v, gq, gk, num_heads=N)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["fused_rms_cross_attention"] == before + 1
    ref = fa.fused_attention_plain(q, k, v, rq, rk, gqv, gkv, num_heads=N)
    err, mx = _err(got, ref)
    assert err <= BF16_BAR * mx, (err, mx)


def test_kernel_rejects_what_it_cannot_take(dev):
    q, k, v, gq, gk, cos, sin, N = _inputs(dev, S=128)
    with pytest.raises(ValueError):
        fa.fused_rms_cross_attention(q.float(), k.float(), v.float(), gq, gk,
                                     num_heads=N)
    with pytest.raises(ValueError):  # head_dim 64
        fa.fused_rms_cross_attention(q, k, v, gq, gk, num_heads=2 * N)


# shapes that straddle the bf16 fused kernel's 128-row q tiles and 128-key
# tiles in both directions, keys shorter than a tile, k_lens holding a 0,
# windows, 32,760 = 255 * 128 + 120 q rows at one head, and the Wan2.1-14B
# head count (40 heads: rows of 5120 columns, 10,240 bytes)
FUSED_CASES = [  # (B, N, Sq, Skv, window, k_lens)
    (1, 2, 193, 321, (-1, -1), None),
    (2, 2, 129, 64, (-1, -1), (64, 0)),
    (1, 2, 200, 40, (-1, -1), None),
    (2, 2, 700, 77, (-1, -1), (77, 5)),
    (1, 1, 32760, 192, (-1, -1), None),
    (1, 2, 384, 384, (64, 32), None),
    (2, 2, 333, 333, (100, 27), (333, 0)),
    (1, 2, 300, 300, (-1, 0), None),
    (2, 40, 1000, 600, (-1, -1), (600, 77)),
]


def _fused_inputs(dev, B, N, Sq, Skv, seed):
    """Raw projections, statistics, scales and interleaved tables covering
    max(Sq, Skv) rows of a 30 x 52 token grid."""
    rng = np.random.default_rng(seed)
    D = N * fa.HEAD_DIM

    def t(shape, scale=1.0, shift=0.0, dtype=torch.bfloat16):
        return torch.as_tensor(rng.standard_normal(shape) * scale + shift,
                               dtype=torch.float32, device=dev).to(dtype)

    q, k, v = t((B, Sq, D)), t((B, Skv, D)), t((B, Skv, D))
    # a q scale of ~2: peaked softmax rows, outputs O(1)
    gq, gk = t((D,), 0.2, 2.0, torch.float32), t((D,), 0.1, 1.0, torch.float32)
    rows = max(Sq, Skv)
    cos, sin = grid_cos_sin(rope_3d_angles(fa.HEAD_DIM), -(-rows // 1560), 30, 52, device=dev)
    rq, rk, gqv, gkv = fa._stats_and_scales(q, k, gq, gk, 1e-6, fa.HEAD_DIM ** -0.5)
    ci, si = fa.prepare_fused_rope_tables(cos[:rows], sin[:rows])
    return q, k, v, rq, rk, gqv, gkv, ci, si


@pytest.mark.parametrize("case", FUSED_CASES)
@pytest.mark.parametrize("rope", [True, False])
def test_fused_flavors_at_tile_edges(dev, case, rope):
    """Both bf16 flavors against the plain version at shapes that straddle
    the kernel's tiles and CTAs; a batch element with k_len 0 writes zeros
    and a rerun is bit-identical (no atomics, no split over keys)."""
    B, N, Sq, Skv, window, k_lens = case
    q, k, v, rq, rk, gq, gk, ci, si = _fused_inputs(dev, B, N, Sq, Skv, seed=4)
    tabs = (ci, si) if rope else (None, None)
    kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device=dev)
    kw = dict(num_heads=N, window_size=window, k_lens=kl)
    name = "fused_rope_rms_attention" if rope else "fused_rms_cross_attention"
    before = fa.LAUNCHES[name]
    got = fa.fused_attention(q, k, v, rq, rk, gq, gk, *tabs, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[name] == before + 1
    ref = fa.fused_attention_plain(q, k, v, rq, rk, gq, gk, *tabs, **kw)
    err, mx = _err(got, ref)
    assert err <= BF16_BAR * mx, (err, mx)
    for b_, n_ in enumerate(k_lens or ()):
        if n_ == 0:
            assert got[b_].abs().max().item() == 0.0
    assert torch.equal(got, fa.fused_attention(q, k, v, rq, rk, gq, gk, *tabs, **kw))


def test_fused_wgmma_layout(dev):
    """The bf16 fused kernel's product forms on integer-valued tiles read
    through the flat tensor map at head 1 of 2: A Bᵀ (m64n128k16, A as
    register fragments from the 128-row swizzled tile, one warpgroup per 64
    rows, B K-major) and bf16(A Bᵀ) B (packed scores as register A, B read
    MN-major);
    exact. The tensor has 100 rows: rows 100..127 of the tiles must read as
    zeros."""
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-1, 2, (1, 100, 256), generator=g).float()
    b = torch.randint(-1, 2, (1, 100, 256), generator=g).float()
    c_s, c_pv = fa.fused_layout_check(a.to(dev).bfloat16(), b.to(dev).bfloat16(), h=1)
    torch.cuda.synchronize()
    at, bt = torch.zeros(128, 128), torch.zeros(128, 128)
    at[:100], bt[:100] = a[0, :, 128:], b[0, :, 128:]
    want = at @ bt.T  # |entries| <= 128: exact in bf16
    assert torch.equal(c_s.cpu(), want)
    assert torch.equal(c_pv.cpu(), want @ bt)


def test_fused_rejects_misaligned_or_strided_inputs(dev):
    """The tensor maps need contiguous, 16-byte aligned projections: a
    sliced or shifted view raises instead of launching."""
    q, k, v, rq, rk, gq, gk, ci, si = _fused_inputs(dev, 1, 2, 130, 130, seed=5)
    before = dict(fa.LAUNCHES)
    strided = torch.cat([k, k], dim=1)[:, ::2]  # non-contiguous rows
    shifted = torch.cat([v, v], dim=1).view(-1)[1:1 + v.numel()].view(v.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    for rope in (True, False):
        tabs = (ci, si) if rope else (None, None)
        for bad in (dict(k=strided), dict(v=shifted), dict(q=shifted)):
            args = {"q": q, "k": k, "v": v, **bad}
            with pytest.raises(ValueError):
                fa.fused_attention(args["q"], args["k"], args["v"], rq, rk, gq, gk, *tabs,
                                   num_heads=2)
    assert fa.LAUNCHES == before
    fa.fused_attention(q, k, v, rq, rk, gq, gk, ci, si, num_heads=2)  # aligned: launches
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# plain flash attention (both flavors) and the FA2 backward kernels
# ---------------------------------------------------------------------------

def _head_major(dev, B, N, Sq, Skv, seed=0):
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=torch.float32,
                               device=dev).to(torch.bfloat16)

    # a q scale of 2 gives peaked softmax rows (outputs O(1))
    return (t((B, N, Sq, fa.HEAD_DIM), 2.0), t((B, N, Skv, fa.HEAD_DIM)),
            t((B, N, Skv, fa.HEAD_DIM)), t((B, N, Sq, fa.HEAD_DIM)))


FA_CASES = [  # (B, N, Sq, Skv, window, k_lens)
    (2, 2, 520, 520, (-1, -1), None),
    (2, 2, 520, 520, (64, 32), (300, 0)),
    (1, 2, 520, 520, (-1, 0), None),
    (2, 2, 700, 77, (-1, -1), None),
    # shapes that straddle the backward kernels' 64-row tiles and 128-row
    # CTAs in both directions, a key sequence shorter than one tile, and the
    # training length (32,760 = 255 * 128 + 120) at one head
    (1, 2, 193, 321, (-1, -1), None),
    (2, 2, 129, 64, (-1, -1), (64, 1)),
    (1, 2, 384, 384, (100, 27), None),
    (1, 2, 200, 40, (-1, -1), None),
    (1, 1, 32760, 192, (-1, -1), None),
    (2, 2, 333, 333, (100, 27), (333, 0)),
]


@pytest.mark.parametrize("case", FA_CASES)
@pytest.mark.parametrize("stats", [True, False])
def test_flash_forward_matches_plain(dev, case, stats):
    B, N, Sq, Skv, window, k_lens = case
    q, k, v, _ = _head_major(dev, B, N, Sq, Skv)
    kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device=dev)
    before = fa.LAUNCHES["flash_attention"]
    got = fa._fa_forward(q, k, v, kl, fa.HEAD_DIM ** -0.5, window, stats)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    ref = fa.flash_attention_plain(q, k, v, kl, fa.HEAD_DIM ** -0.5, window, stats=stats)
    got, ref = (got, ref) if stats else ((got,), (ref,))
    err, mx = _err(got[0], ref[0])
    assert err <= BF16_BAR * mx, (err, mx)
    if stats:  # m, l fp32: only the summation order differs
        seen = ref[2] > 0
        assert torch.equal(got[2] > 0, seen)
        assert torch.allclose(got[1][seen], ref[1][seen], rtol=1e-5, atol=1e-5)
        assert torch.allclose(got[2], ref[2], rtol=1e-4, atol=0)
        assert (got[1][~seen] == fa.NEG_INF).all()
    if k_lens is not None:  # a batch element that sees no key writes zeros
        for b_, n_ in enumerate(k_lens):
            if n_ == 0:
                assert got[0][b_].abs().max().item() == 0.0
    # no atomics: a second run is bit-identical
    again = fa._fa_forward(q, k, v, kl, fa.HEAD_DIM ** -0.5, window, stats)
    again = again if stats else (again,)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("flavor", ["flash_stats", "flash_exp2", "rope", "cross", "int8"])
def test_back_to_back_launches_agree(dev, flavor):
    """Twenty launches queued without a host sync between them, at 32,760 q
    rows x 192 keys (items of two key tiles, so the q tile turns over fast):
    every output equals the first bit for bit and holds the plain version's
    bar. The q tile is rewritten in place and then refilled by TMA; without
    the proxy fence before its release, most exp2-flavor outputs here were
    wrong in a few rows."""
    if flavor.startswith("flash"):
        q, k, v, _ = _head_major(dev, 1, 1, 32760, 192)
        stats = flavor == "flash_stats"
        sm = fa.HEAD_DIM ** -0.5
        outs = [fa._fa_forward(q, k, v, None, sm, (-1, -1), stats) for _ in range(20)]
        outs = [o[0] if stats else o for o in outs]
        ref = fa.flash_attention_plain(q, k, v, None, sm, (-1, -1), stats=stats)
        ref = ref[0] if stats else ref
    else:
        q, k, v, rq, rk, gq, gk, ci, si = _fused_inputs(dev, 1, 1, 32760, 192, seed=6)
        tabs = (None, None) if flavor == "cross" else (ci, si)
        kw = dict(num_heads=1, int8_score=flavor == "int8")
        outs = [fa.fused_attention(q, k, v, rq, rk, gq, gk, *tabs, **kw) for _ in range(20)]
        ref = fa.fused_attention_plain(q, k, v, rq, rk, gq, gk, *tabs, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs)
    err, mx = _err(outs[0], ref)
    assert err <= BF16_BAR * mx, (err, mx)


@pytest.mark.parametrize("case", FA_CASES)
def test_backward_kernels_match_plain(dev, case):
    from versecrafter_tpu_torch.kernels import flash_attention_bwd as fab
    B, N, Sq, Skv, window, k_lens = case
    q, k, v, do = _head_major(dev, B, N, Sq, Skv, seed=1)
    kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device=dev)
    sm = fa.HEAD_DIM ** -0.5
    out, m, l = fa.flash_attention_plain(q, k, v, kl, sm, window, stats=True)
    qs, L, delta = fab.backward_preamble(q, out, m, l, do, sm)
    before = dict(fab.LAUNCHES)
    got = fab.fa_backward(q, k, v, out, m, l, do, kl, sm, window)
    torch.cuda.synchronize()
    assert fab.LAUNCHES["fa_backward_dq"] == before["fa_backward_dq"] + 1
    assert fab.LAUNCHES["fa_backward_dkv"] == before["fa_backward_dkv"] + 1
    ref = fab.fa_backward_plain(qs, k, v, do, L, delta, kl, sm, window)
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        err, mx = _err(g, r)
        assert err <= BF16_BAR * mx, (name, err, mx)
    if k_lens is not None:  # keys past k_len get exactly zero dK/dV
        for g in got[1:]:
            for b_, n_ in enumerate(k_lens):
                if n_ < Skv:
                    assert g[b_, :, n_:].abs().max().item() == 0.0
    # no atomics: a second run is bit-identical
    again = fab.fa_backward(q, k, v, out, m, l, do, kl, sm, window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case", FA_CASES[:3])
def test_autograd_path_matches_plain_path(dev, case):
    """Gradients through the kernels (card) against the same autograd graph
    through the plain versions (CPU), on the same bf16 inputs."""
    B, N, Sq, Skv, window, k_lens = case
    q, k, v, w = _head_major(dev, B, N, Sq, Skv, seed=2)
    kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32)

    def grads(device):
        ins = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*ins, k_lens=None if kl is None else kl.to(device),
                                 window_size=window)
        (out.float() * w.to(device).float()).sum().backward()
        return [out] + [t.grad for t in ins]

    got, ref = grads(dev), grads("cpu")
    for g, r, name in zip(got, ref, ("out", "dq", "dk", "dv")):
        err, mx = _err(g.cpu(), r)
        assert err <= BF16_BAR * mx, (name, err, mx)


def test_fused_functions_route_grad_through_flash_kernels(dev):
    from versecrafter_tpu_torch.kernels import flash_attention_bwd as fab
    q, k, v, gq, gk, cos, sin, N = _inputs(dev, S=260)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    fa.reset_launch_counts()
    fab.reset_launch_counts()
    out = fa.fused_rope_rms_attention(q, k, v, cos, sin, gq, gk, num_heads=N)
    out = out + fa.fused_rms_cross_attention(out, k.detach()[:, :77], v.detach()[:, :77],
                                             gq, gk, num_heads=N)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"fused_rope_rms_attention": 0, "fused_rope_rms_attention_int8": 0,
                           "fused_rms_cross_attention": 0, "flash_attention": 2}
    # cross K/V come from a detached context: dQ only for the cross call
    assert fab.LAUNCHES == {"fa_backward_dq": 2, "fa_backward_dkv": 1}
    for t in (q, k, v):
        assert torch.isfinite(t.grad).all() and t.grad.abs().max().item() > 0


def test_wgmma_fragment_layout(dev):
    """The backward kernels' wgmma forms on an integer-valued tile pair: A Bᵀ
    with both operands K-major from TMA-written swizzled tiles, the same
    with A from registers, and bf16(A Bᵀ) B with the packed accumulator as
    register A and B read MN-major; and the linear_rstat GEMM's forms, A
    K-major and B MN-major both from shared memory at n256 (over the A and B
    tiles read as one [64, 256] tile) and n128: all exact. Matrix 0 of 2 has
    50 rows, so rows 50..63 of its tile must read as zeros, not as matrix
    1's rows."""
    from versecrafter_tpu_torch.kernels import flash_attention_bwd as fab
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-1, 2, (2, 50, 128), generator=g).float()
    b = torch.randint(-1, 2, (2, 50, 128), generator=g).float()
    for which in (0, 1):
        ss, rs, pb, sb = fab.wgmma_layout_check(a.to(dev).bfloat16(), b.to(dev).bfloat16(),
                                                which)
        torch.cuda.synchronize()
        at, bt = torch.zeros(64, 128), torch.zeros(64, 128)
        at[:50], bt[:50] = a[which], b[which]
        want = at @ bt.T  # |entries| <= 128: exact in bf16
        assert torch.equal(ss.cpu(), want)
        assert torch.equal(rs.cpu(), want)
        assert torch.equal(pb.cpu(), want @ bt)
        assert torch.equal(sb.cpu(), at[:, :64] @ torch.cat([at, bt, bt], 1))


def test_backward_rejects_misaligned_or_strided_inputs(dev):
    """The tensor maps need contiguous, 16-byte aligned tensors: a sliced
    view raises instead of launching."""
    from versecrafter_tpu_torch.kernels import flash_attention_bwd as fab
    q, k, v, do = _head_major(dev, 1, 2, 130, 130, seed=3)
    sm = fa.HEAD_DIM ** -0.5
    out, m, l = fa.flash_attention_plain(q, k, v, None, sm, (-1, -1), stats=True)
    qs, L, delta = fab.backward_preamble(q, out, m, l, do, sm)
    before = dict(fab.LAUNCHES)

    def launch(qs=qs, k=k, v=v, do=do, L=L, delta=delta):
        return fab._launch(qs, k, v, do, L, delta, None, sm, (-1, -1), True, True)

    strided = torch.cat([k, k], dim=2)[:, :, ::2]  # non-contiguous rows
    shifted = torch.cat([k, k], dim=2).view(-1)[1:1 + k.numel()].view(k.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    for bad in (dict(k=strided), dict(v=shifted), dict(do=shifted[:, :, :130]),
                dict(L=torch.cat([L, L], dim=2)[:, :, 1:1 + L.shape[2]])):
        with pytest.raises(ValueError):
            launch(**bad)
    assert fab.LAUNCHES == before
    launch()  # the aligned tensors do launch
    torch.cuda.synchronize()


def test_flash_kernel_rejects_what_it_cannot_take(dev):
    q, k, v, _ = _head_major(dev, 1, 2, 128, 128)
    with pytest.raises(ValueError):
        fa.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):  # head_dim 64
        fa.flash_attention(q[..., :64].contiguous(), k[..., :64].contiguous(),
                           v[..., :64].contiguous())


# ---------------------------------------------------------------------------
# the fused RoPE flavor's int8 variant and the linear_rstat GEMM
# ---------------------------------------------------------------------------

def test_int8_wgmma_layout(dev):
    """The int8 flavor's s8 product form on integer codes read through the
    flat int8 tensor map at head 1 of 2: A Bᵀ as wgmma m64n128k32 s8 x s8 ->
    s32 with A as register fragments from 128-byte swizzled code rows, B
    K-major, accumulators started from the fp32 bias whose subtraction gives
    float(s32); exact. The tensor has 100 rows: rows 100..127 of the tiles
    must read as zeros."""
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (1, 100, 256), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (1, 100, 256), generator=g, dtype=torch.int8)
    (c,) = fa.fused_layout_check(a.to(dev), b.to(dev), h=1)
    torch.cuda.synchronize()
    at, bt = torch.zeros(128, 128, dtype=torch.int64), torch.zeros(128, 128, dtype=torch.int64)
    at[:100], bt[:100] = a[0, :, 128:].long(), b[0, :, 128:].long()
    assert torch.equal(c.cpu().double(), (at @ bt.T).double())


@pytest.mark.parametrize("case", FUSED_CASES)
def test_int8_flavor_at_tile_edges(dev, case):
    """The int8 flavor against its plain version and within the int8
    envelope of the exact bf16 kernel (<= 3 % of max, correlation > 0.999)
    at shapes that straddle its tiles; k_len 0 writes zeros; a rerun is
    bit-identical."""
    B, N, Sq, Skv, window, k_lens = case
    q, k, v, rq, rk, gq, gk, ci, si = _fused_inputs(dev, B, N, Sq, Skv, seed=4)
    kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device=dev)
    kw = dict(num_heads=N, window_size=window, k_lens=kl, int8_score=True)
    before = fa.LAUNCHES["fused_rope_rms_attention_int8"]
    got = fa.fused_attention(q, k, v, rq, rk, gq, gk, ci, si, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["fused_rope_rms_attention_int8"] == before + 1
    ref = fa.fused_attention_plain(q, k, v, rq, rk, gq, gk, ci, si, **kw)
    err, mx = _err(got, ref)
    assert err <= BF16_BAR * mx, (err, mx)
    exact = fa.fused_attention(q, k, v, rq, rk, gq, gk, ci, si,
                               **{**kw, "int8_score": False}).float()
    err, mx = _err(got, exact)
    assert err <= 0.03 * mx, (err, mx)
    corr = torch.corrcoef(torch.stack([got.float().flatten(), exact.flatten()]))[0, 1]
    assert corr.item() > 0.999
    for b_, n_ in enumerate(k_lens or ()):
        if n_ == 0:
            assert got[b_].abs().max().item() == 0.0
    assert torch.equal(got, fa.fused_attention(q, k, v, rq, rk, gq, gk, ci, si, **kw))


@pytest.mark.parametrize("S,window,k_lens", [(520, (-1, -1), None), (333, (-1, -1), None),
                                             (520, (64, 32), (300, 0))])
def test_int8_flavor_matches_plain(dev, S, window, k_lens):
    q, k, v, gq, gk, cos, sin, N = _inputs(dev, S=S, seed=3)
    rq, rk, gqv, gkv = _stats(q, k, gq, gk)
    ci, si = fa.prepare_fused_rope_tables(cos, sin)
    kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device=dev)
    kw = dict(num_heads=N, window_size=window, k_lens=kl, int8_score=True)
    before = dict(fa.LAUNCHES)
    got = fa.fused_attention(q, k, v, rq, rk, gqv, gkv, ci, si, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["fused_rope_rms_attention_int8"] == before["fused_rope_rms_attention_int8"] + 1
    assert fa.LAUNCHES["fused_rope_rms_attention"] == before["fused_rope_rms_attention"]
    ref = fa.fused_attention_plain(q, k, v, rq, rk, gqv, gkv, ci, si, **kw)
    err, mx = _err(got, ref)
    assert err <= BF16_BAR * mx, (err, mx)
    if k_lens is not None:  # a batch element that sees no key writes zeros
        assert got[1].abs().max().item() == 0.0
    # no atomics: a second run is bit-identical
    assert torch.equal(got, fa.fused_attention(q, k, v, rq, rk, gqv, gkv, ci, si, **kw))


def test_int8_flavor_rejects_what_it_cannot_take(dev):
    q, k, v, gq, gk, cos, sin, N = _inputs(dev, S=128)
    with pytest.raises(ValueError):
        fa.fused_rope_rms_attention(q.float(), k.float(), v.float(), cos, sin, gq, gk,
                                    num_heads=N, int8_score=True)
    with pytest.raises(ValueError):  # head_dim 64
        fa.fused_rope_rms_attention(q, k, v, cos[:, :16], sin[:, :16], gq, gk,
                                    num_heads=2 * N, int8_score=True)


def _rstat_inputs(dev, M, K=256, N=384, bias=True, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((M, K)), dtype=torch.float32,
                        device=dev).to(torch.bfloat16)
    p = {"kernel": torch.as_tensor(rng.standard_normal((K, N)) * 0.1,
                                   dtype=torch.float32, device=dev).to(torch.bfloat16)}
    if bias:
        p["bias"] = torch.as_tensor(rng.standard_normal(N) * 0.1, dtype=torch.float32,
                                    device=dev).to(torch.bfloat16)
    return x, p


@pytest.mark.parametrize("M,K,N", [(333, 256, 384), (128, 256, 384), (1, 256, 384),
                                   (333, 5120, 5120)])
@pytest.mark.parametrize("bias", [True, False])
def test_linear_rstat_matches_plain(dev, M, K, N, bias):
    """N = 384 ends in a 128-wide tile after a 256-wide one; 5120 is the
    Wan2.1-14B width (twenty 256-wide tiles, 80 K slices)."""
    from versecrafter_tpu_torch.kernels import matmul_stat as ms
    x, p = _rstat_inputs(dev, M, K, N, bias=bias)
    before = ms.LAUNCHES["linear_rstat"]
    y, rs = ms.linear_rstat(p, x[None], 1e-6)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["linear_rstat"] == before + 1
    assert y.shape == (1, M, N) and rs.shape == (1, M, 1) and rs.dtype == torch.float32
    ry, rrs = ms.linear_rstat_plain(x, p["kernel"], p.get("bias"), 1e-6)
    err, mx = _err(y[0], ry)
    assert err <= BF16_BAR * mx, (err, mx)
    assert ((rs[0] - rrs).abs() / rrs.abs()).max().item() <= 1e-4
    # no atomics: a second run is bit-identical
    y2, rs2 = ms.linear_rstat(p, x[None], 1e-6)
    assert torch.equal(y, y2) and torch.equal(rs, rs2)


def test_linear_rstat_back_to_back_launches_agree(dev):
    """Twenty launches queued without a host sync between them at M = 65,520,
    K = N = 1536 (the CFG-2 q/k projection): every output equals the first
    bit for bit and holds the plain version's bars."""
    from versecrafter_tpu_torch.kernels import matmul_stat as ms
    x, p = _rstat_inputs(dev, 65520, 1536, 1536)
    outs = [ms.linear_rstat(p, x, 1e-6) for _ in range(20)]
    torch.cuda.synchronize()
    assert all(torch.equal(y, outs[0][0]) and torch.equal(rs, outs[0][1]) for y, rs in outs)
    ry, rrs = ms.linear_rstat_plain(x, p["kernel"], p["bias"], 1e-6)
    err, mx = _err(outs[0][0], ry)
    assert err <= BF16_BAR * mx, (err, mx)
    assert ((outs[0][1] - rrs).abs() / rrs.abs()).max().item() <= 1e-4


def test_linear_rstat_rejects_what_it_cannot_take(dev):
    from versecrafter_tpu_torch.kernels import matmul_stat as ms
    x, p = _rstat_inputs(dev, 64)
    with pytest.raises(ValueError):  # fp32 activations
        ms.linear_rstat(p, x.float())
    with pytest.raises(ValueError):  # K not a multiple of 64
        ms.linear_rstat({"kernel": p["kernel"][:200]}, x[:, :200].contiguous())
    with pytest.raises(ValueError):  # K a multiple of 32 but not of 64
        ms.linear_rstat({"kernel": p["kernel"][:224]}, x[:, :224].contiguous())
    with pytest.raises(ValueError):  # N not a multiple of 128
        ms.linear_rstat({"kernel": p["kernel"][:, :100].contiguous()}, x)
    with pytest.raises(ValueError):  # not 16-byte aligned
        ms.linear_rstat(p, x.view(-1)[1:1 + 63 * 256].view(63, 256))


@pytest.mark.parametrize("rows", [1, 9, 17, 300])
@pytest.mark.parametrize("K,N", [(256, 384), (12, 20)])
@pytest.mark.parametrize("bits,static", [(8, False), (8, True), (4, False)])
def test_int8_compute_dot_on_the_card_matches_the_cpu(dev, monkeypatch, rows, K, N, bits,
                                                     static):
    """The W8A8 / W4A8 product (utils/quantize.int8_compute_dot) on the card
    equals the CPU's bit for bit, also where torch._int_mm's shape minimum
    (> 16 rows, K and N multiples of 8) makes the wrapper pad."""
    from versecrafter_tpu_torch.utils import quantize as qz

    monkeypatch.setattr(qz, "MIN_SIZE", 1)

    rng = np.random.default_rng(rows + K)
    w = torch.as_tensor(rng.standard_normal((K, N)), dtype=torch.float32).to(torch.bfloat16)
    x = torch.as_tensor(rng.standard_normal((2, rows, K)), dtype=torch.float32).to(torch.bfloat16)
    scales = {"ffn_in/kernel": 0.02} if static else None
    tree = qz.tag_int8_compute(qz.quantize_tree({"ffn_in": {"kernel": w}}, bits,
                                                0 if bits == 4 else None), scales)
    leaf = tree["ffn_in"]["kernel"]
    assert qz.is_compute_tagged(leaf)
    got = qz.int8_compute_dot({k: v.to(dev) for k, v in leaf.items()}, x.to(dev))
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), qz.int8_compute_dot(leaf, x))
