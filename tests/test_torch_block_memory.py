"""The unchunked FFN's hidden does not live through the block's fp32
residual update (models/wan_dit.py, wan_block_forward): measured on the
CPU from torch.profiler's memory events at a narrow width."""

import torch
from torch.profiler import ProfilerActivity, profile

from versecrafter_tpu_torch.core.config import WanDiTConfig
from versecrafter_tpu_torch.kernels.flash_attention import prepare_fused_rope_tables
from versecrafter_tpu_torch.models import wan_dit as twan

CFG = WanDiTConfig(in_dim=4, dim=64, ffn_dim=256, freq_dim=32, text_dim=32, out_dim=4,
                   num_heads=2, num_layers=1, text_len=16)
ROWS = 4096


def _residual_peak(fn):
    """(fn's output, the most bytes live at once after its last matmul,
    the FFN's out-projection: the residual update's window)."""
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        out = fn()
    evs = sorted(prof.profiler.kineto_results.events(), key=lambda e: e.start_ns())
    last = max(e.end_ns() for e in evs if e.name() == "aten::matmul")
    live = peak = 0
    for e in evs:
        if e.name() == "[memory]":
            live += e.nbytes()
            if e.start_ns() > last:
                peak = max(peak, live)
    return out, peak


def test_ffn_hidden_released_before_the_residual(monkeypatch):
    """Keeping the hidden alive (a reference held to each GELU output)
    raises the residual window's peak by exactly one [rows, ffn_dim] bf16
    tensor over the block as written; the outputs are bit-identical."""
    assert ROWS <= twan.FFN_CHUNK_ROWS  # the unchunked branch
    g = torch.Generator().manual_seed(0)
    p = twan.init_wan_dit(CFG, g, dtype=torch.bfloat16)["blocks"][0]
    x = torch.randn(1, ROWS, CFG.dim, generator=g).to(torch.bfloat16)
    e0 = torch.randn(1, 6, CFG.dim, generator=g) * 0.1
    ang = torch.rand(ROWS, CFG.head_dim // 2, generator=g) * 6
    cos, sin = torch.cos(ang), torch.sin(ang)
    ctx = torch.randn(1, CFG.text_len, CFG.dim, generator=g).to(torch.bfloat16)
    rope_i = prepare_fused_rope_tables(cos, sin)

    def block():
        return twan.wan_block_forward(p, CFG, x, e0, cos, sin, ctx, rope_i)

    out, peak = _residual_peak(block)
    kept = []
    gelu = twan._gelu_tanh
    monkeypatch.setattr(twan, "_gelu_tanh", lambda t: kept.append(gelu(t)) or kept[-1])
    out_kept, peak_kept = _residual_peak(block)
    assert torch.equal(out, out_kept)
    assert kept[0].shape == (1, ROWS, CFG.ffn_dim) and kept[0].dtype == torch.bfloat16
    assert peak_kept - peak == ROWS * CFG.ffn_dim * 2
