#!/usr/bin/env python3
"""Time the port's fused qk-RMSNorm (+ RoPE) attention kernel alone on one GPU.

    python3 scripts/bench_torch_fused_attention.py [--reps 10] [--heads 12] [--ptxas] [--no-check]

Builds csrc/fused_attention.cu, holds the three flavors (RoPE
self-attention, norm-only cross-attention, and the int8-scored RoPE flavor)
to their plain version at ragged shapes that straddle the kernel's 128-row
tiles, with a k_lens + window case, checks that a rerun is bit-identical,
and holds the int8 flavor to the exact bf16 kernel (<= 3 % of max,
correlation > 0.999). Then it times the flavors with CUDA events at the
generate path's shapes (CFG batch 2, 12 heads, 32,760 q rows; 32,760 or 512
keys; int8 self beside bf16 self) beside SDPA on the pre-transformed q~/k~
(a yardstick the port never calls) and prints one JSON line with the card's
name and power limit.
--ptxas first prints ptxas's registers and spills of every kernel of the
source and its warnings. Used to compare variants of the kernel (ring depth,
tile shapes, schedules) inside one call: copy versecrafter_tpu_torch/ and
scripts/ elsewhere, edit the copy's .cu and run the copy's script in the same
call (--no-check for a variant whose arithmetic is stubbed to find a limiter).
chip_smoke.py stays the source of the numbers PERF.md's table reports.
"""

import argparse
import json
import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def inputs(fa, B, Sq, Skv, N, seed, dev):
    """Raw projections, statistics, norm scales and interleaved tables."""
    from versecrafter_tpu_torch.kernels.rope import grid_cos_sin, rope_3d_angles
    D = N * fa.HEAD_DIM
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, S, D, generator=g, device=dev).bfloat16()
               for S in (Sq, Skv, Skv))
    gq = 2.0 + 0.2 * torch.randn(D, generator=g, device=dev)  # peaked softmax rows
    gk = 1.0 + 0.1 * torch.randn(D, generator=g, device=dev)
    rows = max(Sq, Skv)
    cos, sin = grid_cos_sin(rope_3d_angles(fa.HEAD_DIM), -(-rows // (30 * 52)), 30, 52,
                            device=dev)
    rq, rk, gqv, gkv = fa._stats_and_scales(q, k, gq, gk, 1e-6, fa.HEAD_DIM ** -0.5)
    ci, si = fa.prepare_fused_rope_tables(cos[:rows], sin[:rows])
    return q, k, v, rq, rk, gqv, gkv, ci, si


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--no-check", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from versecrafter_tpu_torch.kernels import _build
    from versecrafter_tpu_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if args.ptxas:
        report = _build.ptxas_report("fused_attention")
        for name, res in _build.ptxas_kernels(report).items():
            print(f"ptxas {name}: {res}", flush=True)
        for line in report.splitlines():
            if "warning" in line:
                print(line, flush=True)
    result = {"card": card}
    if not args.no_check:
        for Sq, Skv, rope, int8, window, k_lens in (
                (333, 333, True, False, (-1, -1), None),
                (333, 333, True, False, (100, 27), (333, 0)),
                (333, 77, False, False, (-1, -1), None),
                (333, 333, True, True, (-1, -1), None),
                (193, 321, True, True, (100, 27), (321, 0))):
            q, k, v, rq, rk, gq, gk, ci, si = inputs(fa, 2, Sq, Skv, 2, 0, dev)
            tabs = (ci, si) if rope else (None, None)
            kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device=dev)
            kw = dict(num_heads=2, window_size=window, k_lens=kl, int8_score=int8)
            got = fa.fused_attention(q, k, v, rq, rk, gq, gk, *tabs, **kw)
            again = fa.fused_attention(q, k, v, rq, rk, gq, gk, *tabs, **kw)
            ref = fa.fused_attention_plain(q, k, v, rq, rk, gq, gk, *tabs, **kw)
            err = (got.float() - ref.float()).abs().max().item()
            bar = 2 * 2.0 ** -8 * ref.float().abs().max().item()
            ok = math.isfinite(err) and err <= bar and torch.equal(got, again)
            msg = ""
            if int8:  # the approximation against the exact bf16 kernel
                exact = fa.fused_attention(q, k, v, rq, rk, gq, gk, *tabs,
                                           **{**kw, "int8_score": False}).float()
                rel = (got.float() - exact).abs().max().item() / exact.abs().max().item()
                corr = torch.corrcoef(torch.stack([got.float().flatten(),
                                                   exact.flatten()]))[0, 1].item()
                ok = ok and rel <= 0.03 and corr > 0.999
                msg = f", vs bf16 kernel {rel:.4g} of max, correlation {corr:.6f}"
            print(f"check Sq={Sq} Skv={Skv} rope={rope} int8={int8} window={window} "
                  f"k_lens={k_lens}: max_abs_err {err:.4g} (bar {bar:.4g}){msg}, rerun "
                  f"identical {torch.equal(got, again)}", flush=True)
            if not ok:
                raise AssertionError("the kernel disagrees with its plain version")
    N = args.heads
    for label, Skv, rope in (("self", 32760, True), ("cross", 512, False)):
        q, k, v, rq, rk, gq, gk, ci, si = inputs(fa, 2, 32760, Skv, N, 1, dev)
        tabs = (ci, si) if rope else (None, None)
        result[f"{label}_ms"] = cuda_ms(
            lambda: fa.fused_attention(q, k, v, rq, rk, gq, gk, *tabs, num_heads=N), args.reps)
        if rope:
            result[f"{label}_int8_ms"] = cuda_ms(
                lambda: fa.fused_attention(q, k, v, rq, rk, gq, gk, *tabs, num_heads=N,
                                           int8_score=True), args.reps)
        qt = fa._qk_transform(q, rq, gq, *tabs, N).view(2, 32760, N, -1).transpose(1, 2)
        kt = fa._qk_transform(k, rk, gk, *tabs, N).view(2, Skv, N, -1).transpose(1, 2)
        vt = v.view(2, Skv, N, -1).transpose(1, 2)
        result[f"{label}_sdpa_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, scale=math.log(2.0)), args.reps)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
