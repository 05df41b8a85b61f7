#!/usr/bin/env python3
"""Time the port's plain flash-attention forward kernel alone on one GPU.

    python3 scripts/bench_torch_flash_forward.py [--reps 10] [--heads 12] [--ptxas] [--no-check]

Builds csrc/flash_attention.cu, holds both flavors (the training forward
that writes the row statistics m and l, and the exp2 inference flavor) to
their plain version at shapes that straddle the kernel's 128-row tiles, with
k_lens holding a 0 and windows, and checks that a rerun is bit-identical.
Then it times both flavors with CUDA events at the training path's shapes
(batch 1, 12 heads, 32,760 q rows; 32,760 or 512 keys) beside SDPA on the
same head-major tensors (a yardstick the port never calls) and prints one
JSON line with the card's name and power limit. --ptxas first prints
ptxas's registers and spills of every kernel of the source and its
warnings. Used to compare variants of the kernel inside one call: copy
versecrafter_tpu_torch/ and scripts/ elsewhere, edit the copy's .cu and run
the copy's script in the same call (--no-check for a variant whose
arithmetic is stubbed). chip_smoke.py stays the source of the numbers
PERF.md's table reports.
"""

import argparse
import json
import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES = [  # (B, N, Sq, Skv, window, k_lens)
    (1, 2, 193, 321, (-1, -1), None),
    (2, 2, 129, 64, (-1, -1), (64, 0)),
    (1, 2, 200, 40, (-1, -1), None),
    (1, 2, 384, 384, (64, 32), None),
    (2, 2, 333, 333, (100, 27), (333, 150)),
]


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


def head_major(B, N, Sq, Skv, seed, dev, hd=128):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (2.0 * torch.randn(B, N, Sq, hd, generator=g, device=dev)).bfloat16()
    k, v = (torch.randn(B, N, Skv, hd, generator=g, device=dev).bfloat16() for _ in range(2))
    return q, k, v


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
        report = _build.ptxas_report("flash_attention")
        for name, res in _build.ptxas_kernels(report).items():
            print(f"ptxas {name}: {res}", flush=True)
        for line in report.splitlines():
            if "warning" in line:
                print(line, flush=True)
    sm = fa.HEAD_DIM ** -0.5
    result = {"card": card}
    if not args.no_check:
        for B, N, Sq, Skv, window, k_lens in CASES:
            q, k, v = head_major(B, N, Sq, Skv, 0, dev)
            kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device=dev)
            for stats in (True, False):
                got = fa._fa_launch(q, k, v, kl, sm, window, stats)
                again = fa._fa_launch(q, k, v, kl, sm, window, stats)
                ref = fa.flash_attention_plain(q, k, v, kl, sm, window, stats=stats)
                got, again, ref = ((x,) if not stats else x for x in (got, again, ref))
                err = (got[0].float() - ref[0].float()).abs().max().item()
                bar = 2 * 2.0 ** -8 * ref[0].float().abs().max().item()
                ok = math.isfinite(err) and err <= bar and all(
                    torch.equal(a, b) for a, b in zip(got, again))
                msg = ""
                if stats:
                    seen = ref[2] > 0
                    m_err = (got[1][seen] - ref[1][seen]).abs().max().item() if seen.any() else 0.0
                    l_rel = ((got[2] - ref[2]).abs() / ref[2].clamp_min(1e-30)).max().item()
                    ok = ok and torch.equal(got[2] > 0, seen) and m_err <= 1e-4 and l_rel <= 1e-4
                    msg = f", m err {m_err:.3g}, l rel err {l_rel:.3g}"
                print(f"check {B}x{N}x{Sq}x{Skv} window={window} k_lens={k_lens} "
                      f"stats={stats}: max_abs_err {err:.4g} (bar {bar:.4g}){msg}, "
                      f"rerun identical {ok}", flush=True)
                if not ok:
                    raise AssertionError("the kernel disagrees with its plain version")
    N = args.heads
    for label, Skv in (("self", 32760), ("cross", 512)):
        q, k, v = head_major(1, N, 32760, Skv, 1, dev)
        for stats in (True, False):
            key = f"{label}_{'stats' if stats else 'exp2'}_ms"
            result[key] = cuda_ms(lambda: fa._fa_launch(q, k, v, None, sm, (-1, -1), stats),
                                  args.reps)
        result[f"{label}_sdpa_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=sm),
            args.reps)
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
