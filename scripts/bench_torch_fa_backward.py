#!/usr/bin/env python3
"""Time the port's FA2 backward kernels (dQ, dK/dV) alone on one GPU.

    python3 scripts/bench_torch_fa_backward.py [--reps 10] [--heads 12] [--no-check]

Builds csrc/flash_attention_bwd.cu, holds both kernels to their plain
version at a small ragged shape, then times them with CUDA events at the
training path's shapes (self 32,760 x 32,760 and cross 32,760 x 512, batch
1) and prints one JSON line with the card's name and power limit. Used to
compare variants of the kernels (ring depth, tile shapes) inside one call
(--no-check for a variant whose arithmetic is stubbed to find a limiter);
chip_smoke.py stays the source of the numbers PERF.md's table reports.
"""

import argparse
import json
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--no-check", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from versecrafter_tpu_torch.kernels import flash_attention as fa
    from versecrafter_tpu_torch.kernels import flash_attention_bwd as fab

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sm = fa.HEAD_DIM ** -0.5
    result = {"card": card}
    for label, Sq, Skv, timed in (("check", 321, 193, False), ("self", 32760, 32760, True),
                                  ("cross", 32760, 512, True)):
        N = args.heads if timed else 2
        g = torch.Generator(device=dev).manual_seed(0)
        q = (2.0 * torch.randn(1, N, Sq, 128, generator=g, device=dev)).bfloat16()
        k, v = (torch.randn(1, N, Skv, 128, generator=g, device=dev).bfloat16()
                for _ in range(2))
        do = torch.randn(1, N, Sq, 128, generator=g, device=dev).bfloat16()
        out, m, l = fa._fa_forward(q, k, v, None, sm, (-1, -1), True)
        qs, L, delta = fab.backward_preamble(q, out, m, l, do, sm)
        if not timed and args.no_check:
            continue
        if not timed:
            got = fab._launch(qs, k, v, do, L, delta, None, sm, (-1, -1), True, True)
            ref = fab.fa_backward_plain(qs, k, v, do, L, delta, None, sm, (-1, -1))
            for a, b in zip(got, ref):
                err = (a.float() - b.float()).abs().max().item()
                if not err <= 2 * 2.0 ** -8 * b.float().abs().max().item():
                    raise AssertionError(f"kernel disagrees with its plain version: {err}")
            continue
        result[f"{label}_dq_ms"] = cuda_ms(lambda: fab._launch(
            qs, k, v, do, L, delta, None, sm, (-1, -1), True, False), args.reps)
        result[f"{label}_dkv_ms"] = cuda_ms(lambda: fab._launch(
            qs, k, v, do, L, delta, None, sm, (-1, -1), False, True), args.reps)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
