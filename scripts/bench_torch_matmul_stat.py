#!/usr/bin/env python3
"""Check and time the port's linear_rstat GEMM (csrc/matmul_stat.cu) alone on
one GPU, beside torch.addmm and addmm + the row statistic.

    python3 scripts/bench_torch_matmul_stat.py [--reps 20] [--ptxas] [--no-check]
    python3 scripts/bench_torch_matmul_stat.py --compare compare_parent [...]

Builds the kernel from the tree the script belongs to (or --tree), prints
ptxas's registers, spills and C7512 warnings with --ptxas, holds the kernel
to its plain version (y within 2*2^-8*max|y|, rs within 1e-4 relative) at
M = 333 and 1 with K = N = 1536 with and without bias, at K = N = 5120 and
at a 128-wide last N tile (K = 256, N = 384, on the CUDA tests' inputs),
requires twenty back-to-back launches at M = 65,520 to be bit-identical,
then times it with CUDA events
at the q/k projections' shapes (M = 65,520 and 32,760, K = N = 1536, with
bias) beside torch.addmm alone and addmm + the statistic, and prints one
JSON line with the card's name and power limit. --compare DIR runs the same
in fresh processes on the other trees (each holding a
versecrafter_tpu_torch/ with the same linear_rstat API, e.g. an unpacked
`git archive` of the parent) in the order DIR..., this tree, this tree,
...DIR, and prints every run's line and then a summary line; use it to hold
a parent or a variant against the change in one call. chip_smoke.py stays
the source of the numbers PERF.md's kernel table reports.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
BF16_BAR = 2 * 2.0 ** -8


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def run_tree(args) -> dict:
    import torch

    sys.path.insert(0, os.path.abspath(args.tree))
    from versecrafter_tpu_torch.kernels import _build
    from versecrafter_tpu_torch.kernels import matmul_stat as ms

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    result = {"tree": args.tree, "card": card_line()}
    if args.ptxas:
        report = _build.ptxas_report("matmul_stat")
        for name, res in _build.ptxas_kernels(report).items():
            print(f"ptxas {name}: {res}", flush=True)
        result["c7512"] = sum("C7512" in line for line in report.splitlines())

    def cuda_ms(fn):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    def inputs(M, K, N, bias, seed=0):
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
        p = {"kernel": (torch.randn(K, N, generator=g, device=dev) * K ** -0.5)
             .to(torch.bfloat16)}
        if bias:
            p["bias"] = (0.1 * torch.randn(N, generator=g, device=dev)).to(torch.bfloat16)
        return x, p

    def test_inputs(M, K, N, bias, seed=0):  # those of tests/test_torch_cuda_kernels.py
        rng = np.random.default_rng(seed)
        x = torch.as_tensor(rng.standard_normal((M, K)), dtype=torch.float32,
                            device=dev).to(torch.bfloat16)
        p = {"kernel": torch.as_tensor(rng.standard_normal((K, N)) * 0.1,
                                       dtype=torch.float32, device=dev).to(torch.bfloat16)}
        if bias:
            p["bias"] = torch.as_tensor(rng.standard_normal(N) * 0.1, dtype=torch.float32,
                                        device=dev).to(torch.bfloat16)
        return x, p

    if not args.no_check:
        for M, K, N, bias in ((333, 1536, 1536, True), (333, 1536, 1536, False),
                              (1, 1536, 1536, True), (333, 5120, 5120, True),
                              (333, 256, 384, True), (333, 256, 384, False)):
            x, p = (test_inputs if K == 256 else inputs)(M, K, N, bias)
            y, rs = ms.linear_rstat(p, x, 1e-6)
            ry, rrs = ms.linear_rstat_plain(x, p["kernel"], p.get("bias"), 1e-6)
            err = (y.float() - ry.float()).abs().max().item()
            rel = ((rs - rrs).abs() / rrs).max().item()
            if not (err <= BF16_BAR * ry.float().abs().max().item() and rel <= 1e-4):
                raise AssertionError(f"M={M} K={K} N={N} bias={bias}: y err {err}, "
                                     f"rs rel err {rel}")
        x, p = inputs(65520, 1536, 1536, True)
        outs = [ms.linear_rstat(p, x, 1e-6) for _ in range(20)]
        torch.cuda.synchronize()
        same = sum(torch.equal(y, outs[0][0]) and torch.equal(rs, outs[0][1])
                   for y, rs in outs)
        result["back_to_back_equal"] = same
        if same != 20:
            raise AssertionError(f"{same}/20 back-to-back launches equal the first")
        del x, p, outs

    for M in (65520, 32760):
        K = N = 1536
        x, p = inputs(M, K, N, True)
        w, b = p["kernel"], p["bias"]
        flops = 2 * M * K * N
        nbytes = (M * K + K * N + M * N) * 2 + N * 2 + M * 4
        result[f"M{M}_ms"] = cuda_ms(lambda: ms.linear_rstat(p, x, 1e-6))
        result[f"M{M}_addmm_ms"] = cuda_ms(lambda: torch.addmm(b, x, w))

        def library():  # addmm, then the statistic in torch: two calls
            y = torch.addmm(b, x, w)
            return torch.rsqrt(y.float().square().mean(-1, keepdim=True) + 1e-6)

        result[f"M{M}_addmm_stat_ms"] = cuda_ms(library)
        result[f"M{M}_bound_ms"] = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
        result[f"M{M}_tflops"] = flops / result[f"M{M}_ms"] / 1e9
        del x, p, w, b
        torch.cuda.empty_cache()
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--compare", nargs="*", default=[])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not args.compare:
        print(json.dumps(run_tree(args)), flush=True)
        return 0
    flags = [f"--reps={args.reps}"] + ["--ptxas"] * args.ptxas + ["--no-check"] * args.no_check
    order = list(args.compare) + [ROOT, ROOT] + list(reversed(args.compare))
    runs = []
    for tree in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), *flags,
                               f"--tree={tree}"], capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"{tree}: exit code {proc.returncode}", flush=True)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    summary = {"card": runs[0]["card"]}
    for run in runs:
        name = "change" if run["tree"] == ROOT else os.path.relpath(run["tree"], ROOT)
        for k, v in run.items():
            if k.endswith("_ms"):
                summary.setdefault(f"{name}:{k}", []).append(round(v, 4))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
