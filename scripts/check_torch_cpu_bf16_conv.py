#!/usr/bin/env python3
"""PyTorch's CPU bf16 conv2d at small spatial sizes against a float64
reference: the stride-2, 3x3 convolution of the VAE's downsample
(models/vae.conv2d_spatial) at shapes a width-sharded test-size encode
gives it. Between calls, tensors of 1000.0 are allocated and kept, so a
kernel that reads memory outside its input picks them up. Prints, per
dtype and input shape, how many of the calls were off by more than 5 % of
the reference's max, and the worst relative error.

    python scripts/check_torch_cpu_bf16_conv.py [--calls 200]
"""

import argparse

import torch
import torch.nn.functional as F

SHAPES = [(3, 384, 5, 3), (1, 384, 5, 3), (3, 384, 5, 4), (3, 96, 9, 5)]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--calls", type=int, default=200)
    args = p.parse_args()
    torch.set_num_threads(1)
    torch.manual_seed(0)
    kept = []
    print(f"torch {torch.__version__}")
    for dtype in (torch.float32, torch.bfloat16):
        for shape in SHAPES:
            wrong, worst = 0, 0.0
            for _ in range(args.calls):
                x = torch.randn(*shape)
                w = torch.randn(shape[1], shape[1], 3, 3) * 0.02
                y = F.conv2d(x.to(dtype), w.to(dtype), None, stride=2).double()
                ref = F.conv2d(x.to(dtype).double(), w.to(dtype).double(), None, stride=2)
                rel = ((y - ref).abs().max() / ref.abs().max()).item()
                worst = max(worst, rel)
                wrong += rel > 0.05
                kept.append(torch.full((int(torch.randint(1, 20000, (1,))),), 1000.0,
                                       dtype=dtype))
                if len(kept) > 200:
                    kept.pop(0)
            print(f"{str(dtype):15s} {str(shape):18s} wrong {wrong} of {args.calls}, "
                  f"worst relative error {worst:.3g}")


if __name__ == "__main__":
    main()
