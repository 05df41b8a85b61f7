"""The width-sharded VAE's per-shard math on one process: an op of
models/vae.py on a shard's slice of a whole tensor, its halo columns (and
the attention block's whole frame) taken from that tensor by a stand-in for
parallel/sharding.WidthShard, equals the matching slice of the op on the
whole tensor, for every shard of 4. The exchange itself runs in the gloo
worlds of tests/test_torch_parallel.py. fp32, within 1e-5 * max."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from versecrafter_tpu_torch.models import vae as tvae

SHARDS = 4


class SliceShard:
    """Shard `index` of `count` whose neighbours' columns come from the
    whole tensors `wholes`, one per halo / gather call in call order (each
    call's x must be that whole's slice, up to the rounding of an op on a
    slice)."""

    def __init__(self, wholes, index, count):
        self.wholes, self.index, self.count = list(wholes), index, count

    def _whole(self, x):
        whole = self.wholes.pop(0)
        w = x.shape[4]
        lo = self.index * w
        torch.testing.assert_close(x, whole[..., lo:lo + w], rtol=1e-6, atol=1e-6)
        return whole, lo, w

    def halo(self, x, left, right):
        whole, lo, w = self._whole(x)
        return F.pad(whole, (left, right))[..., lo:lo + w + left + right]

    def gather(self, x):
        return self._whole(x)[0]


def _conv(g, cout, cin, k):
    return {"kernel": torch.randn((cout, cin, *k), generator=g) / np.sqrt(cin * np.prod(k)),
            "bias": torch.randn((cout,), generator=g) * 0.1}


def _case(name, g, x):
    """(op(x, width), the whole tensors its halo / gather calls see)."""
    c = x.shape[1]
    if name == "conv":
        p = _conv(g, 6, c, (3, 3, 3))
        return lambda t, w: tvae.causal_conv3d(t, p["kernel"], p["bias"], width=w), [x]
    if name == "downsample":
        p = {"conv": _conv(g, c, c, (3, 3)), "time_conv": _conv(g, c, c, (3, 1, 1))}
        return lambda t, w: tvae._downsample(p, t, temporal=True, width=w), [x]
    if name == "upsample":
        p = {"conv": _conv(g, c // 2, c, (3, 3))}
        up = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
        return lambda t, w: tvae._upsample(p, t, temporal=False, width=w), [up]
    p = {"norm": {"gamma": 1.0 + 0.1 * torch.randn((c,), generator=g)},
         "qkv": {"kernel": torch.randn((c, 3 * c), generator=g) / np.sqrt(c),
                 "bias": torch.randn((3 * c,), generator=g) * 0.1},
         "proj": {"kernel": torch.randn((c, c), generator=g) / np.sqrt(c),
                  "bias": torch.randn((c,), generator=g) * 0.1}}
    return (lambda t, w: tvae._attn_block(p, t, width=w),
            [tvae.channel_rms_norm(x, p["norm"]["gamma"])])


@pytest.mark.parametrize("name", ["conv", "downsample", "upsample", "attention"])
def test_shard_math_equals_whole_slice(name):
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 8, 3, 5, 16), generator=g)
    op, wholes = _case(name, g, x)
    want = op(x, None)
    wo = want.shape[4] // SHARDS
    for i in range(SHARDS):
        xs = x[..., i * 4:(i + 1) * 4]
        shard = SliceShard(wholes, i, SHARDS)
        got = op(xs, shard)
        assert not shard.wholes, "every halo / gather call was made"
        ref = want[..., i * wo:(i + 1) * wo]
        assert got.shape == ref.shape
        assert (got - ref).abs().max() <= 1e-5 * want.abs().max(), (name, i)


@pytest.mark.parametrize("shape", [(3, 384, 5, 3), (1, 384, 5, 4)])
def test_bf16_conv_on_the_cpu_reads_only_its_input(shape):
    """The stride-2 3x3 downsample conv in bf16 at the small widths a
    width-sharded test-size encode gives it, with tensors of 1000.0 alive
    around it (PyTorch's CPU bf16 convolution reads outside its input
    there): conv2d_spatial equals the fp32 convolution of the same bf16
    operands rounded once, in every one of 30 calls."""
    torch.manual_seed(0)
    kept = []
    b, c, h, w = shape
    for _ in range(30):
        x = torch.randn(b, c, 1, h, w).to(torch.bfloat16)
        k = torch.randn(c, c, 3, 3) * 0.02
        got = tvae.conv2d_spatial(x, k, None, stride=2)
        ref = F.conv2d(x[:, :, 0].float(), k.to(torch.bfloat16).float(), stride=2,
                       padding=1).to(torch.bfloat16)
        torch.testing.assert_close(got[:, :, 0], ref, rtol=0, atol=0)
        kept.append(torch.full((int(torch.randint(1, 20000, (1,))),), 1000.0,
                               dtype=torch.bfloat16))
