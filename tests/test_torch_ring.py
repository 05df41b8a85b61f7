"""Port parity for the sequence-parallel attention: kernels/ring_attention.py
and parallel/sharding.py's Ulysses and dispatch, each gloo world of the port
(tests/torch_mesh.py, one launch per sp degree) against the jitted JAX
package on its virtual mesh: the ring's output and dq / dk / dv at sp 2 and
4, Ulysses, and the dispatch table with its window refusal. _merge and the
per-hop function run in this process. fp32, within 1e-4 * max."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tests.torch_mesh import run_world
from versecrafter_tpu.core.mesh import MeshSpec, make_mesh
from versecrafter_tpu.kernels.flash_attention import flash_attention_with_stats
from versecrafter_tpu.kernels.ring_attention import _merge as jmerge
from versecrafter_tpu.kernels.ring_attention import ring_attention as jring
from versecrafter_tpu.parallel import sharding as jshd
from versecrafter_tpu_torch.kernels import ring_attention as tring
from versecrafter_tpu_torch.kernels.flash_attention import attention_reference

BAR = 1e-4


def _qkv(b=1, n=2, s=64, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, n, s, d)).astype(np.float32) for _ in range(4))


def _rel_err(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(ref).max())


def test_merge_matches_jax():
    q, k, v, _ = _qkv()
    parts_j = [flash_attention_with_stats(q, k[:, :, a:b], v[:, :, a:b], impl="xla")
               for a, b in ((0, 24), (24, 64))]
    want = jmerge(*parts_j[0], *parts_j[1])
    got = tring._merge(*(torch.tensor(np.asarray(t)) for t in parts_j[0] + parts_j[1]))
    for g, w in zip(got, want):
        assert _rel_err(g.numpy(), w) <= 1e-6


def test_attend_shard_hops_make_full_attention():
    """attend_shard over the key shards in turn (the ring's hops on one
    device) is full attention."""
    q, k, v, _ = (torch.as_tensor(a) for a in _qkv(s=96))
    acc = None
    for i in range(0, 96, 32):
        acc = tring.attend_shard(q, k[:, :, i:i + 32], v[:, :, i:i + 32], acc)
    assert _rel_err(acc[0].numpy(), attention_reference(q, k, v).numpy()) <= BAR


def _jax_ring(sp, q, k, v, do):
    mesh = make_mesh(MeshSpec(sp=sp), devices=jax.devices()[:sp])
    spec = P(None, None, "sp", None)
    fn = shard_map(lambda a, b, c: jring(a, b, c, axis_name="sp"), mesh=mesh,
                   in_specs=(spec,) * 3, out_specs=spec, check_vma=False)
    o, vjp = jax.vjp(jax.jit(fn), q, k, v)
    return (o,) + tuple(vjp(jnp.asarray(do)))


def _jax_sp(sp, fn, q, k, v):
    mesh = make_mesh(MeshSpec(sp=sp), devices=jax.devices()[:sp])
    with jshd.mesh_context(mesh):
        return np.asarray(jax.jit(fn)(q, k, v))


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_ulysses_and_dispatch_match_jax(sp, tmp_path):
    """One launch per sp degree. Each rank's shards of the ring's output and
    gradients, of Ulysses' output and of the dispatch's output (2 heads:
    Ulysses at sp 2, the ring at sp 4) equal the JAX package's; at sp 4 a
    window on the ring path is refused with the JAX package's words."""
    ring = _qkv(n=2, seed=1)
    uly = _qkv(n=4, seed=2)
    disp = _qkv(n=2, seed=3)
    arrays = {}
    for name, t in (("ring", ring), ("uly", uly), ("disp", disp)):
        arrays.update({f"{name}.{s}": a for s, a in zip(("q", "k", "v", "do"), t)})
    cases = [{"kind": "ring", "name": "ring"}, {"kind": "ulysses", "name": "uly"},
             {"kind": "dispatch", "name": "disp"}]
    outs = run_world(sp, {"spec": [1, 1, sp, 1], "cases": cases}, arrays, tmp_path)

    def whole(key):
        return np.concatenate([o[key] for o in outs], axis=2)

    want = _jax_ring(sp, *ring)
    for key, w in zip(("o", "dq", "dk", "dv"), want):
        assert _rel_err(whole("ring." + key), w) <= BAR, key
    w_uly = _jax_sp(sp, lambda a, b, c: jshd.ulysses_attention(a, b, c), *uly[:3])
    assert _rel_err(whole("uly.o"), w_uly) <= BAR
    w_disp = _jax_sp(sp, lambda a, b, c: jshd.sequence_parallel_attention(a, b, c), *disp[:3])
    assert _rel_err(whole("disp.o"), w_disp) <= BAR
    ring_path = 2 % sp != 0
    for o in outs:
        assert int(o["disp.ring"]) == int(ring_path)
        assert int(o["disp.ulysses"]) == (0 if ring_path else 2)
    if ring_path:
        mesh = make_mesh(MeshSpec(sp=sp), devices=jax.devices()[:sp])
        with jshd.mesh_context(mesh), pytest.raises(NotImplementedError) as e:
            jshd.sequence_parallel_attention(*disp[:3], window_size=(4, 4))
        assert all(str(o["disp.refusal"]) == str(e.value) for o in outs)
    else:
        assert all(str(o["disp.refusal"]) == "" for o in outs)
