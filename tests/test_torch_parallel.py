"""Port parity for sharded training and serving: gloo worlds of the port
(tests/torch_mesh.py, one launch per MeshSpec) against the jitted JAX
package on its virtual mesh. One GeoAdapter train step under (dp=2,
fsdp=2): the loss, every trainable leaf's gradient and its update; and one
(sp=2, tp=2) world for a request through the sharded pipeline, where 2
heads put the ring on every self-attention, with TeaCache and cfg-skip (the
latents, every rank the JAX package's skip schedule, and its frames against
the unsharded request's), and for the width-sharded VAE's cases (encode and
decode, full and streaming, against the JAX pipeline's on a width-sharded
input; widths left whole). fp32, within 1e-4 * max."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_pipeline import DIT_CFG, T5_CFG, VAE_CFG, _inputs, _port
from test_torch_teacache import (SHIFT, SKIP_START, STEPS, THRESHOLD, _expected_schedule,
                                 _tea_run)
from tests.jax_prng import threefry_default  # noqa: F401
from tests.torch_mesh import flatten, run_world
from versecrafter_tpu.core.config import WanDiTConfig
from versecrafter_tpu.core.mesh import MeshSpec, make_mesh
from versecrafter_tpu.kernels.rope import grid_cos_sin, rope_3d_angles
from versecrafter_tpu.models.t5 import init_t5
from versecrafter_tpu.models.vae import init_vae
from versecrafter_tpu.models.wan_dit import init_wan_dit
from versecrafter_tpu.parallel import sharding as jshd
from versecrafter_tpu.parallel import train_step as jts
from versecrafter_tpu.sampling import pipeline as jpipe
from versecrafter_tpu_torch.core import config as tconfig
from versecrafter_tpu_torch.core.convert import params_from_jax
from versecrafter_tpu_torch.sampling import pipeline as tpipe
from versecrafter_tpu_torch.utils.tokenizer import HashTokenizer

BAR = 1e-4
LR = 1e-3
CFG = WanDiTConfig(in_dim=4, dim=64, ffn_dim=128, freq_dim=32, text_dim=48,
                   out_dim=4, num_heads=8, num_layers=4, text_len=16,
                   geoada_layers=(), geoada_in_dim=8)


def _rel_err(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(ref).max())


def _jax_leaf(tree, port_key):
    """The JAX leaf of a port path ("geoada_blocks/i/..." indexes the
    stacked leaf)."""
    parts = port_key.split("/")
    if parts[0] in ("blocks", "geoada_blocks"):
        i, rest = int(parts[1]), [parts[0]] + parts[2:]
    else:
        i, rest = None, parts
    leaf = tree
    for p in rest:
        leaf = leaf[p]
    return np.asarray(leaf if i is None else leaf[i])


def test_sharded_train_step_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    params = jax.tree.map(np.asarray, init_wan_dit(jax.random.key(0), CFG, jnp.float32))
    for leaf in (params["head"]["head"], params["geoada_before_proj"],
                 params["geoada_blocks"]["after_proj"]):
        leaf["kernel"] = (rng.standard_normal(leaf["kernel"].shape) * 0.05).astype(np.float32)
    x0 = rng.standard_normal((2, 4, 2, 8, 8)).astype(np.float32)
    geo = rng.standard_normal((2, 8, 2, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, 48)).astype(np.float32)
    ang = tuple(jnp.asarray(a) for a in rope_3d_angles(CFG.head_dim, max_pos=16))
    cos, sin = (np.asarray(a) for a in grid_cos_sin(ang, 2, 4, 4))
    seed = 3

    spec = MeshSpec(dp=2, fsdp=2)
    mesh = make_mesh(spec, devices=jax.devices()[:4])
    train, frozen = jts.split_trainable(jshd.shard_dit_params(
        jax.tree.map(jnp.asarray, params), mesh))
    opt = optax.adamw(LR, weight_decay=1e-2)
    key = jax.random.key(seed)
    with jshd.mesh_context(mesh):
        # make_train_step's value_and_grad and optax update, the gradients kept
        loss, grads = jax.jit(jax.value_and_grad(lambda tr: jts.flow_matching_loss(
            {**frozen, **tr}, CFG, key, x0, ctx, cos, sin, geoada_context=geo,
            attn_impl="sp")))(train)
    updates, _ = opt.update(grads, opt.init(train), train)
    new_train = optax.apply_updates(train, updates)

    arrays = {"tr.x0": x0, "tr.geo": geo, "tr.ctx": ctx, "tr.cos": cos, "tr.sin": sin,
              **flatten(params, "tr.params")}
    case = {"kind": "train", "name": "tr", "cfg": dataclasses.asdict(CFG), "lr": LR,
            "weight_decay": 1e-2, "seed": seed}
    outs = run_world(4, {"spec": list(spec.shape), "cases": [case]}, arrays, tmp_path)
    for out in outs:
        assert abs(float(out["tr.loss"][0]) - float(loss)) <= 1e-5 * abs(float(loss))
        leaves = [k for k in out if k.startswith("tr.train/")]
        # the two stacked GeoAdapter blocks are two lists entries in the port
        assert len(leaves) == sum(1 + k.startswith("geoada_blocks") for k in flatten(new_train))
        for k in leaves:
            path = k[len("tr.train/"):]
            g = _jax_leaf(grads, path)
            assert np.abs(out["tr.grad/" + path] - g).max() <= BAR * np.abs(g).max(), path
            # AdamW's first step moves each element by about LR: its update
            # (new - old) / LR against optax's where the gradient is well
            # above the packages' difference, the sign there included
            old = _jax_leaf(train, path)
            upd = (out[k] - old) / LR
            want = (_jax_leaf(new_train, path) - old) / LR
            sure = np.abs(g) > 1e-3 * np.abs(g).max()
            assert sure.mean() > 0.5, path
            assert np.abs(upd - want)[sure].max() <= 1e-3, path
            assert np.abs(upd - want).max() <= 2.0 + 1e-3, path
            np.testing.assert_array_equal(out[k], outs[0][k])


@pytest.fixture(scope="module")
def trees():
    """test_torch_pipeline's tiny fp32 trees (the DiT from key 0 with its
    head and GeoAdapter projections un-zeroed, the VAE from key 1, umT5
    from key 2); the VAE's init jitted, which takes a third of its eager
    time here."""
    dit = init_wan_dit(jax.random.key(0), DIT_CFG, jnp.float32)
    for i, path in enumerate((("head", "head"), ("geoada_before_proj",),
                              ("geoada_blocks", "after_proj"))):
        leaf = dit
        for key in path:
            leaf = leaf[key]
        leaf["kernel"] = jax.random.normal(jax.random.key(90 + i), leaf["kernel"].shape) * 0.05
    vae = jax.jit(lambda k: init_vae(k, VAE_CFG, jnp.float32))(jax.random.key(1))
    return types.SimpleNamespace(dit_params=dit, dit_cfg=DIT_CFG, vae_params=vae,
                                 t5_params=init_t5(jax.random.key(2), T5_CFG, jnp.float32))


RATIO = 0.34  # the request's cfg-skip ratio

# the width-sharded VAE's cases: (op, stream, input width) at 5 frames, 8
# rows; the tiny VAE halves the width once (its one stride-2 stage) and the
# width is cut over sp * tp = 4 ranks
VAE_CASES = {
    "encode": ("encode", False, 16), "decode": ("decode", False, 8),
    "encode_stream": ("encode", True, 16), "decode_stream": ("decode", True, 8),
    # 10 pixels / 5 latent columns do not divide over 4: whole on every rank
    "encode_uneven": ("encode", False, 10), "decode_uneven": ("decode", True, 5),
    # 12 pixels divide, but a shard's 3 columns go odd at the stride-2 stage
    "encode_odd_stage": ("encode", False, 12),
}


def _vae_ref(jm, op, stream, x):
    """The JAX pipeline's encode or decode (fp32 frames) of x on its mesh,
    the input width-sharded (shard_vae_io); through its streaming path when
    `stream`."""
    jm.VAE_STREAM_THRESHOLD = 100 if stream else jpipe.VerseCrafterPipeline.VAE_STREAM_THRESHOLD
    if op == "encode":
        return np.asarray(jm._vae_encode_fn()(jnp.asarray(x)))
    return jm.decode_latents(jnp.asarray(x))


@pytest.fixture(scope="module")
def sp2tp2(trees, tmp_path_factory):
    """One (sp=2, tp=2) world: the request (and its frames) and the VAE
    cases, beside the JAX package's results on the virtual mesh."""
    jp = trees
    calc = _expected_schedule(jp, RATIO)
    spec = MeshSpec(sp=2, tp=2)
    jm = jpipe.VerseCrafterPipeline(
        dit_params=jp.dit_params, dit_cfg=DIT_CFG, vae_params=jp.vae_params,
        vae_cfg=VAE_CFG, t5_params=jp.t5_params, t5_cfg=T5_CFG, scheduler_name="unipc",
        tokenizer=HashTokenizer(T5_CFG.vocab),
        mesh=make_mesh(spec, devices=jax.devices()[:4]))
    assert jm.attn_impl == "sp"
    jm.enable_teacache(THRESHOLD, SKIP_START)
    jm.enable_cfg_skip(RATIO)
    jm.teacache_debug = True
    ref = np.asarray(_tea_run(jm, jnp.float32))
    hist = [np.asarray(a) for a in jm.teacache_accum_history]

    controls, mask, noise = _inputs()
    arrays = {"req.control0": controls[0], "req.control1": controls[1], "req.mask": mask,
              "req.noise": noise}
    for name, tree in (("dit", jp.dit_params), ("vae", jp.vae_params), ("t5", jp.t5_params)):
        arrays.update(flatten(jax.tree.map(np.asarray, tree), f"req.{name}"))
    cfgs = {"dit_cfg": dataclasses.asdict(DIT_CFG), "vae_cfg": dataclasses.asdict(VAE_CFG),
            "t5_cfg": dataclasses.asdict(T5_CFG)}
    cases = [{"kind": "pipeline", "name": "req", **cfgs, "threshold": THRESHOLD,
              "skip_start": SKIP_START, "cfg_skip_ratio": RATIO, "steps": STEPS,
              "shift": SHIFT, "frames": True}]
    rng = np.random.default_rng(4)
    vae_refs = {}
    for name, (op, stream, w) in VAE_CASES.items():
        shape = (1, 3, 5, 8, w) if op == "encode" else (1, VAE_CFG.z_dim, 3, 4, w)
        x = (rng.random(shape) * 2 - 1 if op == "encode" else rng.standard_normal(shape))
        arrays[f"{name}.{'x' if op == 'encode' else 'z'}"] = x.astype(np.float32)
        cases.append({"kind": "vae", "name": name, "trees": "req", "op": op,
                      "stream": stream, **cfgs})
        vae_refs[name] = _vae_ref(jm, op, stream, x.astype(np.float32))
    tmp = tmp_path_factory.mktemp("sp2tp2")
    outs = run_world(4, {"spec": list(spec.shape), "cases": cases}, arrays, tmp)
    return types.SimpleNamespace(outs=outs, ref=ref, hist=hist, calc=calc, vae_refs=vae_refs)


def test_sharded_request_with_teacache_and_cfg_skip(sp2tp2):
    """(sp=2, tp=2) with batched CFG, TeaCache and cfg-skip 0.34: the JAX
    schedule (each decision 5 % clear of the threshold) on every rank, the
    blocks run once a calculated step and never on a skipped one, and the
    latents equal the JAX package's sharded pipeline's."""
    outs, ref, hist, calc = sp2tp2.outs, sp2tp2.ref, sp2tp2.hist, sp2tp2.calc
    assert len(hist) == STEPS
    for out in outs:
        assert _rel_err(out["req.latents"], ref) <= BAR
        acc = [out[f"req.accum/{i}"] for i in range(STEPS)]
        assert f"req.accum/{STEPS}" not in out
        for i in range(STEPS):
            np.testing.assert_array_equal(acc[i] == 0.0, hist[i] == 0.0, err_msg=f"step {i}")
            np.testing.assert_allclose(acc[i], hist[i], rtol=1e-5, atol=0)
            assert bool(np.all(acc[i] == 0.0)) == calc[i], i
            np.testing.assert_array_equal(acc[i], outs[0][f"req.accum/{i}"])
        assert int(out["req.blocks_runs"]) == sum(calc)
        np.testing.assert_array_equal(out["req.latents"], outs[0]["req.latents"])


def test_sharded_request_frames_equal_unsharded(sp2tp2, trees):
    """The sharded request's frames (its latents decoded on width slices,
    4 latent columns over 4 ranks) against the same request through the
    port's pipeline on one process, on every rank."""
    jp = trees
    to_t = lambda tree: params_from_jax(jax.tree.map(np.asarray, tree))
    tp = tpipe.VerseCrafterPipeline(
        dit_params=to_t(jp.dit_params), dit_cfg=_port(DIT_CFG, tconfig.WanDiTConfig),
        vae_params=to_t(jp.vae_params), vae_cfg=_port(VAE_CFG, tconfig.VAEConfig),
        t5_params=to_t(jp.t5_params), t5_cfg=_port(T5_CFG, tconfig.T5Config),
        scheduler_name="unipc", tokenizer=HashTokenizer(T5_CFG.vocab), device="cpu")
    tp.enable_teacache(THRESHOLD, SKIP_START)
    tp.enable_cfg_skip(RATIO)
    want = tp.decode_latents(_tea_run(tp, torch.float32))
    for out in sp2tp2.outs:
        assert out["req.frames_sharded"].tolist() == [True]
        got = out["req.frames"]
        assert got.shape == want.shape
        assert _rel_err(got, want) <= BAR


@pytest.mark.parametrize("name", list(VAE_CASES))
def test_width_sharded_vae_matches_jax(sp2tp2, name):
    """The pipeline's VAE encode / decode under (sp=2, tp=2) on every rank
    against the JAX pipeline's on its width-sharded input; run on width
    slices where the width divides over the 4 ranks (and, to encode, a
    slice stays even at the stride-2 stage), whole otherwise."""
    op, stream, w = VAE_CASES[name]
    sliced = w % 4 == 0 and (op == "decode" or (w // 4) % 2 == 0)
    want = sp2tp2.vae_refs[name]
    for out in sp2tp2.outs:
        assert out[name + ".sharded"].tolist() == [sliced]
        got = out[name + ".out"]
        assert got.shape == want.shape
        assert _rel_err(got, want) <= BAR, _rel_err(got, want)
        np.testing.assert_array_equal(got, sp2tp2.outs[0][name + ".out"])
