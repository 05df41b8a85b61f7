"""Port parity for the training slice: one flow-matching train step of the
port (make_train_step, GeoAdapter only, remat) against the jitted JAX
make_train_step on the CPU, the AdamW update against optax.adamw, the
attention launch count the card run asserts, and the train CLI."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from versecrafter_tpu.core.config import WanDiTConfig
from versecrafter_tpu.kernels.rope import grid_cos_sin, rope_3d_angles
from versecrafter_tpu.models.wan_dit import init_wan_dit
from versecrafter_tpu.parallel import train_step as jts
from versecrafter_tpu_torch.cli import train as tcli
from versecrafter_tpu_torch.core import config as tconfig
from versecrafter_tpu_torch.core.convert import params_from_jax
from versecrafter_tpu_torch.kernels import flash_attention as tfa
from versecrafter_tpu_torch.kernels import flash_attention_bwd as tfab
from versecrafter_tpu_torch.parallel import train_step as tts
from versecrafter_tpu_torch.utils import prng

# head_dim 128 as on the card; GeoAdapter every 2nd of 4 layers
CFG = WanDiTConfig(in_dim=4, dim=256, ffn_dim=256, freq_dim=32, text_dim=32,
                   out_dim=4, num_heads=2, num_layers=4, text_len=8,
                   geoada_layers=(), geoada_in_dim=8)
TCFG = tconfig.WanDiTConfig(**dataclasses.asdict(CFG))
LR = 1e-3


def _setup(seed=0):
    """JAX params (fp32) with the zero-init head, before_proj and after_proj
    randomised in numpy (else every GeoAdapter gradient is a vacuous zero),
    and a batch of inputs."""
    params = jax.tree.map(np.asarray, init_wan_dit(jax.random.key(seed), CFG, jnp.float32))
    rng = np.random.default_rng(seed + 1)
    for leaf in (params["head"]["head"], params["geoada_before_proj"],
                 params["geoada_blocks"]["after_proj"]):
        leaf["kernel"] = (rng.standard_normal(leaf["kernel"].shape) * 0.05).astype(np.float32)
    x0 = rng.standard_normal((1, 4, 2, 8, 8)).astype(np.float32)
    geo = rng.standard_normal((1, 8, 2, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 8, 32)).astype(np.float32)
    ang = tuple(jnp.asarray(a) for a in rope_3d_angles(CFG.head_dim, max_pos=16))
    cos, sin = (np.array(a) for a in grid_cos_sin(ang, 2, 4, 4))
    return params, (x0, ctx, cos, sin, geo)


def _flat(tree, prefix=""):
    """{path: array} of a nested dict/list tree (list index as a key)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def one_step():
    params, (x0, ctx, cos, sin, geo) = _setup()
    key = jax.random.key(3)
    train, frozen = jts.split_trainable(params)

    opt = optax.adamw(LR, weight_decay=1e-2)
    step = jax.jit(jts.make_train_step(CFG, opt))
    new_train, _, loss = step(train, frozen, opt.init(train), key, x0, ctx, cos, sin, geo)
    grads = jax.jit(jax.grad(lambda tr: jts.flow_matching_loss(
        {**frozen, **tr}, CFG, key, x0, ctx, cos, sin, geoada_context=geo)))(train)
    # the noise level and noise the JAX loss drew from its key
    k_sig, k_eps = jax.random.split(key)
    sig = np.asarray(jax.random.uniform(k_sig, (1,), jnp.float32))
    noise = np.asarray(jax.random.normal(k_eps, x0.shape, jnp.float32))

    tp = params_from_jax(params)
    ttrain, tfrozen = tts.split_trainable(tp)
    before = {k: v.clone() for k, v in _flat(tfrozen).items()}
    tstep = tts.make_train_step(TCFG, tts.make_optimizer(ttrain, LR, 1e-2))
    tloss = tstep(tp, *(torch.from_numpy(a) for a in (x0, ctx, cos, sin, geo)),
                  sig=torch.from_numpy(sig), noise=torch.from_numpy(noise))
    return dict(loss=float(loss), grads=params_from_jax(jax.tree.map(np.asarray, grads)),
                new_train=params_from_jax(jax.tree.map(np.asarray, new_train)),
                train=params_from_jax(train), tloss=float(tloss), ttrain=ttrain,
                tfrozen=tfrozen, frozen_before=before)


def test_loss_matches_jax(one_step):
    assert np.isfinite(one_step["tloss"])
    assert abs(one_step["tloss"] - one_step["loss"]) <= 1e-5 * abs(one_step["loss"])


def test_trainable_grads_match_jax(one_step):
    got = {k: v.grad for k, v in _flat(one_step["ttrain"]).items()}
    ref = _flat(one_step["grads"])
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        r = _np(r)
        assert got[k] is not None, k
        assert np.abs(_np(got[k]) - r).max() <= 1e-3 * np.abs(r).max() + 1e-12, k
    # the randomised GeoAdapter projections make the gradients non-vacuous
    assert np.abs(_np(got["/geoada_before_proj/kernel"])).max() > 0


def test_updated_params_match_jax(one_step):
    """Adam's first step moves each element by ~lr * sign(grad), so the two
    packages agree within 2*lr (an element whose gradient is ~0 may take
    either sign)."""
    got = _flat(one_step["ttrain"])
    ref = _flat(one_step["new_train"])
    old = _flat(one_step["train"])
    moved = 0
    for k, r in ref.items():
        assert np.abs(_np(got[k]) - _np(r)).max() <= 2 * LR, k
        moved += np.abs(_np(got[k]) - _np(old[k])).max() > 0
    assert moved == len(ref)  # every trainable leaf moved


def test_keyed_step_matches_jax():
    """A step given only a key draws the noise level and noise the JAX loss
    draws from the same key (fp32 normal within a few ulp of XLA's)."""
    params, (x0, ctx, cos, sin, geo) = _setup(seed=2)
    key = jax.random.key(5)
    train, frozen = jts.split_trainable(params)
    opt = optax.adamw(LR, weight_decay=1e-2)
    _, _, loss = jax.jit(jts.make_train_step(CFG, opt))(
        train, frozen, opt.init(train), key, x0, ctx, cos, sin, geo)
    tp = params_from_jax(params)
    ttrain, _ = tts.split_trainable(tp)
    tstep = tts.make_train_step(TCFG, tts.make_optimizer(ttrain, LR, 1e-2))
    tloss = tstep(tp, *(torch.from_numpy(a) for a in (x0, ctx, cos, sin, geo)),
                  key=prng.key(5))
    assert abs(float(tloss) - float(loss)) <= 1e-5 * abs(float(loss))
    sig, noise = tts.draw_noise(prng.key(5), torch.from_numpy(x0))
    k_sig, k_eps = jax.random.split(key)
    np.testing.assert_array_equal(sig.numpy(), np.asarray(
        jax.random.uniform(k_sig, (1,), jnp.float32)))
    ref = np.asarray(jax.random.normal(k_eps, x0.shape, jnp.float32))
    assert (np.abs(noise.numpy() - ref) <= 1e-5 * np.abs(ref)).all()


def test_step_without_key_or_noise_raises():
    params, (x0, ctx, cos, sin, geo) = _setup()
    tp = params_from_jax(params)
    ttrain, _ = tts.split_trainable(tp)
    step = tts.make_train_step(TCFG, tts.make_optimizer(ttrain))
    with pytest.raises(ValueError, match="key"):
        step(tp, *(torch.from_numpy(a) for a in (x0, ctx, cos, sin, geo)))


def test_frozen_params_untouched(one_step):
    for k, t in _flat(one_step["tfrozen"]).items():
        assert torch.equal(t, one_step["frozen_before"][k]), k
        assert t.grad is None and not t.requires_grad, k


def test_adamw_matches_optax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    opt = optax.adamw(1e-2, weight_decay=0.1)
    jp, state = tree, opt.init(tree)
    tp = {"a": torch.from_numpy(tree["a"].copy()).requires_grad_(),
          "b": {"c": torch.from_numpy(tree["b"]["c"].copy()).requires_grad_()}}
    topt = tts.make_optimizer(tp, 1e-2, 0.1)
    for _ in range(4):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
        updates, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        tp["a"].grad = torch.from_numpy(g["a"])
        tp["b"]["c"].grad = torch.from_numpy(g["b"]["c"])
        topt.step()
    for k, r in _flat(jp).items():
        np.testing.assert_allclose(_np(_flat(tp)[k]), np.asarray(r), rtol=1e-5, atol=1e-6)


def test_remat_changes_nothing_but_memory():
    params, (x0, ctx, cos, sin, geo) = _setup(seed=4)
    out = []
    for remat in (False, True):
        tp = params_from_jax(params)
        ttrain, _ = tts.split_trainable(tp)
        loss = tts.flow_matching_loss(
            tp, TCFG, *(torch.from_numpy(a) for a in (x0, ctx, cos, sin, geo)),
            torch.tensor([0.3]), torch.from_numpy(np.ones_like(x0)), remat=remat)
        loss.backward()
        out.append((loss.item(), [t.grad.clone() for t in tts.tree_leaves(ttrain)]))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_attention_launch_count_per_step(monkeypatch):
    """The count the card run asserts, checked here by counting the calls
    that launch a kernel on the card (the CPU runs their plain versions)."""
    counts = dict.fromkeys(tts.attention_launches_per_step(TCFG), 0)
    real_fused, real_fwd, real_bwd = tfa.fused_attention, tfa._fa_forward, tfab.fa_backward_plain

    def fused(*a, **kw):
        rope = len(a) > 7 and a[7] is not None
        counts["fused_rope_rms_attention" if rope else "fused_rms_cross_attention"] += 1
        return real_fused(*a, **kw)

    def fwd(*a, **kw):
        counts["flash_attention"] += 1
        return real_fwd(*a, **kw)

    def bwd(*a, **kw):
        counts["fa_backward_dq"] += bool(a[-2])
        counts["fa_backward_dkv"] += bool(a[-1])
        return real_bwd(*a, **kw)

    monkeypatch.setattr(tfa, "fused_attention", fused)
    monkeypatch.setattr(tfa, "_fa_forward", fwd)
    monkeypatch.setattr(tfab, "fa_backward_plain", bwd)
    params, (x0, ctx, cos, sin, geo) = _setup(seed=5)
    tp = params_from_jax(params)
    ttrain, _ = tts.split_trainable(tp)
    step = tts.make_train_step(TCFG, tts.make_optimizer(ttrain))
    step(tp, *(torch.from_numpy(a) for a in (x0, ctx, cos, sin, geo)), key=prng.key(0))
    assert counts == tts.attention_launches_per_step(TCFG)
    assert counts == {"fused_rope_rms_attention": 1, "fused_rms_cross_attention": 1,
                      "flash_attention": 20, "fa_backward_dq": 10, "fa_backward_dkv": 7}


def test_cli_trains_and_saves(tmp_path):
    losses = tcli.main(["--tiny", "--synthetic", "4", "--steps", "3", "--device", "cpu",
                        "--sample_size", "64,64", "--video_length", "9",
                        "--log_every", "1", "--output_dir", str(tmp_path)])
    assert len(losses) == 3 and all(np.isfinite(l) for l in losses)
    saved = torch.load(os.path.join(tmp_path, "step_000003.pt"))
    assert sorted(saved["params"]) == ["geoada_before_proj", "geoada_blocks",
                                       "geoada_patch_embedding"]


@pytest.mark.parametrize("flags", [["--data_dir", "x"], ["--fsdp", "2"],
                                   ["--lora_rank", "4"], ["--sp", "2"],
                                   ["--attn_impl", "xla"]])
def test_cli_unported_options_raise(flags, tmp_path):
    with pytest.raises(NotImplementedError):
        tcli.main(["--tiny", "--device", "cpu", "--output_dir", str(tmp_path), *flags])
