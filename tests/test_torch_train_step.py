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


@pytest.mark.parametrize("flags,raised", [
    (["--data_dir", "x"], SystemExit), (["--fsdp", "2"], ValueError),
    (["--dp", "2"], ValueError), (["--sp", "2"], ValueError),
    (["--attn_impl", "xla"], NotImplementedError)])
def test_cli_unported_options_raise(flags, raised, tmp_path):
    """--data_dir is ported and, as in the JAX CLI, needs --model_name to
    encode its clips; a mesh axis > 1 needs a world of its size (one
    process here: refused before the model is built; the gloo worlds are
    in test_torch_parallel.py); the port has one attention path."""
    with pytest.raises(raised):
        tcli.main(["--tiny", "--device", "cpu", "--output_dir", str(tmp_path), *flags])


def _clip_dir(d, seed):
    """A clip directory by the JAX CLI's contract: the target video, three
    of the four control maps (3D_gaussian_RGB.mp4 missing: zero-filled),
    the merged mask and a prompt."""
    from test_torch_video_io import _clip
    from versecrafter_tpu.utils import video as jvideo
    os.makedirs(d, exist_ok=True)
    names = ["video.mp4", "background_RGB.mp4", "background_depth.mp4",
             "3D_gaussian_depth.mp4", "merged_mask.mp4"]
    for i, name in enumerate(names):
        jvideo.save_video(_clip(7, 12, 20, seed + i), os.path.join(d, name), fps=16)
    with open(os.path.join(d, "prompt.txt"), "w") as f:
        f.write("a car drives left\n")


def test_data_dir_encode_clip_matches_jax(tmp_path, monkeypatch):
    """--data_dir's _encode_clip against the JAX CLI's on the tiny fp32
    pipelines: x0 and the prompt embedding within 1e-4 * max. Both CLIs
    encode the control latents in bf16 (encode_controls' default), where
    each package's VAE lies ~2 % * max from the fp32 encode (ROADMAP §3, the
    VAE in bf16): the fp32 encodes agree within 1e-4 * max, and the port's
    bf16 one is no farther from them than the JAX CLI's (x1.25). Each
    package reads the other's latent_cache_{h}x{w}x{n}.npz exactly; then
    two train steps of the CLI on a directory of a clip cached by the JAX
    package and a clip it encodes itself."""
    from test_torch_convert import DIR_CFG
    from test_torch_pipeline import pipes as make_pipes
    from versecrafter_tpu.cli import train as jcli
    from versecrafter_tpu_torch.core import convert as tconvert

    jp, tp = make_pipes.__wrapped__()
    h, w, n = 8, 8, 5
    for name in ("j", "t"):
        _clip_dir(str(tmp_path / name), seed=1)
    ref = jcli._encode_clip(jp, str(tmp_path / "j"), h, w, n)
    got = tcli._encode_clip(tp, str(tmp_path / "t"), h, w, n)
    for what, g, r in zip(("x0", "geo", "ctx"), got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype == np.float32, what
        if what != "geo":
            assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max(), what
    from versecrafter_tpu.utils.video import load_video
    clip = str(tmp_path / "j")
    controls = [load_video(os.path.join(clip, c), num_frames=n, size=(h, w))
                for c in ("background_RGB.mp4", "background_depth.mp4")]
    controls += [np.zeros_like(controls[0]),
                 load_video(os.path.join(clip, "3D_gaussian_depth.mp4"), num_frames=n,
                            size=(h, w))]
    mask = load_video(os.path.join(clip, "merged_mask.mp4"), num_frames=n, size=(h, w))[:, :1]
    geo32 = np.asarray(jp.encode_controls(controls, mask, dtype=jnp.float32)[0][0])
    geo32_t = tp.encode_controls(controls, mask, dtype=torch.float32)[0][0].numpy()
    scale = np.abs(geo32).max()
    assert np.abs(geo32_t - geo32).max() <= 1e-4 * scale
    assert np.abs(got[1] - geo32).max() <= 1.25 * np.abs(ref[1] - geo32).max()
    cache = f"latent_cache_{h}x{w}x{n}.npz"
    for reader, writer in ((jcli, "t"), (tcli, "j")):
        want = np.load(str(tmp_path / writer / cache))
        for g, key in zip(reader._encode_clip(None, str(tmp_path / writer), h, w, n),
                          ("x0", "geo", "ctx")):
            np.testing.assert_array_equal(g, want[key])

    # the CLI: clip "a" carries the JAX package's cache, clip "b" is encoded
    data = tmp_path / "data"
    os.makedirs(data / "a")
    import shutil
    shutil.copy(str(tmp_path / "j" / cache), str(data / "a" / cache))
    _clip_dir(str(data / "b"), seed=9)
    # the directory's GeoAdapter takes the tiny VAE's 20 control channels
    real = tconvert.load_versecrafter
    monkeypatch.setattr(tconvert, "load_versecrafter", lambda path, **kw: real(
        path, **{**kw, "geoada_in_dim": DIR_CFG.geoada_in_dim}))
    model = _tiny_model_dir(tmp_path / "model", monkeypatch)
    losses = tcli.main(["--data_dir", str(data), "--model_name", model, "--device", "cpu",
                        "--steps", "2", "--sample_size", f"{h},{w}", "--video_length", str(n),
                        "--output_dir", str(tmp_path / "out")])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert os.path.isfile(data / "b" / cache)
    assert os.path.isfile(tmp_path / "out" / "step_000002.pt")


def _tiny_model_dir(d, monkeypatch):
    """test_torch_convert's tiny reference-layout directory, with both
    packages' T5Config / VAEConfig pointed at the tiny configs."""
    import test_torch_convert as tc
    tc.tiny_text_and_vae.__wrapped__(monkeypatch)
    os.makedirs(d)
    return tc.model_dir.__wrapped__(type("F", (), {"mktemp": lambda self, name: d})())
