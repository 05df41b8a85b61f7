"""Port parity: the CLIP vision tower (models/clip.py) against the jitted
JAX functions on the same numpy inputs (CPU, fp32): the forward, both
checkpoint layouts' converter, OpenCV's bilinear resize in numpy, and
encode_image, also with cv2 blocked."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versecrafter_tpu.models import clip as jclip
from versecrafter_tpu_torch.core.convert import params_from_jax
from versecrafter_tpu_torch.models import clip as tclip

VITH_DEPTH2 = dict(jclip.VIT_HUGE_14, depth=2)


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got.float().numpy() - ref).max() / np.abs(ref).max())


def _to_port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def _assert_same_tree(got, ref, path="") -> None:
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            _assert_same_tree(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _assert_same_tree(a, b, f"{path}/{i}")
    else:
        ref = torch.from_numpy(np.asarray(ref, np.float32)).to(getattr(
            torch, np.asarray(ref).dtype.name))
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        assert torch.equal(got, ref), path


def test_constants_match_jax():
    assert tclip.VIT_HUGE_14 == jclip.VIT_HUGE_14 and tclip.TEST_TINY == jclip.TEST_TINY
    np.testing.assert_array_equal(tclip.CLIP_MEAN, jclip.CLIP_MEAN)
    np.testing.assert_array_equal(tclip.CLIP_STD, jclip.CLIP_STD)


@pytest.mark.parametrize("cfg", [jclip.TEST_TINY, VITH_DEPTH2, dict(jclip.TEST_TINY, post_norm=False)],
                         ids=["tiny", "vith_depth2", "tiny_no_post_norm"])
def test_forward_matches_jax(cfg):
    """Bar 1e-4 * max in fp32; ViT-H width (1280, 16 heads, 257 tokens) at
    depth 2."""
    params = jclip.init_clip_vision(jax.random.key(0), cfg)
    img = np.random.default_rng(0).standard_normal(
        (2, cfg["img_size"], cfg["img_size"], 3)).astype(np.float32)
    ref = jax.jit(lambda p, x: jclip.clip_vision_forward(p, cfg, x))(params, img)
    got = tclip.clip_vision_forward(_to_port(params), cfg, torch.from_numpy(img))
    assert tuple(got.shape) == ref.shape == (2, (cfg["img_size"] // 14) ** 2 + 1, cfg["dim"])
    assert _rel_err(got, ref) <= 1e-4


def test_init_matches_jax_tree():
    ref = _to_port(jclip.init_clip_vision(jax.random.key(0), jclip.TEST_TINY))
    got = tclip.init_clip_vision(jclip.TEST_TINY, torch.Generator().manual_seed(0))
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_r] == [p for p, _ in flat_g]
    for (path, a), (_, b) in zip(flat_r, flat_g):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), path


def _state_dict(layout, d=32, depth=2, p=14, img=56, seed=0):
    """A CLIP tower state dict in the HF CLIPVisionModel or the open-clip
    layout, random fp32 tensors."""
    g = torch.Generator().manual_seed(seed)
    n = (img // p) ** 2 + 1

    def r(*shape):
        return torch.randn(*shape, generator=g)

    if layout == "hf":
        sd = {"vision_model.embeddings.patch_embedding.weight": r(d, 3, p, p),
              "vision_model.embeddings.class_embedding": r(d),
              "vision_model.embeddings.position_embedding.weight": r(n, d)}
        for name in ("pre_layrnorm", "post_layernorm"):
            sd[f"vision_model.{name}.weight"], sd[f"vision_model.{name}.bias"] = r(d), r(d)
        for i in range(depth):
            b = f"vision_model.encoder.layers.{i}."
            for m in ("q", "k", "v", "out"):
                sd[f"{b}self_attn.{m}_proj.weight"], sd[f"{b}self_attn.{m}_proj.bias"] = \
                    r(d, d), r(d)
            for ln in ("layer_norm1", "layer_norm2"):
                sd[f"{b}{ln}.weight"], sd[f"{b}{ln}.bias"] = r(d), r(d)
            sd[f"{b}mlp.fc1.weight"], sd[f"{b}mlp.fc1.bias"] = r(4 * d, d), r(4 * d)
            sd[f"{b}mlp.fc2.weight"], sd[f"{b}mlp.fc2.bias"] = r(d, 4 * d), r(d)
        return sd
    sd = {"visual.conv1.weight": r(d, 3, p, p), "visual.class_embedding": r(d),
          "visual.positional_embedding": r(n, d)}
    for name in ("ln_pre", "ln_post"):
        sd[f"visual.{name}.weight"], sd[f"visual.{name}.bias"] = r(d), r(d)
    for i in range(depth):
        b = f"visual.transformer.resblocks.{i}."
        sd[f"{b}attn.in_proj_weight"], sd[f"{b}attn.in_proj_bias"] = r(3 * d, d), r(3 * d)
        sd[f"{b}attn.out_proj.weight"], sd[f"{b}attn.out_proj.bias"] = r(d, d), r(d)
        for ln in ("ln_1", "ln_2"):
            sd[f"{b}{ln}.weight"], sd[f"{b}{ln}.bias"] = r(d), r(d)
        sd[f"{b}mlp.c_fc.weight"], sd[f"{b}mlp.c_fc.bias"] = r(4 * d, d), r(4 * d)
        sd[f"{b}mlp.c_proj.weight"], sd[f"{b}mlp.c_proj.bias"] = r(d, 4 * d), r(d)
    return {"model." + k if i % 3 == 0 else k: v for i, (k, v) in enumerate(sd.items())}


@pytest.mark.parametrize("layout", ["hf", "open_clip"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_clip_vision_matches_jax(layout, dtype):
    """Both layouts, bit for bit (open-clip keys partly under `model.`);
    the converted tower's forward equals the JAX one's on its weights."""
    sd = _state_dict(layout)
    ref, rcfg = jclip.convert_clip_vision(sd, dtype=getattr(jnp, dtype))
    got, gcfg = tclip.convert_clip_vision(sd, dtype=getattr(torch, dtype))
    assert gcfg == rcfg == dict(patch=14, dim=32, depth=2, heads=1, img_size=56)
    _assert_same_tree(got, jax.tree.map(np.asarray, ref))
    img = np.random.default_rng(1).standard_normal((1, 56, 56, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: jclip.clip_vision_forward(p, rcfg, x))(ref, img)
    assert _rel_err(tclip.clip_vision_forward(got, gcfg, torch.from_numpy(img)), want) <= 1e-4


@pytest.mark.parametrize("d,heads", [(768, 12), (1024, 16), (1280, 16), (1664, 16), (96, 1)])
def test_default_heads_match_jax(d, heads):
    sd = _state_dict("hf", d=d, depth=1, img=14)
    assert tclip.convert_clip_vision(sd)[1]["heads"] == heads == \
        jclip.convert_clip_vision(sd)[1]["heads"]


@pytest.mark.parametrize("src,dst", [((480, 832), (224, 224)), ((120, 160), (224, 224)),
                                     ((90, 120), (56, 56))],
                         ids=["down_480x832", "up_120x160", "down_90x120"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_resize_matches_cv2(src, dst, dtype):
    """resize_linear equals cv2.resize(INTER_LINEAR) bit for bit."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    img = rng.random((*src, 3))
    img = (img * 255).astype(np.uint8) if dtype == "uint8" else img.astype(np.float32)
    ref = cv2.resize(img, dst)
    got = tclip.resize_linear(img, dst)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["uint8", "float01"])
def test_encode_image_matches_jax(kind):
    """A 480x832 frame -> [1, 257, 1280] tokens at ViT-H width (depth 2),
    within 1e-4 * max of the JAX encode_image (cv2.resize there)."""
    pytest.importorskip("cv2")
    params = jclip.init_clip_vision(jax.random.key(2), VITH_DEPTH2)
    img = np.random.default_rng(4).random((480, 832, 3))
    img = (img * 255).astype(np.uint8) if kind == "uint8" else img.astype(np.float32)
    ref = jclip.encode_image(params, VITH_DEPTH2, img)
    got = tclip.encode_image(_to_port(params), VITH_DEPTH2, img)
    assert tuple(got.shape) == ref.shape == (1, 257, 1280)
    assert _rel_err(got, ref) <= 1e-4


def test_encode_image_without_cv2(monkeypatch):
    """With cv2 unimportable the port's encode_image still runs and gives
    the tokens it gives with cv2 present."""
    params = tclip.init_clip_vision(tclip.TEST_TINY, torch.Generator().manual_seed(1))
    img = (np.random.default_rng(5).random((90, 120, 3)) * 255).astype(np.uint8)
    want = tclip.encode_image(params, tclip.TEST_TINY, img)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    got = tclip.encode_image(params, tclip.TEST_TINY, img)
    assert tuple(got.shape) == (1, 17, 32)
    assert torch.equal(got, want)


def test_maybe_load_clip_matches_jax(tmp_path):
    from versecrafter_tpu.core.convert import maybe_load_clip as jload
    from versecrafter_tpu_torch.core.convert import maybe_load_clip as tload

    assert tload(str(tmp_path)) == (None, None)
    torch.save(_state_dict("open_clip"), os.path.join(
        tmp_path, "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"))
    ref, rcfg = jload(str(tmp_path))
    got, gcfg = tload(str(tmp_path))
    assert gcfg == rcfg
    _assert_same_tree(got, jax.tree.map(np.asarray, ref))
    assert got["blocks"][0]["attn"]["q"]["kernel"].dtype == torch.bfloat16
