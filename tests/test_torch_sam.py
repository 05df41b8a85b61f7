"""Port parity of the mask models (CPU, fp32): SAM 2.1 (Hiera, the FPN neck,
the prompt encoder with boxes and points, the mask decoder with and
without multimask) and SAM1 (ViT-H layout), each against the jitted JAX
function on the converted weights of a tiny HuggingFace model, within
1e-4 * max|ref|; the converters, params_from_jax and init_sam2's tree bit
for bit / leaf for leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from test_sam2_parity import BB
from test_sam_parity import CFG as SAM1_CFG
from test_torch_moge import assert_tree_equal, np_tree, rel_err
from versecrafter_tpu.perception import sam as j1
from versecrafter_tpu.perception import sam2 as js
from versecrafter_tpu_torch.core.convert import params_from_jax
from versecrafter_tpu_torch.perception import sam as t1
from versecrafter_tpu_torch.perception import sam2 as ts

BAR = 1e-4


@pytest.fixture(scope="module")
def hf_sam2():
    vision = transformers.Sam2VisionConfig(
        backbone_config=transformers.Sam2HieraDetConfig(**BB),
        backbone_channel_list=[128, 64, 32, 16],
        backbone_feature_sizes=[[32, 32], [16, 16], [8, 8]], fpn_hidden_size=32)
    cfg = transformers.Sam2Config(
        vision_config=vision,
        prompt_encoder_config=transformers.Sam2PromptEncoderConfig(
            hidden_size=32, image_size=128, patch_size=16),
        mask_decoder_config=transformers.Sam2MaskDecoderConfig(
            hidden_size=32, num_attention_heads=2, mlp_dim=64))
    torch.manual_seed(0)
    model = transformers.Sam2Model(cfg).eval()
    with torch.no_grad():  # the position embeddings and memory slot are zero-init
        model.vision_encoder.backbone.pos_embed.normal_(0, 0.5)
        model.vision_encoder.backbone.pos_embed_window.normal_(0, 0.5)
        model.no_memory_embedding.normal_(0, 0.5)
    return model


@pytest.fixture(scope="module")
def sam2_pair(hf_sam2):
    cfg = js.cfg_from_hf(hf_sam2.config)
    jp = js.convert_hf_sam2(hf_sam2.state_dict(), cfg)
    return cfg, jp, ts.convert_hf_sam2(hf_sam2.state_dict(), cfg)


def test_sam2_constants_and_cfg(hf_sam2):
    assert (ts.HIERA_TINY, ts.HIERA_LARGE, ts.TEST_TINY) == \
        (js.HIERA_TINY, js.HIERA_LARGE, js.TEST_TINY)
    assert ts.cfg_from_hf(hf_sam2.config) == js.cfg_from_hf(hf_sam2.config)
    assert ts._block_layout(js.HIERA_LARGE) == js._block_layout(js.HIERA_LARGE)


def test_sam2_converter_bit_for_bit(hf_sam2, sam2_pair):
    cfg, jp, tp = sam2_pair
    assert_tree_equal(tp, np_tree(jp))
    assert_tree_equal(params_from_jax(np_tree(jp)), np_tree(jp))
    assert_tree_equal(ts.convert_hf_sam2(hf_sam2.state_dict(), cfg, dtype=torch.bfloat16),
                      np_tree(js.convert_hf_sam2(hf_sam2.state_dict(), cfg, dtype=jnp.bfloat16)))


def test_sam2_image_embeddings(sam2_pair):
    """Hiera's stages, the neck and the decoder's pre-projected levels."""
    cfg, jp, tp = sam2_pair
    px = np.random.default_rng(0).standard_normal((2, 128, 128, 3)).astype(np.float32)
    ref = jax.jit(lambda p, x: js.image_embeddings(p, cfg, x))(jp, px)
    got = ts.image_embeddings(tp, cfg, torch.from_numpy(px))
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        assert rel_err(g, r) < BAR
    stages_j = jax.jit(lambda p, x: js.hiera_forward(p, cfg, x))(jp["hiera"], px)
    stages_t = ts.hiera_forward(tp["hiera"], cfg, torch.from_numpy(px))
    for g, r in zip(stages_t, stages_j):
        assert rel_err(g, r) < BAR


@pytest.mark.parametrize("multimask", [True, False], ids=["multimask", "single"])
def test_sam2_box_prompts(sam2_pair, multimask):
    """predict_boxes: masks, IoU and object logits, boxes at the border and
    a degenerate one."""
    cfg, jp, tp = sam2_pair
    px = np.random.default_rng(1).standard_normal((1, 128, 128, 3)).astype(np.float32)
    boxes = np.array([[[10, 20, 60, 90], [0, 0, 128, 128], [50, 50, 52, 52]]], np.float32)
    mj, ij, oj = jax.jit(lambda p, x, b: js.predict_boxes(p, cfg, x, b, multimask))(
        jp, px, boxes)
    mt, it, ot = ts.predict_boxes(tp, cfg, torch.from_numpy(px), torch.from_numpy(boxes),
                                  multimask)
    assert mt.shape == mj.shape
    assert rel_err(mt, mj) < BAR and rel_err(it, ij) < BAR and rel_err(ot, oj) < BAR


def test_sam2_point_prompts(sam2_pair):
    """Points with fg / bg / padding (-1) / ignored (-10) labels, with and
    without boxes, through the decoder."""
    cfg, jp, tp = sam2_pair
    rng = np.random.default_rng(2)
    pts = (rng.random((1, 2, 3, 2)) * 128).astype(np.float32)
    labels = np.array([[[1, 0, -1], [1, 1, -10]]], np.int32)
    boxes = np.array([[[10, 20, 60, 90], [5, 5, 100, 120]]], np.float32)
    for b in (None, boxes):
        ej = js.encode_prompts(jp, cfg, boxes=None if b is None else jnp.asarray(b),
                               points=jnp.asarray(pts), labels=jnp.asarray(labels))
        et = ts.encode_prompts(tp, cfg, boxes=None if b is None else torch.from_numpy(b),
                               points=torch.from_numpy(pts),
                               labels=torch.from_numpy(labels).long())
        assert rel_err(et, ej) < BAR
    px = rng.standard_normal((1, 128, 128, 3)).astype(np.float32)
    emb_j = jax.jit(lambda p, x: js.image_embeddings(p, cfg, x))(jp, px)
    mj, ij, _ = jax.jit(lambda p, e, s: js.decode_masks(p, cfg, e, s, True))(jp, emb_j, ej)
    mt, it, _ = ts.decode_masks(tp, cfg, [torch.from_numpy(np.array(e)) for e in emb_j],
                                et, True)
    assert rel_err(mt, mj) < BAR and rel_err(it, ij) < BAR


def test_init_sam2_tree():
    """init_sam2 (torch.Generator) gives the JAX init's tree: keys, shapes,
    dtypes, at the tiny and the Hiera-L config."""
    def spec(t):
        return jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype).split(".")[-1]), t)
    for cfg in (js.TEST_TINY, js.HIERA_LARGE):
        got = spec(ts.init_sam2(torch.Generator().manual_seed(0), cfg))
        want = spec(jax.eval_shape(lambda k: js.init_sam2(k, cfg), jax.random.key(0)))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert jax.tree.leaves(got) == jax.tree.leaves(want)


@pytest.fixture(scope="module")
def sam1_pair():
    vision = transformers.SamVisionConfig(
        hidden_size=32, num_hidden_layers=3, num_attention_heads=2, global_attn_indexes=[1],
        window_size=2, patch_size=8, image_size=64, output_channels=24, mlp_dim=64,
        num_pos_feats=12, use_abs_pos=True, use_rel_pos=True)
    cfg = transformers.SamConfig(
        vision_config=vision,
        prompt_encoder_config=transformers.SamPromptEncoderConfig(
            hidden_size=24, image_size=64, patch_size=8, image_embedding_size=8),
        mask_decoder_config=transformers.SamMaskDecoderConfig(
            hidden_size=24, num_hidden_layers=2, num_attention_heads=2, mlp_dim=48,
            iou_head_depth=3, iou_head_hidden_dim=32))
    torch.manual_seed(0)
    hf = transformers.SamModel(cfg).eval()
    with torch.no_grad():  # relative positions are zero-init
        for name, p in hf.named_parameters():
            if "rel_pos" in name or "pos_embed" in name:
                p.normal_(0, 0.3)
    sd = hf.state_dict()
    return (sd, j1.convert_hf_sam(sd, SAM1_CFG, decoder_heads=2),
            t1.convert_hf_sam(sd, SAM1_CFG, decoder_heads=2))


def test_sam1_converter_and_constants(sam1_pair):
    sd, jp, tp = sam1_pair
    assert (t1.VIT_B, t1.VIT_H, t1.TEST_TINY) == (j1.VIT_B, j1.VIT_H, j1.TEST_TINY)
    assert_tree_equal(tp, np_tree(jp))
    assert_tree_equal(params_from_jax(np_tree(jp)), np_tree(jp))


@pytest.mark.parametrize("multimask", [True, False], ids=["multimask", "single"])
def test_sam1_predict_boxes(sam1_pair, multimask):
    """vision_forward (windowed + global rel-pos attention, the neck),
    box prompts and decode_masks."""
    _, jp, tp = sam1_pair
    rng = np.random.default_rng(3)
    px = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    boxes = np.array([[[5, 6, 40, 50], [0, 0, 64, 64]]], np.float32)
    ej = jax.jit(lambda p, x: j1.vision_forward(p, SAM1_CFG, x))(
        {k: v for k, v in jp.items() if k != "decoder"}, px)
    et = t1.vision_forward(tp, SAM1_CFG, torch.from_numpy(px))
    assert rel_err(et, ej) < BAR
    mj, ij, _ = j1.predict_boxes_jit(jp, SAM1_CFG, px, boxes, multimask)
    mt, it, oj = t1.predict_boxes(tp, SAM1_CFG, torch.from_numpy(px), torch.from_numpy(boxes),
                                  multimask)
    assert oj is None and mt.shape == mj.shape
    assert rel_err(mt, mj) < BAR and rel_err(it, ij) < BAR
    pts = (rng.random((1, 2, 2, 2)) * 64).astype(np.float32)
    labels = np.array([[[1, 0], [-1, 1]]], np.int32)
    pj = j1.encode_prompts(jp, SAM1_CFG, points=jnp.asarray(pts), labels=jnp.asarray(labels))
    pt = t1.encode_prompts(tp, SAM1_CFG, points=torch.from_numpy(pts),
                           labels=torch.from_numpy(labels).long())
    assert rel_err(pt, pj) < BAR
