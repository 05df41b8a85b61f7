"""Port parity of the detector (CPU): Grounding DINO's Swin backbone, BERT
tower, deformable attention (at the grid's borders) and full detection
outputs against the jitted JAX functions on the converted weights of a
tiny HuggingFace model (fp32 within 1e-4 * max|ref|); the converter,
params_from_jax, the host post-processing and the stable top-k bit for
bit; init_gdino's tree against convert_hf_gdino's at the tiny config and
at Swin-T + BERT-base; the WordPiece tokenizer's ids against
transformers.BertTokenizer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from test_gdino_parity import CFG
from test_torch_moge import assert_tree_equal, np_tree, rel_err
from versecrafter_tpu.perception import gdino_hf as jg
from versecrafter_tpu_torch.core.convert import params_from_jax
from versecrafter_tpu_torch.perception import gdino_hf as tg
from versecrafter_tpu_torch.perception.wordpiece import SMOKE_VOCAB, WordPieceTokenizer

BAR = 1e-4
# the tiny model's sizes beyond CFG (test_gdino_parity's HF config)
TINY_SHAPES = dict(swin_embed_dim=16, swin_depths=(1, 2, 1), bert_vocab=2000, bert_hidden=32,
                   bert_layers=2, bert_intermediate=64, bert_max_pos=64, enc_layers=2,
                   dec_layers=2, enc_ffn=64, dec_ffn=64)
IDS = np.array([[101, 137, 493, 1012, 137, 655, 1012, 102]], np.int64)


@pytest.fixture(scope="module")
def hf_gdino():
    swin = transformers.SwinConfig(
        image_size=64, patch_size=4, embed_dim=16, depths=[1, 2, 1], num_heads=[1, 2, 2],
        window_size=2, out_indices=[1, 2, 3], drop_path_rate=0.0, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    bert = transformers.BertConfig(
        vocab_size=2000, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, max_position_embeddings=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    cfg = transformers.GroundingDinoConfig(
        backbone_config=swin, text_config=bert, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
        decoder_ffn_dim=64, num_queries=10, num_feature_levels=4, max_text_len=16,
        dropout=0.0, activation_dropout=0.0, attention_dropout=0.0, fusion_dropout=0.0,
        fusion_droppath=0.0, text_enhancer_dropout=0.0, positional_embedding_temperature=20)
    torch.manual_seed(0)
    model = transformers.GroundingDinoForObjectDetection(cfg).eval()
    with torch.no_grad():  # the fusion layer scales start at 1e-4
        for name, p in model.named_parameters():
            if name.endswith(("vision_param", "text_param")):
                p.normal_(0, 0.5)
    return model


@pytest.fixture(scope="module")
def pair(hf_gdino):
    sd = hf_gdino.state_dict()
    return jg.convert_hf_gdino(sd, CFG), tg.convert_hf_gdino(sd, CFG)


def test_constants_and_converter(hf_gdino, pair):
    assert (tg.SWINT_CFG, tg.SPECIAL_TOKENS) == (jg.SWINT_CFG, jg.SPECIAL_TOKENS)
    jp, tp = pair
    assert_tree_equal(tp, np_tree(jp))
    assert_tree_equal(params_from_jax(np_tree(jp)), np_tree(jp))
    sd = hf_gdino.state_dict()
    assert_tree_equal(tg.convert_hf_gdino(sd, CFG, dtype=torch.bfloat16),
                      np_tree(jg.convert_hf_gdino(sd, CFG, dtype=jnp.bfloat16)))


def test_init_gdino_tree_tiny(pair):
    jp, _ = pair
    got = tg.init_gdino(CFG, torch.Generator().manual_seed(0), shapes=TINY_SHAPES)
    spec = lambda t: jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype).split(".")[-1]), t)  # noqa: E731
    assert jax.tree.structure(spec(got)) == jax.tree.structure(spec(np_tree(jp)))
    assert jax.tree.leaves(spec(got)) == jax.tree.leaves(spec(np_tree(jp)))


def test_init_gdino_tree_swint():
    """The full width: Swin-T + BERT-base, 6 + 6 layers, 900 queries, fp32
    and bf16, against the converter on transformers' model of
    hf_swint_config()."""
    want = jg.convert_hf_gdino(
        transformers.GroundingDinoForObjectDetection(jg.hf_swint_config()).state_dict(),
        jg.SWINT_CFG, dtype=jnp.bfloat16)
    spec = lambda t: jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype).split(".")[-1]), t)  # noqa: E731
    got = tg.init_gdino(tg.SWINT_CFG, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    assert jax.tree.structure(spec(got)) == jax.tree.structure(spec(np_tree(want)))
    assert jax.tree.leaves(spec(got)) == jax.tree.leaves(spec(np_tree(want)))


def test_swin_and_bert(pair):
    jp, tp = pair
    px = np.random.default_rng(0).standard_normal((2, 3, 64, 64)).astype(np.float32)
    fj = jax.jit(lambda p, x: jg.swin_forward(p, CFG, x))(jp["swin"], px)
    ft = tg.swin_forward(tp["swin"], CFG, torch.from_numpy(px))
    assert len(ft) == len(fj) and all(rel_err(a, b) < BAR for a, b in zip(ft, fj))
    a3, pos = jg.text_masks_and_positions(IDS)
    ta3, tpos = tg.text_masks_and_positions(IDS)
    np.testing.assert_array_equal(ta3, a3)
    np.testing.assert_array_equal(tpos, pos)
    bj = jax.jit(lambda p, i, a, q: jg.bert_forward(p, CFG, i, a, q))(
        jp["text_backbone"], IDS, a3, pos)
    bt = tg.bert_forward(tp["text_backbone"], CFG, torch.from_numpy(IDS), torch.from_numpy(a3),
                         torch.from_numpy(pos))
    assert rel_err(bt, bj) < BAR


@pytest.mark.parametrize("ref_dims", [2, 4])
def test_deformable_attention_at_borders(pair, ref_dims):
    """Reference points on and beyond the grid's edges (samples half in,
    wholly out): F.grid_sample against the JAX gathers."""
    jp, tp = pair
    shapes = [(8, 8), (4, 4), (2, 2), (1, 1)]
    rng = np.random.default_rng(ref_dims)
    q = rng.standard_normal((1, 6, 32)).astype(np.float32)
    v = rng.standard_normal((1, sum(h * w for h, w in shapes), 32)).astype(np.float32)
    edges = np.array([0.0, 1.0, -0.05, 1.05, 0.5, 0.999], np.float32)
    ref = np.stack([edges, edges[::-1]], -1)[None, :, None, :].repeat(4, 2)
    if ref_dims == 4:
        ref = np.concatenate([ref, np.full_like(ref, 0.3)], -1)
    lp = jp["encoder"]["layers"][0]["deformable_layer"]["self_attn"]
    lt = tp["encoder"]["layers"][0]["deformable_layer"]["self_attn"]
    want = jax.jit(lambda p, a, r, b: jg.deformable_attention(p, a, r, b, shapes, 4, 4))(
        lp, q, ref, v)
    got = tg.deformable_attention(lt, torch.from_numpy(q), torch.from_numpy(ref),
                                  torch.from_numpy(v), shapes, 4, 4)
    assert rel_err(got, want) < BAR


def test_detection_outputs(pair):
    """gdino_forward's logits (the -inf padding included) and boxes."""
    jp, tp = pair
    px = np.random.default_rng(3).standard_normal((1, 3, 64, 64)).astype(np.float32)
    lj, bj = jg.gdino_forward_jit(jp, CFG, jnp.asarray(px), IDS)
    lt, bt = tg.gdino_forward(tp, CFG, torch.from_numpy(px), IDS)
    lj = np.asarray(lj)
    assert np.array_equal(np.isinf(lt.numpy()), np.isinf(lj))
    fin = np.isfinite(lj)
    assert np.abs(lt.numpy()[fin] - lj[fin]).max() / np.abs(lj[fin]).max() < BAR
    assert rel_err(bt, bj) < BAR


def test_stable_topk_keeps_ties_in_index_order():
    scores = torch.tensor([[0.5, 0.9, 0.5, 0.5, 0.9, 0.1, 0.5]])
    want = jax.lax.top_k(jnp.asarray(scores.numpy()), 5)[1]
    np.testing.assert_array_equal(tg.topk_stable(scores, 5).numpy(), np.asarray(want))


def test_host_postprocessing_bit_for_bit(tmp_path):
    """postprocess_grounded_detections, phrase_token_spans, assign_phrase
    and nms_xyxy on the same arrays (phrase spans with the port's tokenizer
    and with BertTokenizer)."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((1, 12, 16)).astype(np.float32)
    boxes = rng.random((1, 12, 4)).astype(np.float32)
    got = tg.postprocess_grounded_detections(torch.from_numpy(logits), torch.from_numpy(boxes),
                                             IDS, 0.6, 0.55)
    want = jg.postprocess_grounded_detections(jnp.asarray(logits), jnp.asarray(boxes), IDS,
                                              0.6, 0.55)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a["score"] == b["score"]
        for k in ("box", "token_positions", "probs"):
            np.testing.assert_array_equal(a[k], b[k])
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(SMOKE_VOCAB + ["red", "##dish"]))
    phrases = ["car", "a red box", "reddish chair"]
    t_ids, t_spans = tg.phrase_token_spans(WordPieceTokenizer(str(path)), phrases)
    j_ids, j_spans = jg.phrase_token_spans(transformers.BertTokenizer(str(path)), phrases)
    np.testing.assert_array_equal(t_ids, j_ids)
    assert t_spans == j_spans
    spans = [(1, 2), (3, 6), (7, 9)]
    for det in got:
        assert tg.assign_phrase(det, spans) == jg.assign_phrase(det, spans)
    pix = rng.random((20, 4)).astype(np.float32) * 50
    pix[:, 2:] += pix[:, :2]
    sc = rng.random(20).astype(np.float32)
    assert tg.nms_xyxy(pix, sc, 0.3) == jg.nms_xyxy(pix, sc, 0.3)


TEXTS = ["car. person.", "A Red  CAR, a person!", "reddish chair", "Café crème brûlée",
         "chair?dog;cat", "x" * 101 + " car", "tab\tnew\nline  [SEP] car", "汉字 car",
         "unaffable cup", "objects", ""]


@pytest.mark.parametrize("vocab", ["smoke", "subwords"])
def test_wordpiece_matches_bert_tokenizer(tmp_path, vocab):
    """Ids of the port's tokenizer equal transformers.BertTokenizer's on the
    same vocab file: lower-casing, accents, punctuation, sub-words, CJK,
    special tokens in the text, a word over 100 characters."""
    words = list(SMOKE_VOCAB)
    if vocab == "subwords":
        words += ["red", "##dish", "un", "##aff", "##able", "cafe", "creme", "brulee", "!",
                  ",", "?", ";", "a", "tab", "new", "line", "汉", "字", "##s", "chair"]
    path = tmp_path / f"{vocab}.txt"
    path.write_text("\n".join(words))
    ours, theirs = WordPieceTokenizer(str(path)), transformers.BertTokenizer(str(path))
    assert (ours.cls_token_id, ours.sep_token_id) == (theirs.cls_token_id, theirs.sep_token_id)
    for text in TEXTS:
        for special in (False, True):
            assert ours(text, add_special_tokens=special)["input_ids"] == \
                theirs(text, add_special_tokens=special)["input_ids"], (text, special)
        assert ours.tokenize(text) == theirs.tokenize(text), text
    assert ours.convert_tokens_to_ids(".") == theirs.convert_tokens_to_ids(".")
