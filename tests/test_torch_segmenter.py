"""Port parity of the segmenter (CPU): the neural backend (Grounding DINO ->
SAM 2.1, and SAM1) on converted tiny HuggingFace models against the JAX
ImageSegmenter — raw detector and mask outputs within 1e-4 * max|ref|, then
the detection lists, compared only after asserting that every probability
the thresholds decide on clears them by MARGIN — run with OpenCV blocked;
the saliency backend (the port's own blur, k-means and connected
components) with cv2's generator and the port's seeded alike before each
package's call, and with OpenCV blocked; save_results' files byte for
byte; the guards; the segment CLI."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from test_segmenter_neural import GCFG, VOCAB, hf_gdino, hf_sam1, hf_sam2  # noqa: F401
from test_torch_moge import rel_err
from versecrafter_tpu.perception import gdino_hf as jg
from versecrafter_tpu.perception import sam as j1
from versecrafter_tpu.perception import sam2 as js
from versecrafter_tpu.perception import segmenter as jseg
from versecrafter_tpu_torch.perception import gdino_hf as tg
from versecrafter_tpu_torch.perception import sam as t1
from versecrafter_tpu_torch.perception import sam2 as ts
from versecrafter_tpu_torch.perception import segmenter as tseg
from versecrafter_tpu_torch.perception.wordpiece import SMOKE_VOCAB, WordPieceTokenizer
from versecrafter_tpu_torch.utils import cvops

BAR = 1e-4
MARGIN = 0.02
KNOBS = dict(det_size=128, box_threshold=0.3, text_threshold=0.35, min_area_ratio=0.0,
             max_area_ratio=1.0)
SAM1_CFG = dict(hidden_size=32, depth=3, heads=2, global_layers=(1,), window=2, patch=8,
                img_size=64, out_ch=24, mlp_ratio=2.0)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    p = tmp_path_factory.mktemp("tok") / "vocab.txt"
    p.write_text("\n".join(VOCAB))
    return str(p)


@pytest.fixture(scope="module")
def tokenizer(vocab):  # the JAX fixtures' tokenizer
    return transformers.BertTokenizer(vocab)


@pytest.fixture(scope="module")
def segs(vocab, tokenizer, hf_gdino, hf_sam2, hf_sam1):
    """{mask_backend: (JAX segmenter, port segmenter)} on the same weights."""
    gsd = hf_gdino.state_dict()
    scfg = js.cfg_from_hf(hf_sam2.config)
    out = {"sam2": (
        jseg.ImageSegmenter(backend="neural", tokenizer=tokenizer, **KNOBS,
                            gdino_params=(jg.convert_hf_gdino(gsd, GCFG), GCFG),
                            sam2_params=(js.convert_hf_sam2(hf_sam2.state_dict(), scfg), scfg)),
        tseg.ImageSegmenter(backend="neural", tokenizer=WordPieceTokenizer(vocab), **KNOBS,
                            gdino_params=(tg.convert_hf_gdino(gsd, GCFG), GCFG),
                            sam2_params=(ts.convert_hf_sam2(hf_sam2.state_dict(), scfg), scfg)))}
    s1 = hf_sam1.state_dict()
    out["sam1"] = (
        jseg.ImageSegmenter(backend="neural", mask_backend="sam1", tokenizer=tokenizer, **KNOBS,
                            gdino_params=out["sam2"][0].gdino_params,
                            sam2_params=(j1.convert_hf_sam(s1, SAM1_CFG, decoder_heads=2),
                                         SAM1_CFG)),
        tseg.ImageSegmenter(backend="neural", mask_backend="sam1",
                            tokenizer=WordPieceTokenizer(vocab), **KNOBS,
                            gdino_params=out["sam2"][1].gdino_params,
                            sam2_params=(t1.convert_hf_sam(s1, SAM1_CFG, decoder_heads=2),
                                         SAM1_CFG)))
    return out


def _image(seed):
    return (np.random.default_rng(seed).random((96, 112, 3)) * 255).astype(np.uint8)


def _assert_margins(logits, ids, box_threshold, text_threshold):
    """Every query's score and every token probability the posmap reads lie
    at least MARGIN from their thresholds."""
    L = ids.shape[-1]
    probs = 1.0 / (1.0 + np.exp(-np.asarray(logits, np.float32)[0, :, :L]))
    assert np.abs(probs.max(-1) - box_threshold).min() > MARGIN
    assert np.abs(probs[:, 1:L - 1] - text_threshold).min() > MARGIN


@pytest.mark.parametrize("mask_backend", ["sam2", "sam1"])
def test_neural_segment_image_matches_jax(segs, mask_backend, monkeypatch):
    jseg_, tseg_ = segs[mask_backend]
    img = _image(0)
    labels = ["car", "person"]
    want = jseg_.segment_image(img, "car. person.")
    monkeypatch.setitem(sys.modules, "cv2", None)  # the neural path reads no cv2
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    found, pix, spans, (logits, boxes) = tseg_.detect(img, labels)
    # the raw detector outputs on the same letterboxed input
    ids, _ = tg.phrase_token_spans(tseg_.tokenizer, labels)
    tin, ch, cw = tseg_._letterbox(img, KNOBS["det_size"])
    tin = ((tin - tseg.IMAGENET_MEAN) / tseg.IMAGENET_STD).transpose(2, 0, 1)[None]
    lj, bj = jg.gdino_forward_jit(jseg_.gdino_params[0], GCFG,
                                  jnp.asarray(tin).astype(jnp.float32), ids)
    fin = np.isfinite(np.asarray(lj))
    assert np.abs(logits.numpy()[fin] - np.asarray(lj)[fin]).max() \
        / np.abs(np.asarray(lj)[fin]).max() < BAR
    assert rel_err(boxes, bj) < BAR
    _assert_margins(lj, ids, KNOBS["box_threshold"], KNOBS["text_threshold"])
    # the mask model on the kept boxes, padded to max_objects * 2 prompts
    masks, iou, (sch, scw, s_size) = tseg_.masks_for_boxes(img, pix)
    mod = js if mask_backend == "sam2" else j1
    sparams, scfg = jseg_.sam2_params
    simg, _, _ = tseg_._letterbox(img, s_size)
    simg = (simg - tseg.IMAGENET_MEAN) / tseg.IMAGENET_STD
    sboxes = np.concatenate([pix * np.array([scw / 112, sch / 96] * 2),
                             np.tile([[0.0, 0.0, 8.0, 8.0]], (10 - len(pix), 1))], 0)
    mj, ij, _ = mod.predict_boxes_jit(sparams, scfg, jnp.asarray(simg, jnp.float32)[None],
                                      jnp.asarray(sboxes, jnp.float32)[None], True)
    assert masks.shape == mj.shape and masks.shape[1] == 10
    assert rel_err(masks, mj) < BAR and rel_err(iou, ij) < BAR
    # then the lists
    got = tseg_.segment_image(img, "car. person.")
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a.label, a.box) == (b.label, tuple(int(v) for v in b.box))
        assert abs(a.score - b.score) < 1e-5
        assert a.mask.dtype == bool and a.mask.shape == (96, 112)
        assert (a.mask == b.mask).mean() > 0.999


def test_letterbox_matches_cv2():
    img = _image(1)
    for size in (128, 1024, 896):
        got = tseg.ImageSegmenter._letterbox(img, size)
        want = jseg.ImageSegmenter._letterbox(img, size)
        assert got[1:] == want[1:]
        np.testing.assert_array_equal(got[0], want[0])


def test_saliency_backend_and_files(tmp_path):
    """The saliency backend (cv2's generator seeded before the JAX
    package's call, the port's before its own) with a depth map of another
    size, then save_results' files byte for byte."""
    import cv2

    img = _image(2)
    img[30:70, 40:90] = [220, 40, 40]
    depth = np.random.default_rng(3).random((48, 56)).astype(np.float32)
    kw = dict(backend="saliency", min_area_ratio=0.001)
    cv2.setRNGSeed(5)
    want = jseg.ImageSegmenter(**kw).segment_image(img, "car. person.", depth=depth)
    cvops.set_rng_seed(5)
    got = tseg.ImageSegmenter(**kw).segment_image(img, "car. person.", depth=depth)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a.label, a.score, a.box) == (b.label, b.score, b.box)
        np.testing.assert_array_equal(a.mask, b.mask)
    jp = jseg.ImageSegmenter(**kw).save_results(img, want, str(tmp_path / "jax"), stem="in")
    tp = tseg.ImageSegmenter(**kw).save_results(img, got, str(tmp_path / "port"), stem="in")
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert os.path.relpath(jp[k], tmp_path / "jax") == os.path.relpath(tp[k], tmp_path / "port")
        with open(jp[k], "rb") as f, open(tp[k], "rb") as g:
            assert f.read() == g.read(), k


def test_without_cv2(monkeypatch, tmp_path):
    """OpenCV blocked, as on the GPU machine: the saliency backend gives
    the JAX package's detections (cv2.setRNGSeed before the JAX call,
    cvops.set_rng_seed before the port's), with and without depth, and the
    file writer (the port's own PNG codec and drawing) writes the JAX
    package's files."""
    import cv2

    img = _image(4)
    img[10:40, 20:60] = [30, 30, 220]
    img[60:90, 70:110] = [230, 230, 40]
    depth = np.random.default_rng(4).random(img.shape[:2]).astype(np.float32)
    kw = dict(backend="saliency", min_area_ratio=0.001)
    want = []
    for seed, d in ((2, None), (9, depth)):
        cv2.setRNGSeed(seed)
        want.append(jseg.ImageSegmenter(**kw).segment_image(img, "car. box.", depth=d))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2  # noqa: F401,F811
    seg = tseg.ImageSegmenter(**kw)
    for (seed, d), w in zip(((2, None), (9, depth)), want):
        cvops.set_rng_seed(seed)
        got = seg.segment_image(img, "car. box.", depth=d)
        assert len(got) == len(w) > 0
        for a, b in zip(got, w):
            assert (a.label, a.score, a.box) == (b.label, b.score, b.box)
            np.testing.assert_array_equal(a.mask, b.mask)
    for dets, jdets, sub in ((got, w, "dets"), ([], [], "none")):
        paths = seg.save_results(img, dets, str(tmp_path / "port" / sub))
        jpaths = jseg.ImageSegmenter().save_results(img, jdets, str(tmp_path / "jax" / sub))
        assert sorted(paths) == sorted(jpaths)
        for k in jpaths:
            with open(jpaths[k], "rb") as f, open(paths[k], "rb") as g:
                assert f.read() == g.read(), k


def test_guards(segs):
    with pytest.raises(RuntimeError, match="gdino_checkpoint"):
        tseg.ImageSegmenter.build_neural(device="cpu")
    with pytest.raises(RuntimeError, match="sam1"):
        tseg.ImageSegmenter.build_neural(mask_backend="sam1", fresh_init=True, device="cpu")
    with pytest.raises(ValueError, match="mask_backend"):
        tseg.ImageSegmenter.build_neural(mask_backend="nope", fresh_init=True, device="cpu")
    bad = tseg.ImageSegmenter(backend="neural", mask_backend="nope", sam2_params=(None, None),
                              gdino_params=(None, None), tokenizer=segs["sam2"][1].tokenizer)
    with pytest.raises(ValueError, match="mask_backend"):
        bad.segment_image(np.zeros((32, 32, 3), np.uint8), "car.")
    with pytest.raises(ValueError, match="backend"):
        tseg.ImageSegmenter(backend="nope").segment_image(np.zeros((8, 8, 3), np.uint8), "a.")


def test_build_neural_fresh_init_trees(monkeypatch, tmp_path):
    """build_neural(fresh_init) on the CPU: init_gdino at Swin-T + BERT-base
    in bf16 with --gdino_bf16, init_sam2 at Hiera-L, the smoke vocabulary
    (an empty Hugging Face cache)."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    seg = tseg.ImageSegmenter.build_neural(fresh_init=True, gdino_bf16=True, device="cpu",
                                           max_objects=3)
    gparams, gcfg = seg.gdino_params
    sparams, scfg = seg.sam2_params
    assert gcfg == tg.SWINT_CFG and scfg == ts.HIERA_LARGE and seg.max_objects == 3
    assert gparams["swin"]["patch_embed"]["weight"].dtype == torch.bfloat16
    assert len(sparams["hiera"]["blocks"]) == sum(ts.HIERA_LARGE["blocks"])
    assert seg.tokenizer("car. dog", add_special_tokens=False)["input_ids"] == [6, 5, 9]


def test_segment_cli(tmp_path, monkeypatch):
    """The segment CLI on a written png: the saliency backend with a depth
    npz (files equal to the JAX CLI's, both generators seeded), and the neural
    backend with fresh tiny weights (the full-width configs patched tiny)
    on --device cpu, detector at its default 896."""
    import cv2

    from versecrafter_tpu.cli import segment as jcli
    from versecrafter_tpu_torch.cli import segment as tcli

    img = _image(6)
    img[20:60, 30:80] = [40, 200, 40]
    cv2.imwrite(str(tmp_path / "in.png"), img[..., ::-1])
    np.savez(tmp_path / "d.npz", depth=np.random.default_rng(0).random((1, 96, 112)))
    args = ["-i", str(tmp_path / "in.png"), "-t", "box.", "--depth_npz", str(tmp_path / "d.npz")]
    cv2.setRNGSeed(3)
    jcli.main(args + ["-o", str(tmp_path / "jax")])
    cvops.set_rng_seed(3)
    tcli.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    for root, _, files in os.walk(tmp_path / "jax"):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), tmp_path / "jax")
            with open(os.path.join(root, f), "rb") as a, open(tmp_path / "port" / rel, "rb") as b:
                assert a.read() == b.read(), rel

    monkeypatch.setattr(tg, "SWINT_CFG", dict(GCFG, num_queries=6))
    monkeypatch.setattr(tg, "SWINT_SHAPES", dict(
        tg.SWINT_SHAPES, swin_embed_dim=16, swin_depths=(1, 2, 1), bert_vocab=len(SMOKE_VOCAB),
        bert_hidden=32, bert_layers=2, bert_intermediate=64, bert_max_pos=64, enc_layers=2,
        dec_layers=2, enc_ffn=64, dec_ffn=64))
    monkeypatch.setattr(ts, "HIERA_LARGE", ts.TEST_TINY)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    found = []  # random masks cover most of the image: count what was detected
    detect = tseg.ImageSegmenter.detect

    def recording(self, image, labels):
        out = detect(self, image, labels)
        found.append(len(out[0]))
        return out
    monkeypatch.setattr(tseg.ImageSegmenter, "detect", recording)
    dets = tcli.main(["-i", str(tmp_path / "in.png"), "-t", "car. person.", "--backend",
                      "neural", "--neural_fresh_init", "--box_threshold", "0.0",
                      "-o", str(tmp_path / "neural"), "--device", "cpu"])
    assert found == [6]  # every query kept at threshold 0, none merged by NMS
    lines = open(tmp_path / "neural" / "annotations.txt").read().splitlines()
    assert len(dets) == len([ln for ln in lines if ln]) == len(os.listdir(
        tmp_path / "neural" / "masks"))
