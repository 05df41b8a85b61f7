"""Text-prompted image segmentation (the port's counterpart of
``versecrafter_tpu.perception.segmenter``): the reference's Grounded-SAM-2
`ImageSegmenter` surface with two backends.

- `backend="neural"`: Grounding DINO (gdino_hf.py) boxes for the prompt's
  phrases, labels grounded from the token posmap, class-agnostic NMS, then
  SAM 2.1 (sam2.py) or SAM (sam.py, `mask_backend="sam1"`) box-prompted
  masks. The letterbox and the mask resize are OpenCV's bilinear
  `cv2.resize` in numpy (utils/imgproc.resize_linear), so this backend needs
  no OpenCV: it runs on arrays on the card.
- `backend="saliency"`: the classical fallback (colour k-means + connected
  components). Its blur, k-means and connected components are OpenCV's, bit
  for bit, in the port's own host code (utils/cvops.py), and the k-means
  draws from a per-thread generator that starts where OpenCV's does, so an
  unseeded call in a fresh thread gives the JAX package's detections.

Detections are area-filtered, sorted by area and cut to max_objects;
`save_results` writes the reference's file layout through the port's PNG
writer and utils/imgproc's rectangle and label drawing.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from versecrafter_tpu_torch.utils import cvops, imgproc
from versecrafter_tpu_torch.utils.imgproc import resize_linear
from versecrafter_tpu_torch.utils.video import write_png


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406])
IMAGENET_STD = np.array([0.229, 0.224, 0.225])


@dataclass
class Detection:
    label: str
    score: float
    box: Tuple[int, int, int, int]  # x0, y0, x1, y1
    mask: np.ndarray                # [H, W] bool


@dataclass
class ImageSegmenter:
    backend: str = "saliency"
    box_threshold: float = 0.25
    text_threshold: float = 0.25
    max_objects: int = 5
    min_area_ratio: float = 0.002
    max_area_ratio: float = 0.6
    # neural backend: (params, cfg) of the mask family ("sam2" Hiera, or
    # "sam1" SAM-vit checkpoints) and of Grounding DINO, on one device
    mask_backend: str = "sam2"
    sam2_params: object = None
    gdino_params: object = None
    tokenizer: object = None
    det_size: int = 896
    nms_iou: float = 0.5

    def segment_image(self, image: np.ndarray, text_prompt: str,
                      depth: Optional[np.ndarray] = None) -> List[Detection]:
        """image [H, W, 3] uint8 RGB; text_prompt 'car. person.' ->
        detections sorted by area, area-ratio filtered, top max_objects."""
        labels = [t.strip() for t in text_prompt.replace(",", ".").split(".") if t.strip()]
        if self.backend == "saliency":
            dets = self._saliency_segment(image, labels, depth)
        elif self.backend == "neural":
            dets = self._neural_segment(image, labels)
        else:
            raise ValueError(f"unknown backend {self.backend!r}")
        area = image.shape[0] * image.shape[1]
        dets = [d for d in dets
                if self.min_area_ratio <= d.mask.sum() / area <= self.max_area_ratio]
        dets.sort(key=lambda d: d.mask.sum(), reverse=True)
        return dets[: self.max_objects]

    # -- classical fallback ---------------------------------------------------
    def _saliency_segment(self, image, labels, depth) -> List[Detection]:
        h, w = image.shape[:2]
        feats = np.concatenate([
            cvops.gaussian_blur(image, 9).reshape(-1, 3).astype(np.float32) / 255.0,
            (np.mgrid[0:h, 0:w].transpose(1, 2, 0).reshape(-1, 2) / [h, w]).astype(np.float32)
            * 0.5,
        ], 1)
        if depth is not None:
            d = depth.astype(np.float32)
            if d.shape != (h, w):
                d = resize_linear(np.ascontiguousarray(d), (w, h))
            d = (d - d.min()) / max(d.max() - d.min(), 1e-6)
            feats = np.concatenate([feats, d.reshape(-1, 1)], 1)
        k = min(8, max(3, len(labels) + 2))
        _, lab, _ = cvops.kmeans(feats, k,
                                 (cvops.TERM_CRITERIA_EPS + cvops.TERM_CRITERIA_MAX_ITER, 10, 1.0),
                                 3, cvops.KMEANS_PP_CENTERS)
        lab = lab.reshape(h, w)
        dets: List[Detection] = []
        for c in range(k):
            m = (lab == c).astype(np.uint8)
            if m[0].mean() + m[-1].mean() + m[:, 0].mean() + m[:, -1].mean() > 0.5:
                continue  # border-touching clusters are background
            n, comp, stats, _ = cvops.connected_components_with_stats(m)
            for i in range(1, n):
                x, y, bw, bh, a = stats[i]
                if a < self.min_area_ratio * h * w:
                    continue
                label = labels[len(dets) % len(labels)] if labels else "object"
                dets.append(Detection(label, 0.5, (x, y, x + bw, y + bh), comp == i))
        return dets

    # -- neural backend construction -----------------------------------------
    @classmethod
    def build_neural(cls, sam2_checkpoint: Optional[str] = None,
                     gdino_checkpoint: Optional[str] = None, bert_vocab: Optional[str] = None,
                     mask_backend: str = "sam2", fresh_init: bool = False,
                     gdino_bf16: bool = False, device=None, **kwargs) -> "ImageSegmenter":
        """The neural segmenter on `device` (default cuda) from torch
        checkpoints (HuggingFace GroundingDinoForObjectDetection / Sam2Model /
        SamModel state dicts), or with `fresh_init` random full-width
        weights from `seed` (Swin-T + BERT-base at 896, Hiera-L at 1024)
        through init_gdino / init_sam2.

        Tokenizer: `bert_vocab` (a vocab.txt), else a cached
        bert-base-uncased vocab.txt, else (fresh_init only) SMOKE_VOCAB."""
        from versecrafter_tpu_torch import resolve_device
        from versecrafter_tpu_torch.perception import gdino_hf, sam2 as sam2_mod
        from versecrafter_tpu_torch.perception.wordpiece import (
            SMOKE_VOCAB, WordPieceTokenizer, cached_vocab)

        if mask_backend not in ("sam2", "sam1"):
            raise ValueError(f"unknown mask_backend {mask_backend!r}")
        if mask_backend == "sam1" and not sam2_checkpoint:
            raise RuntimeError("mask_backend='sam1' needs a checkpoint "
                               "(no fresh-init shape for SAM1)")
        if not (gdino_checkpoint or fresh_init):
            raise RuntimeError("neural backend needs --gdino_checkpoint (or fresh_init)")
        dev = resolve_device(device)

        def load_sd(path):
            from versecrafter_tpu_torch.core.convert import load_torch_state_dict
            sd = load_torch_state_dict(path)
            return sd["model"] if "model" in sd and not hasattr(sd["model"], "shape") else sd

        def to_dev(tree):
            if isinstance(tree, dict):
                return {k: to_dev(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [to_dev(v) for v in tree]
            return tree.to(dev) if isinstance(tree, torch.Tensor) else tree

        gdtype = torch.bfloat16 if gdino_bf16 else torch.float32
        gcfg = dict(gdino_hf.SWINT_CFG)
        gen = torch.Generator(device=dev).manual_seed(0)
        if gdino_checkpoint:
            gparams = to_dev(gdino_hf.convert_hf_gdino(load_sd(gdino_checkpoint), gcfg,
                                                       dtype=gdtype))
        else:
            gparams = gdino_hf.init_gdino(gcfg, gen, dtype=gdtype)
        if mask_backend == "sam2":
            scfg = dict(sam2_mod.HIERA_LARGE)
            sparams = to_dev(sam2_mod.convert_hf_sam2(load_sd(sam2_checkpoint), scfg)) \
                if sam2_checkpoint else sam2_mod.init_sam2(gen, scfg)
        else:
            from versecrafter_tpu_torch.perception import sam as sam1_mod
            scfg = dict(sam1_mod.VIT_H, img_size=1024)
            sparams = to_dev(sam1_mod.convert_hf_sam(load_sd(sam2_checkpoint), scfg))

        vocab = bert_vocab or cached_vocab("bert-base-uncased")
        if vocab is None:
            if not fresh_init:
                raise RuntimeError("neural backend needs --bert_vocab (no cached "
                                   "bert-base-uncased here)")
            import tempfile
            with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
                f.write("\n".join(SMOKE_VOCAB))
            vocab = f.name
        return cls(backend="neural", mask_backend=mask_backend, sam2_params=(sparams, scfg),
                   gdino_params=(gparams, gcfg), tokenizer=WordPieceTokenizer(vocab), **kwargs)

    # -- neural backend: Grounding DINO boxes -> SAM masks -------------------
    @staticmethod
    def _letterbox(image, size):
        """Aspect-preserving resize (longest side -> size, OpenCV's bilinear)
        with bottom/right zero padding: (padded float image 0..1, content_h,
        content_w)."""
        h, w = image.shape[:2]
        scale = size / max(h, w)
        ch, cw = max(1, round(h * scale)), max(1, round(w * scale))
        resized = resize_linear(np.ascontiguousarray(image), (cw, ch)).astype(np.float32) / 255.0
        out = np.zeros((size, size, 3), np.float32)
        out[:ch, :cw] = resized
        return out, ch, cw

    def detect(self, image, labels):
        """The detector's half: (found detections with pixel boxes after NMS,
        their boxes [N, 4], the phrase spans, raw (logits, boxes))."""
        from versecrafter_tpu_torch.perception import gdino_hf

        gparams, gcfg = self.gdino_params
        oh, ow = image.shape[:2]
        size = self.det_size
        gimg, ch, cw = self._letterbox(image, size)
        gimg = (gimg - IMAGENET_MEAN) / IMAGENET_STD
        ids, spans = gdino_hf.phrase_token_spans(self.tokenizer, labels)
        logits, boxes = gdino_hf.gdino_forward(
            gparams, gcfg, torch.from_numpy(gimg.transpose(2, 0, 1)[None].astype(np.float32)), ids)
        found = gdino_hf.postprocess_grounded_detections(logits, boxes, ids, self.box_threshold,
                                                         self.text_threshold)
        if not found:
            return [], np.zeros((0, 4)), spans, (logits, boxes)
        sx, sy = size / (cw / ow), size / (ch / oh)
        pix = np.clip(np.stack([d["box"] * [sx, sy, sx, sy] for d in found]), 0, [ow, oh, ow, oh])
        keep = gdino_hf.nms_xyxy(pix, np.array([d["score"] for d in found]),
                                 iou_threshold=self.nms_iou)[: self.max_objects * 2]
        return [found[i] for i in keep], pix[keep], spans, (logits, boxes)

    def masks_for_boxes(self, image, pix_boxes):
        """The mask model's half: every box in one prompt batch padded to
        max_objects * 2 rows (dummy 8x8 boxes, one decoder row each) ->
        (masks [1, Q, M, h, w], iou [1, Q, M]) and the letterbox content
        size."""
        if self.mask_backend == "sam2":
            from versecrafter_tpu_torch.perception import sam2 as mod
            size_key = "image_size"
        else:
            from versecrafter_tpu_torch.perception import sam as mod
            size_key = "img_size"
        sparams, scfg = self.sam2_params
        oh, ow = image.shape[:2]
        s_size = scfg[size_key]
        simg, sch, scw = self._letterbox(image, s_size)
        simg = (simg - IMAGENET_MEAN) / IMAGENET_STD
        sboxes = pix_boxes * np.array([scw / ow, sch / oh] * 2)
        pad_to = self.max_objects * 2
        if len(sboxes) < pad_to:
            sboxes = np.concatenate([sboxes, np.tile([[0.0, 0.0, 8.0, 8.0]],
                                                     (pad_to - len(sboxes), 1))], 0)
        dev = (sparams["hiera"]["patch_embed"]["weight"] if self.mask_backend == "sam2"
               else sparams["patch_embed"]["weight"]).device
        masks, iou, _ = mod.predict_boxes(
            sparams, scfg, torch.from_numpy(simg.astype(np.float32))[None].to(dev),
            torch.from_numpy(sboxes.astype(np.float32))[None].to(dev), multimask_output=True)
        return masks, iou, (sch, scw, s_size)

    def _neural_segment(self, image, labels) -> List[Detection]:
        from versecrafter_tpu_torch.perception import gdino_hf

        if self.mask_backend not in ("sam2", "sam1"):
            raise ValueError(f"unknown mask_backend {self.mask_backend!r}")
        if self.sam2_params is None or self.gdino_params is None:
            raise RuntimeError("neural backend needs converted sam2/gdino params")
        if self.tokenizer is None:
            raise RuntimeError("neural backend needs a BERT tokenizer")
        found, pix_boxes, spans, _ = self.detect(image, labels)
        if not found:
            return []
        masks, iou, (sch, scw, s_size) = self.masks_for_boxes(image, pix_boxes)
        best = torch.argmax(iou[0], -1).cpu().numpy()
        oh, ow = image.shape[:2]
        mh, mw = masks.shape[-2:]
        vh, vw = round(sch / s_size * mh), round(scw / s_size * mw)
        dets: List[Detection] = []
        for qi, det in enumerate(found):
            m = masks[0, qi, best[qi]].float().cpu().numpy()
            m = resize_linear(np.ascontiguousarray(m[:vh, :vw]), (ow, oh))
            label = labels[gdino_hf.assign_phrase(det, spans)] if labels else "object"
            dets.append(Detection(label, det["score"], tuple(pix_boxes[qi].astype(int)), m > 0))
        return dets

    # -- file contract --------------------------------------------------------
    def save_results(self, image: np.ndarray, detections: Sequence[Detection],
                     output_dir: str, stem: str = "") -> Dict[str, str]:
        """masks/mask_{id:02d}_{label}.png, {stem}_mask_combined.png,
        {stem}_annotations.txt and {stem}_visualization.png."""
        os.makedirs(os.path.join(output_dir, "masks"), exist_ok=True)
        paths = {}
        combined = np.zeros(image.shape[:2], np.uint8)
        vis = image.copy()
        lines = []
        for i, d in enumerate(detections, start=1):
            name = f"mask_{i:02d}_{d.label}.png"
            p = os.path.join(output_dir, "masks", name)
            write_png(p, d.mask.astype(np.uint8) * 255)
            paths[name] = p
            combined |= d.mask.astype(np.uint8) * 255
            x0, y0, x1, y1 = d.box
            imgproc.rectangle(vis, (x0, y0), (x1, y1), (255, 60, 60))
            imgproc.put_text(vis, f"{i}:{d.label}", (x0, max(y0 - 4, 10)), (255, 60, 60))
            lines.append(f"{i}\t{d.label}\t{d.score:.3f}\t{x0},{y0},{x1},{y1}\t"
                         f"{int(d.mask.sum())}")
        pre = f"{stem}_" if stem else ""
        paths["combined"] = os.path.join(output_dir, f"{pre}mask_combined.png")
        write_png(paths["combined"], combined)
        paths["visualization"] = os.path.join(output_dir, f"{pre}visualization.png")
        write_png(paths["visualization"], vis)
        paths["annotations"] = os.path.join(output_dir, f"{pre}annotations.txt")
        with open(paths["annotations"], "w") as f:
            f.write("\n".join(lines) + "\n")
        return paths
