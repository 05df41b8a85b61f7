"""CLI: text-prompted segmentation (step 2 of the reference's pipeline).

    python -m versecrafter_tpu_torch.cli.segment -i <image> -t "car. person." \
        -o <dir> [--backend neural --neural_fresh_init] [--device cpu]

The JAX package's flags; --device (the neural backend's) defaults to cuda.
Writes masks/mask_{id:02d}_{label}.png, mask_combined.png,
annotations.txt and visualization.png, through the port's codecs
(utils/video.py). Neither backend needs OpenCV: the saliency backend's
blur, k-means and connected components are utils/cvops.py's.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="Text-prompted segmentation (PyTorch)")
    p.add_argument("--image", "-i", required=True)
    p.add_argument("--text", "-t", required=True, help="e.g. 'car. person.'")
    p.add_argument("--output", "-o", default="./output")
    p.add_argument("--depth_npz", default=None,
                   help="optional depth to assist the saliency backend")
    p.add_argument("--backend", default="saliency")
    p.add_argument("--box_threshold", type=float, default=0.25)
    p.add_argument("--text_threshold", type=float, default=0.25)
    p.add_argument("--max_objects", type=int, default=5)
    p.add_argument("--sam2_checkpoint", default=None,
                   help="HF Sam2Model (or SamModel for --mask_backend sam1) torch state dict")
    p.add_argument("--gdino_checkpoint", default=None,
                   help="HF GroundingDinoForObjectDetection torch state dict")
    p.add_argument("--bert_vocab", default=None, help="BERT vocab.txt for the text tower")
    p.add_argument("--mask_backend", default="sam2", choices=["sam2", "sam1"])
    p.add_argument("--neural_fresh_init", action="store_true",
                   help="random full-width weights (Swin-T 896, Hiera-L 1024)")
    p.add_argument("--gdino_bf16", action="store_true",
                   help="the detector in bf16 (locations, softmaxes and the box "
                        "recursion stay fp32)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np

    from versecrafter_tpu_torch.perception.segmenter import ImageSegmenter
    from versecrafter_tpu_torch.utils.video import read_image

    img = read_image(args.image)
    depth = None
    if args.depth_npz:
        d = np.load(args.depth_npz)["depth"].astype(np.float32)
        depth = d[0] if d.ndim == 3 else d
    kw = dict(box_threshold=args.box_threshold, text_threshold=args.text_threshold,
              max_objects=args.max_objects)
    if args.backend == "neural":
        seg = ImageSegmenter.build_neural(
            sam2_checkpoint=args.sam2_checkpoint, gdino_checkpoint=args.gdino_checkpoint,
            bert_vocab=args.bert_vocab, mask_backend=args.mask_backend,
            fresh_init=args.neural_fresh_init, gdino_bf16=args.gdino_bf16,
            device=args.device, **kw)
    else:
        seg = ImageSegmenter(backend=args.backend, **kw)
    dets = seg.segment_image(img, args.text, depth=depth)
    seg.save_results(img, dets, args.output)
    print(f"segmented {len(dets)} objects -> {args.output}")
    return dets


if __name__ == "__main__":
    main()
