"""Perception: monocular geometry (MoGe-v2 on a DINOv2 / ViT backbone) and
text-prompted segmentation (Grounding DINO boxes -> SAM 2.1 / SAM masks),
the port's counterparts of ``versecrafter_tpu.perception``. Plain PyTorch
ops (cuBLAS matmuls, cuDNN convolutions, attention as einsum + fp32
softmax): the JAX package reaches no Pallas kernel here either. fp32
forwards run with TF32 off (`_ops.full_fp32`), as the JAX package runs
them at full precision."""
