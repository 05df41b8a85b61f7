"""CLI: GeoAdapter (or LoRA) finetuning of the Wan DiT on one device.

    python -m versecrafter_tpu_torch.cli.train --tiny --synthetic 4 --steps 3 --device cpu
    python -m versecrafter_tpu_torch.cli.train --synthetic 1 --steps 10    # 1.3B, 480x832x81, GPU
    python -m versecrafter_tpu_torch.cli.train --synthetic 1 --steps 3 --lora_rank 16

The flags are the JAX package's cli/train.py flags plus --device (default
cuda). It trains on --synthetic N random-latent samples: the default model
is Wan2.1-1.3B + GeoAdapter (15 blocks, 128 control channels) from a random
init with an un-zeroed head, in bf16; --model_name starts from the DiT of a
reference-layout model directory (core.convert.load_versecrafter, 128
control channels); --tiny is a small fp32 model (head_dim 16, so it runs on
the CPU only: the kernels take head_dim 128). The trainable tree is saved
through core/checkpoint.py as <output_dir>/step_%06d.pt ({"params": tree}).

--lora_rank r > 0 trains LoRA factors (utils/lora.py) of rank r over every
block's attention and FFN kernels, base and GeoAdapter, with the whole base
tree frozen, at scale (lora_alpha or r) / r; the factors start from the
threefry key(seed + 5), as the JAX CLI's do. Beside each checkpoint of
the factors, step_%06d_lora.safetensors holds them in the dotted LoRA
naming that cli/inference.py --lora_path (merge_lora) reads.

Not ported yet (each raises NotImplementedError): --data_dir (the VAE/T5
encode of clips) and any mesh axis > 1 (parallelism).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GeoAdapter finetuning (PyTorch)")
    p.add_argument("--data_dir", type=str, default=None,
                   help="Directory of clip dirs (not ported yet)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="Train on N synthetic samples")
    p.add_argument("--output_dir", type=str, default="outputs/train")
    p.add_argument("--model_name", type=str, default=None,
                   help="Reference-layout model dir to start from")
    p.add_argument("--tiny", action="store_true",
                   help="Tiny random-init fp32 model (CPU smoke tests)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=1e-2)
    p.add_argument("--sample_size", type=str, default="480,832")
    p.add_argument("--video_length", type=int, default=81)
    p.add_argument("--lora_rank", type=int, default=0,
                   help="> 0: LoRA finetuning: only low-rank factors over the "
                        "block matmuls train (the whole base frozen); each "
                        "checkpoint also exports step_N_lora.safetensors")
    p.add_argument("--lora_alpha", type=float, default=None,
                   help="LoRA scale numerator (default = rank -> scale 1)")
    p.add_argument("--train_full", action="store_true",
                   help="Train the full model (default: GeoAdapter only)")
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--attn_impl", type=str, default="auto",
                   help="only 'auto': the kernels on the card, their plain "
                        "versions on the CPU")
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0,
                   help="init from torch generators seeded with seed (weights) "
                        "and seed + 7 (head); synthetic data from numpy "
                        "seed and seed + 1 (sampling); step i draws its noise "
                        "level and noise from the threefry key(seed + 2 + i) "
                        "and LoRA factors from key(seed + 5), as the JAX CLI "
                        "does")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def _check_ported(args):
    if args.data_dir is not None:
        raise NotImplementedError(
            "--data_dir waits for the VAE/T5 clip encode (ROADMAP queue 1, "
            "item 11); use --synthetic")
    if max(args.dp, args.fsdp, args.sp, args.tp) > 1:
        raise NotImplementedError("mesh training (dp/fsdp/sp/tp) waits for the "
                                  "parallelism port (ROADMAP queue 1, item 11)")
    if args.attn_impl != "auto":
        raise NotImplementedError(f"--attn_impl {args.attn_impl}: the port has "
                                  "one attention path ('auto')")


def tiny_config():
    """The JAX CLI's --tiny model."""
    from versecrafter_tpu_torch.core.config import WanDiTConfig
    return WanDiTConfig(in_dim=4, dim=64, ffn_dim=128, freq_dim=32, text_dim=48,
                        out_dim=4, num_heads=4, num_layers=4, text_len=16,
                        geoada_layers=(), geoada_in_dim=8)


def default_config():
    """The JAX CLI's default model: Wan2.1-1.3B + GeoAdapter, 128 control
    channels."""
    from versecrafter_tpu_torch.core.config import WAN21_1_3B
    return dataclasses.replace(WAN21_1_3B, geoada_layers=(), geoada_in_dim=128)


def unzero_head(params, seed: int):
    """The reference's zero-init head blocks every upstream gradient; a
    converted checkpoint has a trained head, a random init gets N(0, 0.02)."""
    import torch
    w = params["head"]["head"]["kernel"]
    g = torch.Generator(device=w.device).manual_seed(seed)
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=g, device=w.device) * 0.02)
    return params


def build_model(args, dev):
    """(cfg, params) the run starts from: --model_name's DiT, or the random
    init of --tiny / the default model from --seed."""
    import torch

    from versecrafter_tpu_torch.models.wan_dit import init_wan_dit

    if args.model_name and not args.tiny:  # a converted checkpoint's trained head
        from versecrafter_tpu_torch.core.convert import load_versecrafter
        pipe = load_versecrafter(args.model_name, geoada_in_dim=128, device=dev)
        return pipe.dit_cfg, pipe.dit_params
    cfg, dtype = ((tiny_config(), torch.float32) if args.tiny
                  else (default_config(), torch.bfloat16))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    return cfg, unzero_head(init_wan_dit(cfg, gen, dtype), args.seed + 7)


def main(argv=None):
    return run(parse_args(argv))["losses"]


def run(args):
    """The training run of parsed args -> {"losses", "step_s" (each step's
    seconds, its batch upload included), "params" (the whole tree), "train"
    (the trained tree: GeoAdapter / all params, or the LoRA factors)}."""
    _check_ported(args)

    import numpy as np
    import torch

    from versecrafter_tpu_torch import resolve_device
    from versecrafter_tpu_torch.core.checkpoint import save_checkpoint
    from versecrafter_tpu_torch.core.convert import save_safetensors
    from versecrafter_tpu_torch.kernels.rope import grid_cos_sin, rope_3d_angles
    from versecrafter_tpu_torch.parallel.train_step import (
        make_lora_train_step, make_optimizer, make_train_step, split_trainable,
        tree_leaves)
    from versecrafter_tpu_torch.utils import prng
    from versecrafter_tpu_torch.utils.lora import init_lora, lora_to_torch_sd

    dev = resolve_device(args.device)
    h, w = (int(x) for x in args.sample_size.split(","))
    n_frames = args.video_length
    cfg, params = build_model(args, dev)
    if args.lora_rank > 0:
        lora_scale = (args.lora_alpha or args.lora_rank) / args.lora_rank
        train = init_lora(params, args.lora_rank, prng.key(args.seed + 5, dev),
                          groups=("blocks", "geoada_blocks"))
        opt = make_optimizer(train, args.lr, args.weight_decay)
        lora_step = make_lora_train_step(cfg, opt, lora_scale)

        def step_fn(params, *a, **kw):
            return lora_step(train, params, *a, **kw)
        mode = f"LoRA rank {args.lora_rank} (scale {lora_scale:g})"
    else:
        train, _frozen = split_trainable(params, geoadapter_only=not args.train_full)
        step_fn = make_train_step(cfg, make_optimizer(train, args.lr, args.weight_decay))
        mode = "full model" if args.train_full else "GeoAdapter only"
    n_train = sum(t.numel() for t in tree_leaves(train))
    print(f"trainable params: {n_train / 1e6:.1f}M ({mode}) on {dev}")

    # synthetic data, drawn as the JAX CLI draws it
    t_lat = (n_frames - 1) // 4 + 1
    h_lat, w_lat = h // 8, w // 8
    gin = cfg.resolved_geoada_in_dim
    n_samples = max(args.synthetic, args.batch_size)
    rng = np.random.default_rng(args.seed)
    data = [(rng.standard_normal((cfg.in_dim, t_lat, h_lat, w_lat)),
             rng.standard_normal((gin, t_lat, h_lat, w_lat)),
             rng.standard_normal((cfg.text_len, cfg.text_dim)))
            for _ in range(n_samples)]
    print(f"synthetic dataset: {n_samples} samples latents {data[0][0].shape}")

    pt, ph, pw = cfg.patch_size
    cos, sin = grid_cos_sin(rope_3d_angles(cfg.head_dim), t_lat // pt,
                            h_lat // ph, w_lat // pw, device=dev)

    dtype = params["patch_embedding"]["kernel"].dtype

    def batch(idx, k):
        return torch.as_tensor(np.stack([data[j][k] for j in idx]),
                               dtype=torch.float32, device=dev).to(dtype)

    os.makedirs(args.output_dir, exist_ok=True)
    sampler = np.random.default_rng(args.seed + 1)
    losses, step_s = [], []
    for i in range(args.steps):
        idx = sampler.integers(0, len(data), args.batch_size)
        t0 = time.perf_counter()
        loss = step_fn(params, batch(idx, 0), batch(idx, 2), cos, sin, batch(idx, 1),
                       key=prng.key(args.seed + 2 + i, dev))
        losses.append(float(loss))  # waits for the step
        step_s.append(time.perf_counter() - t0)
        if (i + 1) % args.log_every == 0 or i == 0:
            recent = losses[-args.log_every:]
            print(f"step {i + 1}/{args.steps} loss {sum(recent) / len(recent):.4f}",
                  flush=True)
        if (i + 1) % args.save_every == 0 or i + 1 == args.steps:
            path = os.path.join(args.output_dir, f"step_{i + 1:06d}")
            save_checkpoint(path + ".pt", {"params": train})
            if args.lora_rank > 0:
                save_safetensors(path + "_lora.safetensors", lora_to_torch_sd(train))
            print(f"saved {path}.pt", flush=True)
    print(f"final loss {losses[-1]:.4f}")
    return {"losses": losses, "step_s": step_s, "params": params, "train": train}


if __name__ == "__main__":
    main()
