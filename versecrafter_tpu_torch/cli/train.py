"""CLI: GeoAdapter (or LoRA) finetuning of the Wan DiT on one device.

    python -m versecrafter_tpu_torch.cli.train --tiny --synthetic 4 --steps 3 --device cpu
    python -m versecrafter_tpu_torch.cli.train --synthetic 1 --steps 10    # 1.3B, 480x832x81, GPU
    python -m versecrafter_tpu_torch.cli.train --synthetic 1 --steps 3 --lora_rank 16
    torchrun --standalone --nproc_per_node 4 -m versecrafter_tpu_torch.cli.train \
        --synthetic 2 --batch_size 2 --dp 2 --sp 2 --steps 3       # 4 GPUs
    torchrun --standalone --nproc_per_node 2 -m versecrafter_tpu_torch.cli.train \
        --tiny --synthetic 2 --steps 3 --sp 2 --device cpu         # gloo

The flags are the JAX package's cli/train.py flags plus --device (default
cuda). It trains on --synthetic N random-latent samples: the default model
is Wan2.1-1.3B + GeoAdapter (15 blocks, 128 control channels) from a random
init with an un-zeroed head, in bf16; --model_name starts from the DiT of a
reference-layout model directory (core.convert.load_versecrafter, 128
control channels); --tiny is a small fp32 model (head_dim 16, so it runs on
the CPU, or on the card with --attn_impl xla: the kernels take head_dim
128). --attn_impl picks the attention path as the JAX CLI's does (auto,
pallas: the kernels, xla: the reference math). The trainable tree is saved
through core/checkpoint.py as the directory <output_dir>/step_%06d
({"params": tree}) in the JAX package's layout, which the JAX CLI's own
orbax load_checkpoint restores (and core/checkpoint.load_checkpoint reads).

--lora_rank r > 0 trains LoRA factors (utils/lora.py) of rank r over every
block's attention and FFN kernels, base and GeoAdapter, with the whole base
tree frozen, at scale (lora_alpha or r) / r; the factors start from the
threefry key(seed + 5), as the JAX CLI's do. Beside each checkpoint of
the factors, step_%06d_lora.safetensors holds them in the dotted LoRA
naming that cli/inference.py --lora_path (merge_lora) reads.

--data_dir trains on a directory of clip directories (video.mp4, the four
control maps, merged_mask.mp4, prompt.txt), each VAE / umT5-encoded once
through --model_name's pipeline and cached beside the clip as
latent_cache_{h}x{w}x{n}.npz (the JAX CLI's file: either package reads the
other's).

--dp / --fsdp / --sp / --tp train on a mesh: one process per device under
torchrun (NCCL on the card, gloo with --device cpu), the world's size the
mesh's. The DiT is sharded (parallel/sharding.shard_dit_params), each rank
keeps its batch rows (dp) and sequence slice (sp) of the tokens, the
gradients are summed over dp and sp, and rank 0 prints and saves the
trained tree made whole.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GeoAdapter finetuning (PyTorch)")
    p.add_argument("--data_dir", type=str, default=None,
                   help="Directory of clip dirs (needs --model_name to encode them)")
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
                   choices=("auto", "pallas", "xla"),
                   help="auto: the kernels on the card, their plain versions "
                        "on the CPU; pallas: the kernels (the card only); "
                        "xla: the reference attention math on any device. "
                        "Under --sp > 1 the sequence-parallel path runs, "
                        "as in the JAX CLI")
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


def attention_impl(args, dev) -> str:
    """The blocks' attn_impl: the JAX CLI's "sp" under sp > 1 (the port's
    mesh path, whose local attention is then 'auto'), else --attn_impl;
    ValueError for 'pallas' off the card."""
    if args.sp > 1:
        return "auto"
    if args.attn_impl == "pallas" and dev.type != "cuda":
        raise ValueError(f"--attn_impl pallas runs the CUDA kernels, not on {dev.type}")
    return args.attn_impl


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
    """(cfg, params, pipe) the run starts from: --model_name's pipeline and
    its DiT, or the random init of --tiny / the default model from --seed
    (pipe None)."""
    import torch

    from versecrafter_tpu_torch.models.wan_dit import init_wan_dit

    if args.model_name and not args.tiny:  # a converted checkpoint's trained head
        from versecrafter_tpu_torch.core import convert
        pipe = convert.load_versecrafter(args.model_name, geoada_in_dim=128, device=dev)
        return pipe.dit_cfg, pipe.dit_params, pipe
    cfg, dtype = ((tiny_config(), torch.float32) if args.tiny
                  else (default_config(), torch.bfloat16))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    return cfg, unzero_head(init_wan_dit(cfg, gen, dtype), args.seed + 7), None


CLIP_CONTROLS = ("background_RGB.mp4", "background_depth.mp4",
                 "3D_gaussian_RGB.mp4", "3D_gaussian_depth.mp4")


def _encode_clip(pipe, clip_dir: str, h: int, w: int, n: int):
    """(x0 latents, GeoAdapter context, prompt embedding) of one clip, fp32
    numpy without the batch axis: read from latent_cache_{h}x{w}x{n}.npz
    beside the clip, else encoded (the four control maps, a missing one
    after the first as zeros; the merged mask, or all ones; the target
    video through the VAE; prompt.txt through umT5, its positive half) and
    cached there."""
    import numpy as np
    import torch

    cache = os.path.join(clip_dir, f"latent_cache_{h}x{w}x{n}.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        return z["x0"], z["geo"], z["ctx"]

    from versecrafter_tpu_torch.utils.video import load_video

    controls = []
    for name in CLIP_CONTROLS:
        path = os.path.join(clip_dir, name)
        if os.path.exists(path):
            controls.append(load_video(path, num_frames=n, size=(h, w)))
        elif controls:
            controls.append(np.zeros_like(controls[0]))
    mask_p = os.path.join(clip_dir, "merged_mask.mp4")
    mask = (load_video(mask_p, num_frames=n, size=(h, w))[:, :1]
            if os.path.exists(mask_p) else np.ones((1, 1, n, h, w), np.float32))
    geo, _ = pipe.encode_controls(controls, mask)
    target = load_video(os.path.join(clip_dir, "video.mp4"), num_frames=n, size=(h, w))
    with torch.no_grad():
        x0 = pipe._vae_encode(torch.as_tensor(target, device=pipe.device) * 2.0 - 1.0)
    prompt_path = os.path.join(clip_dir, "prompt.txt")
    prompt = open(prompt_path).read().strip() if os.path.exists(prompt_path) else ""
    ctx = pipe.encode_prompt(prompt)[1:]  # positive half only
    x0, geo, ctx = (t.float().cpu().numpy() for t in (x0, geo, ctx))
    # each rank of a world writes its own file and renames it into place
    tmp = f"{cache[:-4]}.{os.getpid()}.npz"
    np.savez_compressed(tmp, x0=x0[0], geo=geo[0], ctx=ctx[0])
    os.replace(tmp, cache)
    return x0[0], geo[0], ctx[0]


def main(argv=None):
    return run(parse_args(argv))["losses"]


def run(args):
    """The training run of parsed args -> {"losses", "step_s" (each step's
    seconds, its batch upload included), "params" (the whole tree), "train"
    (the trained tree: GeoAdapter / all params, or the LoRA factors)}."""
    import numpy as np
    import torch

    from versecrafter_tpu_torch import resolve_device
    from versecrafter_tpu_torch.core.mesh import MeshSpec, check_world, make_mesh
    from versecrafter_tpu_torch.parallel import sharding as shd
    from versecrafter_tpu_torch.utils.cache import maybe_init_distributed, wait_all
    from versecrafter_tpu_torch.core.checkpoint import save_checkpoint
    from versecrafter_tpu_torch.core.convert import save_safetensors
    from versecrafter_tpu_torch.kernels.rope import grid_cos_sin, rope_3d_angles
    from versecrafter_tpu_torch.parallel.train_step import (
        make_lora_train_step, make_optimizer, make_train_step, split_trainable,
        tree_leaves)
    from versecrafter_tpu_torch.utils import prng
    from versecrafter_tpu_torch.utils.lora import init_lora, lora_to_torch_sd

    dev = resolve_device(args.device)
    maybe_init_distributed(dev)
    spec = MeshSpec(dp=args.dp, fsdp=args.fsdp, sp=args.sp, tp=args.tp)
    check_world(spec)  # before any build
    attn = attention_impl(args, dev)
    h, w = (int(x) for x in args.sample_size.split(","))
    n_frames = args.video_length
    cfg, params, pipe = build_model(args, dev)

    # -- mesh + sharding: one rank per device of the (dp, fsdp, sp, tp) mesh
    mesh = make_mesh(spec, dev) if spec.size > 1 else None
    lead = mesh is None or mesh.rank == 0
    lora = None
    if args.lora_rank > 0:  # the factors of the whole kernels, before sharding
        lora = init_lora(params, args.lora_rank, prng.key(args.seed + 5, dev),
                         groups=("blocks", "geoada_blocks"))
    if mesh is not None:
        shd.check_dit_mesh(cfg, mesh)
        params = shd.shard_dit_params(params, mesh)
        if pipe is not None:
            # umT5 and the VAE stay whole, as in the JAX CLI, so each rank
            # encodes clips alone; the whole DiT is dropped
            pipe.dit_params = None
    if lora is not None:
        lora_scale = (args.lora_alpha or args.lora_rank) / args.lora_rank
        train = lora
        opt = make_optimizer(train, args.lr, args.weight_decay)
        lora_step = make_lora_train_step(cfg, opt, lora_scale, attn_impl=attn)

        def step_fn(params, *a, **kw):
            return lora_step(train, params, *a, **kw)
        mode = f"LoRA rank {args.lora_rank} (scale {lora_scale:g})"
    else:
        train, _frozen = split_trainable(params, geoadapter_only=not args.train_full)
        step_fn = make_train_step(cfg, make_optimizer(train, args.lr, args.weight_decay),
                                  attn_impl=attn)
        mode = "full model" if args.train_full else "GeoAdapter only"
    log = print if lead else (lambda *a, **k: None)
    n_train = sum(t.numel() for t in tree_leaves(train))
    where = f"{dev}" if mesh is None else f"{dev}, mesh {spec.shape} (rank-local shards)"
    log(f"trainable params: {n_train / 1e6:.1f}M ({mode}) on {where}")

    # -- data: synthetic, drawn as the JAX CLI draws it, or encoded clips
    stride = ((4, 8, 8) if pipe is None else
              (pipe.vae_cfg.temporal_compression_ratio, pipe.vae_cfg.spatial_compression_ratio,
               pipe.vae_cfg.spatial_compression_ratio))
    t_lat = (n_frames - 1) // stride[0] + 1
    h_lat, w_lat = h // stride[1], w // stride[2]
    gin = cfg.resolved_geoada_in_dim
    if args.synthetic or args.data_dir is None:
        n_samples = max(args.synthetic, args.batch_size)
        rng = np.random.default_rng(args.seed)
        data = [(rng.standard_normal((cfg.in_dim, t_lat, h_lat, w_lat)),
                 rng.standard_normal((gin, t_lat, h_lat, w_lat)),
                 rng.standard_normal((cfg.text_len, cfg.text_dim)))
                for _ in range(n_samples)]
        log(f"synthetic dataset: {n_samples} samples latents {data[0][0].shape}")
    else:
        if pipe is None:
            raise SystemExit("--data_dir needs --model_name (VAE/T5 weights to encode "
                             "clips); use --synthetic otherwise")
        clips = sorted(d for d in os.listdir(args.data_dir)
                       if os.path.isdir(os.path.join(args.data_dir, d)))
        data = [_encode_clip(pipe, os.path.join(args.data_dir, c), h, w, n_frames)
                for c in clips]
        log(f"encoded {len(data)} clips from {args.data_dir}")

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
    wait_all()  # each rank encoded its clips alone
    with shd.mesh_context(mesh):
        for i in range(args.steps):
            idx = sampler.integers(0, len(data), args.batch_size)
            t0 = time.perf_counter()
            loss = step_fn(params, batch(idx, 0), batch(idx, 2), cos, sin, batch(idx, 1),
                           key=prng.key(args.seed + 2 + i, dev))
            losses.append(float(loss))  # waits for the step
            step_s.append(time.perf_counter() - t0)
            if (i + 1) % args.log_every == 0 or i == 0:
                recent = losses[-args.log_every:]
                log(f"step {i + 1}/{args.steps} loss {sum(recent) / len(recent):.4f}",
                    flush=True)
            if (i + 1) % args.save_every == 0 or i + 1 == args.steps:
                whole = _whole(train)  # every rank joins the gathers
                if lead:
                    path = os.path.join(args.output_dir, f"step_{i + 1:06d}")
                    save_checkpoint(path, {"params": whole})
                    if args.lora_rank > 0:
                        save_safetensors(path + "_lora.safetensors", lora_to_torch_sd(whole))
                    log(f"saved {path}", flush=True)
                del whole
                wait_all()  # the next step's collectives wait for rank 0's save
    log(f"final loss {losses[-1]:.4f}")
    return {"losses": losses, "step_s": step_s, "params": params, "train": train}


def _whole(tree):
    """The tree with each sharded leaf gathered whole (a no-op off a mesh)."""
    from versecrafter_tpu_torch.parallel.sharding import gathered
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_whole(v) for v in tree)
    return gathered(tree).detach()


if __name__ == "__main__":
    main()
