"""Staged weight residency: a whole generation on one card whose memory
cannot hold every component and the denoise step's activations at once
(the port's counterpart of ``versecrafter_tpu.sampling.staged``).

The pipeline's dataflow is strictly sequential, so each component needs
to be resident only for its own stage:

    1. build / load umT5  -> encode the prompts   -> free umT5
    2. build / load VAE   -> encode the controls  -> free VAE
    3. build / load DiT   -> denoise (latents out) -> free DiT
    4. build / load VAE   -> decode               -> frames

Between the stages only their outputs stay on the device (the prompt
embeddings, the GeoAdapter context, the latents: tens of MB at 720p). On one
80 GB H100 this is what lets the 14B flagship run a 720x1280x81 request
with batched CFG: the resident pipeline holds umT5-xxl and the VAE beside
the DiT (see estimate_denoise_gb).

generate_staged drives an ordinary VerseCrafterPipeline whose parameter
slots start empty; fresh_init_factories (random weights from a seed) and
checkpoint_factories (a reference-layout model directory) supply the
functions that build each component. A quantized DiT is built block by block, so its whole bf16 tree
never sits on the card.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from versecrafter_tpu_torch import resolve_device
from versecrafter_tpu_torch.core.config import (
    T5Config, VAEConfig, WAN21_1_3B, WAN21_14B, WanDiTConfig, versecrafter_14b)
from versecrafter_tpu_torch.models.wan_dit import FFN_CHUNK_ROWS


@dataclasses.dataclass
class StageFactories:
    """Per-component parameter factories, each called on the pipeline's
    device when its stage begins; the result is dropped when the stage
    ends. `vae` is called twice (the encode and the decode stage)."""

    t5: Callable[[], Any]
    vae: Callable[[], Any]
    dit: Callable[[], Any]
    bits: int = 4  # the DiT's storage width (0: unquantized), which
    #                auto_cfg_parallel's memory model reads


def _free(pipe, attr: str):
    """Drops a component's parameters and returns their device memory
    before the next stage allocates."""
    setattr(pipe, attr, None)
    gc.collect()
    if pipe.device.type == "cuda":
        torch.cuda.empty_cache()


def generate_staged(
    pipe,
    factories: StageFactories,
    prompt,
    negative_prompt: str = "",
    control_videos: Optional[Sequence[np.ndarray]] = None,
    mask_video: Optional[np.ndarray] = None,
    subject_ref_images: Optional[Sequence[np.ndarray]] = None,
    height: int = 480,
    width: int = 832,
    num_frames: int = 81,
    output_type: str = "uint8",
    dtype=torch.bfloat16,
    progress: Optional[Callable[[int, int], None]] = None,
    record_teacache: bool = False,
    **call_kwargs,
):
    """One generation with staged weight residency.

    `pipe` is a VerseCrafterPipeline whose dit_params / vae_params /
    t5_params may be None; its configs must be set. The wall seconds of each
    stage (build and run, the device synchronised) go to
    pipe.last_stage_profile. call_kwargs pass through to the denoise call
    (num_inference_steps, guidance_scale, shift, seed, timesteps, ...). A
    pipeline with an expert_swap builds its experts inside the denoise
    stage, where the schedule crosses to each.

    record_teacache=True runs the DiT stage as a TeaCache trajectory
    recording (pipe.record_teacache_stats) and returns (rel_e0,
    rel_residual) for teacache.fit_teacache_coefficients; the recorded
    run's final latents, reference-frame slots stripped, are left on
    pipe.last_record_latents for the caller to decode."""
    profile: Dict[str, Any] = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        pipe._sync()
        profile[name] = round(time.perf_counter() - t0, 2)
        return out

    batch = 1 if isinstance(prompt, str) else len(prompt)

    # -- stage 1: text --------------------------------------------------------
    pipe.t5_params = timed("t5_build", factories.t5)
    embeds = timed("t5_encode",
                   lambda: pipe.encode_prompt(prompt, negative_prompt).to(dtype))
    _free(pipe, "t5_params")
    neg_embeds, pos_embeds = embeds[:batch], embeds[batch:]
    del embeds

    # -- stage 2: controls ------------------------------------------------------
    if mask_video is None:
        mask_video = np.ones((batch, 1, num_frames, height, width), np.float32)
    pipe.vae_params = timed("vae_build", factories.vae)
    geoada_context, n_ref = timed(
        "encode_controls",
        lambda: pipe.encode_controls(control_videos, mask_video, dtype,
                                     subject_ref_images=subject_ref_images))
    _free(pipe, "vae_params")

    # -- stage 3: denoise ---------------------------------------------------------
    if pipe.expert_swap is not None:
        # the experts build at the boundary crossings inside the loop; their
        # build times fall inside the denoise stage
        pipe.dit_params = None
        pipe._resident_expert = None
    else:
        pipe.dit_params = timed("dit_build", factories.dit)
    kw = dict(prompt_embeds=pos_embeds, negative_prompt_embeds=neg_embeds,
              geoada_context=geoada_context, height=height, width=width,
              num_frames=num_frames, dtype=dtype, progress=progress, **call_kwargs)
    if record_teacache:
        stats = timed("record", lambda: pipe.record_teacache_stats(**kw))
        _free(pipe, "dit_params")
        pipe._resident_expert = None
        lat = getattr(pipe, "last_record_latents", None)
        if lat is not None and n_ref:
            pipe.last_record_latents = lat[:, :, n_ref:]
        profile["total"] = round(sum(profile.values()), 2)
        pipe.last_stage_profile = profile
        return stats
    latents = timed("denoise", lambda: pipe(output_type="latent", **kw))
    del kw, geoada_context, pos_embeds, neg_embeds
    _free(pipe, "dit_params")
    pipe._resident_expert = None
    if n_ref:  # strip the prepended reference-frame slots
        latents = latents[:, :, n_ref:]

    # -- stage 4: decode --------------------------------------------------------
    pipe.vae_params = timed("vae_rebuild", factories.vae)
    video = timed("decode", lambda: pipe.decode_latents(latents, output_type))
    del latents
    _free(pipe, "vae_params")

    profile["total"] = round(sum(profile.values()), 2)
    profile["denoise_wall"] = dict(pipe.last_wall_profile)
    pipe.last_stage_profile = profile
    return video


# -- the denoise stage's memory model ------------------------------------------

@dataclasses.dataclass(frozen=True)
class MemoryModel:
    """The constants of estimate_denoise_gb: the DiT's bytes per block
    parameter by storage width, the step's activation bytes per row and
    model dim and, by storage width, per FFN row and FFN dim (a factor on
    both with a GeoAdapter), the FFN's chunking (rows above chunk_rows run
    in chunks of chunk_rows // chunk_div), and the estimate at which batched
    CFG still fits."""

    bytes_per_param: Dict[int, float]
    row_bytes: float
    ffn_row_bytes: Dict[int, float]
    geoada_factor: float
    chunk_rows: int
    chunk_div: int
    fits_gb: float


# Calibrated on an NVIDIA H100 80GB HBM3, 700.00 W (79.18 GiB;
# scripts/calibrate_torch_staged_memory.py, PERF.md §5): the 14B +
# GeoAdapter DiT alone on the card, one denoise step's peak
# (torch.cuda.max_memory_allocated, GiB) beside the estimate:
#   bf16 (41.09 resident)  480p81f CFG-2 51.27 (est 51.40), CFG-1 46.21 (46.25)
#                          720p81f CFG-2 64.52 (64.89), CFG-1 52.84 (52.99)
#   W8A8 (20.40)           480p81f CFG-2 35.78 (36.85), CFG-1 28.54 (28.63)
#                          720p81f CFG-2 44.66 (44.95), CFG-1 32.98 (33.01)
#   W4A8 (10.22)           480p81f CFG-2 25.67 (26.67), 720p81f CFG-2 34.48 (34.77)
#   bf16 + umT5-xxl + VAE (+11.05 resident) 720p81f CFG-1 63.89 (64.05),
#                          CFG-2 75.58 (75.95; 78.46 reserved)
# Every step ran; none ran out of memory. The activations grow with rows x
# dim (~25 B a row and dim element with the GeoAdapter's 1.3): the FFN
# hidden is freed before the residual update (wan_block_forward) and
# chunked above 65,520 rows, except in W8A8 / W4A8, whose s8 product keeps
# ~5.6 B an FFN element of an unchunked row block. The bar sits above the largest point
# that ran (75.95 estimated) and 3.2 GiB below the card.
CARD_MODEL = MemoryModel(
    bytes_per_param={0: 2.0932, 8: 1.0391, 4: 0.5205},
    row_bytes=25.4, ffn_row_bytes={0: 0.0, 8: 5.6, 4: 5.6}, geoada_factor=1.3,
    chunk_rows=FFN_CHUNK_ROWS, chunk_div=8, fits_gb=76.0)


def denoise_rows(tokens: int, cfg_batch: int):
    """(rows of a denoise step, rows of one FFN chunk), the chunk split as
    models/wan_dit._ffn_chunked makes it."""
    rows, m = tokens * cfg_batch, CARD_MODEL
    if rows > m.chunk_rows:
        return rows, -(-rows // -(-rows // (m.chunk_rows // m.chunk_div)))
    return rows, rows


def estimate_denoise_gb(dit_cfg: WanDiTConfig, bits: int, tokens: int,
                        cfg_batch: int = 2) -> float:
    """Estimated peak device memory (GiB) of one denoise step with only the
    DiT resident: its weights plus the step's activations, FFN chunking
    included. The JAX package's form (versecrafter_tpu/sampling/staged.py
    estimate_denoise_gb), with the card's constants and the GeoAdapter's
    blocks counted also when geoada_layers is () (every 2nd layer)."""
    model, gib = CARD_MODEL, float(1 << 30)
    d, f = dit_cfg.dim, dit_cfg.ffn_dim
    n_geo = len(dit_cfg.resolved_geoada_layers)
    params = (dit_cfg.num_layers + n_geo) * (8 * d * d + 2 * d * f)
    weights = params * model.bytes_per_param[bits] / gib
    rows, ffn_rows = denoise_rows(tokens, cfg_batch)
    act = (model.row_bytes * rows * d + model.ffn_row_bytes[bits] * ffn_rows * f) / gib
    if n_geo:
        act *= model.geoada_factor
    return weights + act


def auto_cfg_parallel(dit_cfg: WanDiTConfig, bits: int, tokens: int) -> bool:
    """Whether a staged generation runs CFG batched (one batch-2 forward a
    step) rather than sequentially (two batch-1 forwards): batched wherever
    the memory model says the batch-2 step fits."""
    return estimate_denoise_gb(dit_cfg, bits, tokens, 2) <= CARD_MODEL.fits_gb


def request_tokens(dit_cfg: WanDiTConfig, vae_cfg: VAEConfig, height: int, width: int,
                   num_frames: int) -> int:
    """The DiT's sequence length for a request of that size."""
    t_lat = (num_frames - 1) // vae_cfg.temporal_compression_ratio + 1
    s = vae_cfg.spatial_compression_ratio
    return (t_lat * (height // s // dit_cfg.patch_size[1])
            * (width // s // dit_cfg.patch_size[2]))


# -- factories ----------------------------------------------------------------

def fresh_init_factories(scale: str = "14b", bits: int = 4, int8_compute: bool = True,
                         dtype=torch.bfloat16, geoada: bool = True, seed: int = 0,
                         device=None):
    """(factories, dit_cfg, vae_cfg, t5_cfg) of a random-weight model on
    `device` (default cuda): the DiT from `seed`, the VAE (fp32) from seed +
    1, umT5 from seed + 2, as default_pipeline_factory draws them, so the
    '14b' DiT at bits=0 is that factory's DiT. bits 8 / 4 build the DiT
    quantized block by block (models/wan_dit.init_wan_dit_quantized; W8A8 /
    W4A8 with int8_compute).

    '14b' is the reference flagship's components (umT5-xxl, the Wan2.1 VAE,
    Wan2.1-T2V-14B + GeoAdapter); '1.3b' and 'tiny' shrink the DiT and umT5
    for smokes ('tiny' has head_dim 16 and runs on the CPU only)."""
    if scale == "14b":
        dit_cfg = versecrafter_14b() if geoada else WAN21_14B
        t5_cfg = T5Config()
    elif scale == "1.3b":
        t5_cfg = T5Config(num_layers=2, dim=512, dim_attn=512, dim_ffn=1024,
                          num_heads=8, vocab=1024)
        dit_cfg = dataclasses.replace(
            WAN21_1_3B, text_dim=t5_cfg.dim,
            **(dict(geoada_layers=(), geoada_in_dim=128) if geoada else {}))
    elif scale == "tiny":
        t5_cfg = T5Config(num_layers=2, dim=64, dim_attn=64, dim_ffn=128,
                          num_heads=4, vocab=512)
        dit_cfg = WanDiTConfig(
            dim=128, ffn_dim=256, num_heads=8, num_layers=4, text_dim=t5_cfg.dim,
            **(dict(geoada_layers=(), geoada_in_dim=128) if geoada else {}))
    else:
        raise ValueError(f"unknown scale {scale!r}")
    vae_cfg = VAEConfig()
    dev = resolve_device(device)

    def gen(offset):
        return torch.Generator(device=dev).manual_seed(seed + offset)

    def t5_factory():
        from versecrafter_tpu_torch.models.t5 import init_t5
        return init_t5(t5_cfg, gen(2), dtype)

    def vae_factory():
        from versecrafter_tpu_torch.models.vae import init_vae
        return init_vae(vae_cfg, gen(1), torch.float32)

    def dit_factory():
        from versecrafter_tpu_torch.models.wan_dit import init_wan_dit, init_wan_dit_quantized
        if bits:
            return init_wan_dit_quantized(dit_cfg, gen(0), dtype, bits=bits,
                                          int8_compute=int8_compute)
        return init_wan_dit(dit_cfg, gen(0), dtype)

    return (StageFactories(t5_factory, vae_factory, dit_factory, bits),
            dit_cfg, vae_cfg, t5_cfg)


def staged_pipeline_factory(model_path: Optional[str] = None, scale: str = "14b",
                            bits: int = 4, int8_compute: bool = True,
                            scheduler: str = "unipc", device=None):
    """(shell pipeline factory, StageFactories) for serving with staged
    residency: the pipeline holds the configs only, and each request builds
    and frees the weights stage by stage (checkpoint_factories with a
    `model_path`, else fresh_init_factories at `scale`)."""
    if model_path:
        factories, dit_cfg, vae_cfg, t5_cfg = checkpoint_factories(
            model_path, bits=bits, int8_compute=int8_compute, device=device)
    else:
        factories, dit_cfg, vae_cfg, t5_cfg = fresh_init_factories(
            scale=scale, bits=bits, int8_compute=int8_compute, device=device)

    def factory():
        from versecrafter_tpu_torch.sampling.pipeline import VerseCrafterPipeline
        return VerseCrafterPipeline(
            dit_params=None, dit_cfg=dit_cfg, vae_params=None, vae_cfg=vae_cfg,
            t5_params=None, t5_cfg=t5_cfg, scheduler_name=scheduler,
            cfg_parallel=False, device=device)

    return factory, factories


def checkpoint_factories(model_dir: str, transformer_path: Optional[str] = None,
                         geoada_in_dim: int = 128, bits: int = 4,
                         int8_compute: bool = True, dtype=torch.bfloat16, device=None):
    """(factories, dit_cfg, vae_cfg, t5_cfg) reading each component from a
    reference-layout model directory when its stage begins (the staged
    counterpart of core.convert.load_versecrafter). A quantized DiT is
    converted on the host and then moved and quantized block by block
    (utils/quantize.quantize_dit_block), so its bf16 tree never sits on the
    device; an unquantized one is read straight onto the device."""
    import os

    from versecrafter_tpu_torch.core.convert import (
        _dit_config, convert_wan_dit, convert_wan_t5, convert_wan_vae, load_dit,
        load_torch_state_dict)
    from versecrafter_tpu_torch.sampling.pipeline import _to_device
    from versecrafter_tpu_torch.utils import quantize as qz

    tdir = transformer_path or model_dir
    dit_cfg = _dit_config(tdir, geoada_in_dim)
    t5_cfg, vae_cfg = T5Config(), VAEConfig()
    dev = resolve_device(device)

    def t5_factory():
        return convert_wan_t5(load_torch_state_dict(
            os.path.join(model_dir, "models_t5_umt5-xxl-enc-bf16.pth")), t5_cfg, dtype, dev)[0]

    def vae_factory():
        return convert_wan_vae(load_torch_state_dict(
            os.path.join(model_dir, "Wan2.1_VAE.pth")), vae_cfg, torch.float32, dev)[0]

    def dit_factory():
        if not bits:
            return load_dit(tdir, dit_cfg, dtype, dev)
        host, _ = convert_wan_dit(load_torch_state_dict(tdir), dit_cfg, dtype, "cpu")
        out = {}
        for name, sub in host.items():
            if isinstance(sub, list):
                out[name] = []
                for i in range(len(sub)):
                    blk, sub[i] = sub[i], None  # the host copy goes as it moves
                    out[name].append(qz.quantize_dit_block(
                        _to_device(blk, dev), name, i, len(sub), bits, int8_compute))
            else:
                out[name] = qz.quantize_dit_top({name: _to_device(sub, dev)}, bits,
                                                int8_compute)[name]
        return out

    return (StageFactories(t5_factory, vae_factory, dit_factory, bits),
            dit_cfg, vae_cfg, t5_cfg)
