"""End-to-end controlled video generation: umT5 prompt encoding, VAE
encoding of the 4 control videos plus the 8x8 pixel-shuffled mask (the
GeoAdapter context), the UniPC + batched-CFG denoise loop over the Wan DiT,
and the VAE decode.

Not ported yet (each raises NotImplementedError when asked for): TeaCache,
cfg-skip, sequential CFG and its host-gated path, MoE experts, the device
mesh, and the i2v / CLIP / camera / masked-init-video / reference-image
extras.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from versecrafter_tpu_torch import resolve_device
from versecrafter_tpu_torch.core.config import (
    SchedulerConfig, T5Config, VAEConfig, WanDiTConfig)
from versecrafter_tpu_torch.kernels.rope import grid_cos_sin, rope_3d_angles
from versecrafter_tpu_torch.models.t5 import t5_encode
from versecrafter_tpu_torch.models.vae import vae_decode, vae_encode
from versecrafter_tpu_torch.models.wan_dit import wan_dit_forward
from versecrafter_tpu_torch.sampling.schedulers import make_scheduler
from versecrafter_tpu_torch.utils import prng
from versecrafter_tpu_torch.utils.tokenizer import load_tokenizer


def encode_mask_pixelshuffle(mask: torch.Tensor, latent_t: int,
                             vae_stride=(4, 8, 8)) -> torch.Tensor:
    """[B, 1, T, H, W] binary mask -> [B, sh*sh, latent_t, H/sh, W/sh]:
    sh x sh spatial pixel-shuffle into channels + nearest-exact temporal
    resize."""
    b, _, t, h, w = mask.shape
    sh = vae_stride[1]
    hh, ww = h // sh, w // sh
    m = mask[:, 0].reshape(b, t, hh, sh, ww, sh)
    m = m.permute(0, 3, 5, 1, 2, 4).reshape(b, sh * sh, t, hh, ww)
    idx = torch.floor((torch.arange(latent_t, dtype=torch.float32) + 0.5)
                      * t / latent_t).long().clamp(0, t - 1)
    return m.index_select(2, idx.to(m.device))


def cfg_combine(uncond: torch.Tensor, cond: torch.Tensor,
                guidance_scale: float) -> torch.Tensor:
    """uncond + g * (cond - uncond) in fp32, the difference included, as the
    jitted JAX step computes it (its fp32 guidance keeps the bf16
    predictions' difference unrounded)."""
    g = float(np.float32(guidance_scale))
    return uncond.float() + g * (cond.float() - uncond.float())


def _to_device(tree, device):
    """A copy of a tensor tree on `device`, detached from autograd."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.detach().to(device)


def _not_ported(name: str):
    raise NotImplementedError(f"{name} is not ported to versecrafter_tpu_torch yet")


@dataclasses.dataclass
class VerseCrafterPipeline:
    """Holds params + configs on one device; orchestrates the stages."""

    dit_params: Any
    dit_cfg: WanDiTConfig
    vae_params: Any
    vae_cfg: VAEConfig
    t5_params: Any
    t5_cfg: T5Config
    tokenizer: Any = None
    scheduler_name: str = "unipc"
    scheduler_cfg: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.tokenizer is None:
            self.tokenizer = load_tokenizer(vocab_size=self.t5_cfg.vocab)
        self.dit_params = _to_device(self.dit_params, self.device)
        self.vae_params = _to_device(self.vae_params, self.device)
        if self.t5_params is not None:
            self.t5_params = _to_device(self.t5_params, self.device)
        self._angles = rope_3d_angles(self.dit_cfg.head_dim,
                                      self.dit_cfg.rope_max_pos,
                                      self.dit_cfg.rope_theta)
        self.last_wall_profile: Dict[str, float] = {}

    # -- accelerations of the JAX pipeline that wait for a later slice ----
    def enable_teacache(self, *args, **kwargs):
        _not_ported("TeaCache")

    def enable_cfg_skip(self, *args, **kwargs):
        _not_ported("cfg-skip")

    def enable_int8_attention(self, enabled: bool = True):
        """int8 QK^T scoring inside the fused self-attention kernel
        (per-(row, head) int8 q~/k~ codes, PV in bf16): an inference
        approximation to opt into after judging quality. Module-global:
        sets wan_dit.INT8_QK_SCORE."""
        from versecrafter_tpu_torch.models import wan_dit
        wan_dit.INT8_QK_SCORE = bool(enabled)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- stages ----------------------------------------------------------
    def encode_prompt(self, prompt, negative_prompt="") -> torch.Tensor:
        """-> [2B, text_len, text_dim]: negatives first, then positives."""
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        negs = ([negative_prompt] * len(prompts)
                if isinstance(negative_prompt, str) else list(negative_prompt))
        return self.encode_texts(negs + prompts)

    @torch.no_grad()
    def encode_texts(self, texts) -> torch.Tensor:
        """-> [len(texts), text_len, text_dim], one T5 pass."""
        toks = self.tokenizer(list(texts), max_length=self.t5_cfg.text_length)
        ids = torch.as_tensor(toks["input_ids"], device=self.device)
        mask = torch.as_tensor(toks["attention_mask"], device=self.device)
        return t5_encode(self.t5_params, self.t5_cfg, ids, mask)

    @torch.no_grad()
    def encode_controls(self, control_videos: Sequence[np.ndarray],
                        mask_video: np.ndarray, dtype=torch.bfloat16) -> torch.Tensor:
        """control_videos: list of [B, 3, T, H, W] in [0, 1]; mask_video
        [B, 1, T, H, W] -> geoada context [B, n*z + s*s, T', H/s, W/s]."""
        lat = []
        for cv in control_videos:
            x = torch.as_tensor(np.asarray(cv), device=self.device).to(dtype)
            lat.append(vae_encode(self.vae_params, self.vae_cfg, x * 2.0 - 1.0).to(dtype))
            del x
        zs = torch.cat(lat, dim=1)
        stride = (self.vae_cfg.temporal_compression_ratio,
                  self.vae_cfg.spatial_compression_ratio,
                  self.vae_cfg.spatial_compression_ratio)
        m = torch.as_tensor(np.asarray(mask_video), device=self.device).to(dtype)
        m = encode_mask_pixelshuffle(m, zs.shape[2], vae_stride=stride).to(dtype)
        return torch.cat([zs, m], dim=1)

    @torch.no_grad()
    def denoise_step(self, latents, t: float, context, geoada_context, cos, sin,
                     guidance_scale: float, geoada_scale: float, use_cfg: bool):
        """One model evaluation: the batched-CFG forward (cond + uncond as one
        batch, uncond + g*(cond - uncond)) or the cond-only forward."""
        if use_cfg:
            x = torch.cat([latents, latents], dim=0)
            g = torch.cat([geoada_context, geoada_context], dim=0)
            ctx = context
        else:
            x, g, ctx = latents, geoada_context, context[context.shape[0] // 2:]
        tvec = torch.full((x.shape[0],), float(t), dtype=torch.float32,
                          device=self.device)
        pred = wan_dit_forward(self.dit_params, self.dit_cfg, x, tvec, ctx,
                               cos, sin, geoada_context=g,
                               geoada_scale=geoada_scale)
        if use_cfg:
            pred = cfg_combine(*pred.chunk(2, dim=0), guidance_scale)
        return pred

    @torch.no_grad()
    def __call__(
        self,
        prompt=None,
        negative_prompt: str = "",
        control_videos: Optional[Sequence[np.ndarray]] = None,
        mask_video: Optional[np.ndarray] = None,
        geoada_context: Optional[torch.Tensor] = None,
        height: int = 480,
        width: int = 832,
        num_frames: int = 81,
        num_inference_steps: int = 30,
        timesteps: Optional[Sequence[float]] = None,
        guidance_scale: float = 5.0,
        shift: float = 16.0,
        seed: int = 2025,
        latents=None,
        prompt_embeds: Optional[torch.Tensor] = None,
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        geoada_context_scale: float = 1.0,
        dtype=torch.bfloat16,
        output_type: str = "numpy",
        progress: Optional[Callable[[int, int], None]] = None,
        callback_on_step_end: Optional[Callable] = None,
        video=None, subject_ref_images=None, y=None, clip_fea=None,
        clip_image=None, camera_video=None,
    ):
        """Returns the video as numpy [B, T, H, W, 3] in [0, 1]
        (output_type 'numpy'), uint8 0..255 ('uint8', quantized on the
        device), or the latents as a tensor ('latent')."""
        for name, val in (("video= masked init-video conditioning", video),
                          ("subject_ref_images", subject_ref_images),
                          ("i2v y", y), ("clip_fea", clip_fea),
                          ("clip_image", clip_image), ("camera_video", camera_video)):
            if val is not None:
                _not_ported(name)
        if output_type not in ("numpy", "uint8", "latent"):
            raise ValueError(f"unknown output_type {output_type!r}")
        wall: Dict[str, float] = {}
        t_mark = [time.perf_counter()]

        def mark(name):
            self._sync()
            now = time.perf_counter()
            wall[name] = wall.get(name, 0.0) + now - t_mark[0]
            t_mark[0] = now

        if prompt_embeds is not None:
            batch = prompt_embeds.shape[0]
            if negative_prompt_embeds is None:
                if self.t5_params is None:
                    raise ValueError("prompt_embeds without negative_prompt_embeds "
                                     "needs a T5 encoder on the pipeline")
                negative_prompt_embeds = self.encode_texts(
                    [negative_prompt or ""] * int(batch))
            context = torch.cat([torch.as_tensor(negative_prompt_embeds, device=self.device),
                                 torch.as_tensor(prompt_embeds, device=self.device)]).to(dtype)
        elif prompt is None:
            raise ValueError("provide `prompt` or `prompt_embeds`")
        else:
            batch = 1 if isinstance(prompt, str) else len(prompt)
            context = self.encode_prompt(prompt, negative_prompt).to(dtype)
        mark("text_encode")

        if geoada_context is None:
            if control_videos is None:
                raise ValueError("need control_videos or geoada_context")
            if mask_video is None:
                mask_video = np.ones((batch, 1, num_frames, height, width), np.float32)
            geoada_context = self.encode_controls(control_videos, mask_video, dtype)
        else:
            geoada_context = torch.as_tensor(geoada_context, device=self.device).to(dtype)
        mark("encode_controls")

        t_lat = geoada_context.shape[2]
        h_lat = height // self.vae_cfg.spatial_compression_ratio
        w_lat = width // self.vae_cfg.spatial_compression_ratio
        pt, ph, pw = self.dit_cfg.patch_size
        cos, sin = grid_cos_sin(self._angles, t_lat // pt, h_lat // ph,
                                w_lat // pw, device=self.device)

        sched = make_scheduler(self.scheduler_name, self.scheduler_cfg)
        if timesteps is not None:
            timesteps = sched.set_custom_timesteps(timesteps)
            num_inference_steps = sched.num_inference_steps
        else:
            timesteps = sched.set_timesteps(num_inference_steps, shift=shift)

        lat_shape = (batch, self.vae_cfg.z_dim, t_lat, h_lat, w_lat)
        if latents is None:  # the JAX pipeline's draw, bit for bit in bf16
            latents = prng.normal(prng.key(seed, self.device), lat_shape, dtype)
        else:
            latents = torch.as_tensor(np.asarray(latents) if isinstance(latents, np.ndarray)
                                      else latents, device=self.device).to(dtype)
            if tuple(latents.shape) != lat_shape:
                raise ValueError(f"latents= shape {tuple(latents.shape)} != "
                                 f"expected {lat_shape}")

        use_cfg = guidance_scale > 1.0
        for i, t in enumerate(timesteps):
            noise_pred = self.denoise_step(
                latents, float(np.float32(t)), context, geoada_context, cos, sin,
                guidance_scale, geoada_context_scale, use_cfg)
            latents = sched.step(noise_pred, i, latents)
            if callback_on_step_end is not None:
                out = callback_on_step_end(self, i, float(t), {"latents": latents})
                if out:
                    latents = out.pop("latents", latents)
            if progress is not None:
                progress(i + 1, num_inference_steps)
        mark("denoise")
        if output_type == "latent":
            self.last_wall_profile = wall
            return latents
        out = self.decode_latents(latents, output_type)
        mark("vae_decode")
        self.last_wall_profile = wall
        return out

    @torch.no_grad()
    def decode_latents(self, latents, output_type: str = "numpy") -> np.ndarray:
        """VAE-decode latents -> frames [B, T, H, W, 3] in [0, 1] (float32)
        or 0..255 (uint8, quantized on the device)."""
        video = vae_decode(self.vae_params, self.vae_cfg, latents)
        video = torch.clamp(video.float() / 2.0 + 0.5, 0.0, 1.0)
        if output_type == "uint8":
            video = (video * 255.0).to(torch.uint8)
        return video.permute(0, 2, 3, 4, 1).cpu().numpy()
