"""End-to-end controlled video generation: umT5 prompt encoding, VAE
encoding of the 4 control videos plus the 8x8 pixel-shuffled mask (the
GeoAdapter context), the UniPC + batched-CFG denoise loop over the Wan DiT,
and the VAE decode, with the JAX pipeline's runtime accelerations: TeaCache
(sampling/teacache.py) and cfg-skip, sequential CFG (cfg_parallel=False:
the two branches as batch-1 forwards, with separate TeaCache states, gated
on the host above teacache.TEA_HOST_GATE_ROWS rows), and the streaming VAE
(models/vae_stream.py) above VAE_STREAM_THRESHOLD voxels, whose decode
moves chunk N to the host while chunk N+1 decodes. quantize_weights stores
the DiT in int8 or int4 (optionally W8A8 / W4A8 compute,
utils/quantize.py), one block at a time; merge_lora / unmerge_lora fold a
LoRA state dict in or out (utils/lora.py).

The Wan2.2 timestep-MoE picks its expert per step by sigma = t / T against
moe_boundary: a resident pair (dit_params_high), or expert_swap, which
drops the resident expert before it builds the other, so only one is ever
held. The base-Wan conditioning: i2v `y` latents, CLIP image tokens
(`clip_fea`, or `clip_image` through the pipeline's CLIP tower), SimpleAdapter
camera maps (`camera_video`), subject reference frames prepended on the
time axis, and a masked init video (`video=`).

Under a mesh (core/mesh.make_mesh; set_mesh) each rank is one process of a
torchrun world: the DiT is sharded over (fsdp, tp), umT5 FSDP-sharded over
every axis and gathered at use, the VAE and CLIP tower whole on every rank,
and the DiT's tokens split over (dp, sp) (parallel/sharding.py). Each rank
draws the whole noise from the seed and ends every step with the whole
prediction, so the scheduler, the CFG combine and TeaCache's decision (from
the replicated e0) run the same on every rank; only the cached residual is
split like the tokens.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import math
import queue
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from versecrafter_tpu_torch import resolve_device
from versecrafter_tpu_torch.core.config import (
    SchedulerConfig, T5Config, VAEConfig, WanDiTConfig)
from versecrafter_tpu_torch.kernels.rope import grid_cos_sin, rope_3d_angles
from versecrafter_tpu_torch.models.t5 import t5_encode
from versecrafter_tpu_torch.models.vae import vae_decode, vae_encode
from versecrafter_tpu_torch.models.vae_stream import vae_decode_stream, vae_encode_chunked
from versecrafter_tpu_torch.models.wan_dit import (
    geoada_patch_embedding, wan_dit_blocks, wan_dit_e0, wan_dit_embed, wan_dit_head)
from versecrafter_tpu_torch.parallel import sharding as shd
from versecrafter_tpu_torch.sampling import teacache as tc
from versecrafter_tpu_torch.sampling.schedulers import make_scheduler
from versecrafter_tpu_torch.utils import lora as lora_utils
from versecrafter_tpu_torch.utils import prng
from versecrafter_tpu_torch.utils import quantize as qz
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


def _under_mesh(fn):
    """Run a pipeline method inside the pipeline's mesh context."""
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        with self._mesh_ctx():
            return fn(self, *args, **kwargs)
    return wrapped


def _to_device(tree, device):
    """A copy of a tensor tree on `device`, detached from autograd (None
    stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.detach().to(device)


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
    # optional CLIP vision tower (models/clip.py) for `clip_image=`
    clip_params: Any = None
    clip_cfg: Any = None
    scheduler_name: str = "unipc"
    scheduler_cfg: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    device: Any = None
    # Wan2.2 timestep-MoE: the high-noise expert runs the steps with
    # sigma = t / num_train_timesteps >= moe_boundary. Either resident
    # (dit_params_high, the same config as dit_params), or expert_swap:
    # which -> that expert's params, called where the step's expert changes
    # after the resident one was dropped, so the two never coexist. The two
    # are mutually exclusive.
    dit_params_high: Any = None
    moe_boundary: float = 0.875
    expert_swap: Optional[Callable[[str], Any]] = None
    # TeaCache (off at threshold 0) and cfg-skip: the last cfg_skip_ratio of
    # the steps run the cond branch only
    teacache_threshold: float = 0.0
    teacache_skip_start: int = 5
    teacache_coefficients: Tuple[float, ...] = tc.VERSECRAFTER_COEFFS
    cfg_skip_ratio: float = 0.0
    # True: cond and uncond as one batch-2 forward; False: two batch-1
    # forwards in turn (half the activation working set), each CFG branch
    # with its own TeaCache state
    cfg_parallel: bool = True
    # teacache_debug: the cond TeaCache state's accumulator after every step
    # goes to teacache_accum_history, reset by each call (0.0 after a step
    # that ran the blocks); teacache_record: set by record_teacache_stats
    teacache_debug: bool = False
    teacache_record: Any = None
    # a core.mesh.Mesh over the torchrun world (set_mesh), or None
    mesh: Any = None

    # above this many voxels a video goes through the streaming VAE
    VAE_STREAM_THRESHOLD = 1 << 24

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.tokenizer is None:
            self.tokenizer = load_tokenizer(vocab_size=self.t5_cfg.vocab)
        for name in ("dit_params", "dit_params_high", "vae_params", "t5_params",
                     "clip_params"):
            setattr(self, name, _to_device(getattr(self, name), self.device))
        self._resident_expert = None
        self._angles = rope_3d_angles(self.dit_cfg.head_dim,
                                      self.dit_cfg.rope_max_pos,
                                      self.dit_cfg.rope_theta)
        self.teacache_accum_history = []
        self.last_wall_profile: Dict[str, float] = {}
        if self.mesh is not None:
            self.set_mesh(self.mesh)

    def set_mesh(self, mesh):
        """Shard the pipeline onto a mesh: the DiT (each expert) over (fsdp,
        tp), umT5 over every axis, the VAE and CLIP whole; the DiT's
        attention then takes the sequence-parallel path. A mesh of one rank
        (or None) is the single-device pipeline."""
        self.mesh = mesh
        if mesh is None or mesh.size == 1:
            return
        shd.check_dit_mesh(self.dit_cfg, mesh, self.dit_params, self.dit_params_high)
        for name in ("dit_params", "dit_params_high"):
            if getattr(self, name) is not None:
                setattr(self, name, shd.shard_dit_params(getattr(self, name), mesh))
        if self.t5_params is not None:
            self.t5_params = shd.shard_t5_params(self.t5_params, mesh)

    def _mesh_ctx(self):
        return shd.mesh_context(self.mesh if self.mesh is not None and self.mesh.size > 1
                                else None)

    @_under_mesh
    def _shard_tea_state(self, state: tc.TeaCacheState) -> tc.TeaCacheState:
        """This rank's TeaCache state: the residual split like the tokens,
        the per-row statistics whole."""
        return state._replace(prev_residual=shd.constrain_tokens(state.prev_residual))

    # -- runtime toggles (the JAX pipeline's enable_* surface) -------------
    def enable_teacache(self, threshold: float, skip_start: int = 5,
                        coefficients=tc.VERSECRAFTER_COEFFS):
        self.teacache_threshold = threshold
        self.teacache_skip_start = skip_start
        self.teacache_coefficients = tuple(coefficients)

    def disable_teacache(self):
        self.teacache_threshold = 0.0

    def enable_cfg_skip(self, ratio: float):
        self.cfg_skip_ratio = ratio

    def enable_int8_attention(self, enabled: bool = True):
        """int8 QK^T scoring inside the fused self-attention kernel
        (per-(row, head) int8 q~/k~ codes, PV in bf16): an inference
        approximation to opt into after judging quality. Module-global:
        sets wan_dit.INT8_QK_SCORE."""
        from versecrafter_tpu_torch.models import wan_dit
        wan_dit.INT8_QK_SCORE = bool(enabled)

    def quantize_weights(self, int8_compute: bool = False, act_scales=None,
                         bits: int = 8, act_scales_high=None, int8_sites=None):
        """Stores the DiT's big kernels as int8 (bits 8, per-channel scales)
        or nibble-packed int4 (bits 4, 128-row group scales); the denoise
        step dequantizes the non-block parts to their recorded dtype and
        each block's storage-only kernels as it runs them.

        int8_compute additionally runs the block matmuls (utils/quantize
        COMPUTE_SITES, filtered by the substrings of `int8_sites`) as
        s8 x s8 -> s32 products: W8A8, or W4A8 with bits 4, whose scales
        are then per channel. Activation scales are dynamic per row, or the
        calibrated per-tensor `act_scales` of fit_act_scales. A resident
        high-noise expert (dit_params_high) is quantized too, with its own
        `act_scales_high` or dynamic scales: the experts see disjoint sigma
        ranges, so one's calibration would clip the other's activations.

        Each tree is rebuilt one block at a time (utils/quantize.quantize_dit)
        in lists of the pipeline's own, so a bf16 block is dropped as soon as
        its quantized copy exists unless the caller still holds the old
        tree."""
        for attr, scales in (("dit_params", act_scales), ("dit_params_high", act_scales_high)):
            old = getattr(self, attr)
            if old is None:
                continue
            tree = {k: (list(v) if isinstance(v, list) else v) for k, v in old.items()}
            del old
            setattr(self, attr, tree)
            qz.quantize_dit(tree, bits, int8_compute, scales, int8_sites)

    def merge_lora(self, lora_sd, weight: float = 1.0):
        """Folds weight * (up @ down)^T of each LoRA pair into the DiT."""
        self.dit_params = lora_utils.merge_lora(self.dit_params, lora_sd, weight)

    def unmerge_lora(self, lora_sd, weight: float = 1.0):
        self.dit_params = lora_utils.unmerge_lora(self.dit_params, lora_sd, weight)

    def dit_params_for_step(self, params=None):
        """The DiT tree a step runs (`params`, default dit_params): the
        non-block parts of a quantized tree dequantized to their recorded
        dtype (the blocks' kernels are dequantized, or run W8A8, block by
        block)."""
        params = self.dit_params if params is None else params
        return {k: (v if isinstance(v, list) else qz.dequantize_tree(v))
                for k, v in params.items()}

    def expert_for(self, t: float):
        """The DiT params of the step at timestep t: the high-noise expert
        when sigma = t / num_train_timesteps >= moe_boundary. Under
        expert_swap the resident expert is dropped first (and the card's
        cache emptied) when the step needs the other one."""
        sigma = float(t) / self.scheduler_cfg.num_train_timesteps
        if self.expert_swap is not None:
            want = "high" if sigma >= self.moe_boundary else "low"
            if self._resident_expert != want:
                self.dit_params = None
                self._resident_expert = None
                gc.collect()
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
                self.dit_params = _to_device(self.expert_swap(want), self.device)
                if self.mesh is not None and self.mesh.size > 1:
                    self.dit_params = shd.shard_dit_params(self.dit_params, self.mesh)
                self._resident_expert = want
        if self.dit_params_high is not None and sigma >= self.moe_boundary:
            return self.dit_params_high
        return self.dit_params

    def enable_riflex(self, k: int, L_test: int, L_test_scale: Optional[float] = None):
        """RIFLEx: the temporal RoPE table's frequency k-1 set for
        extrapolation to L_test latent frames."""
        self._angles = rope_3d_angles(
            self.dit_cfg.head_dim, self.dit_cfg.rope_max_pos, self.dit_cfg.rope_theta,
            riflex_k=k, riflex_L_test=L_test, riflex_L_test_scale=L_test_scale)

    def record_teacache_stats(self, *args, **kwargs):
        """One full generation (never skipping, no cfg-skip) that records the
        TeaCache observables; returns (rel_e0, rel_residual), each
        [num_steps - 1, rows], for teacache.fit_teacache_coefficients. rel_e0
        is the relative L1 drift of e0 between consecutive steps,
        rel_residual that of the blocks residual. Under sequential CFG only
        the cond branch is recorded. Takes __call__'s arguments; the latents
        it produced are kept as last_record_latents."""
        if self.mesh is not None and self.mesh.size > 1:
            raise ValueError("record_teacache_stats runs on one rank, not under a mesh")
        self.teacache_record = []
        old_thresh, old_skip = self.teacache_threshold, self.cfg_skip_ratio
        self.teacache_threshold = 0.0
        self.cfg_skip_ratio = 0.0
        try:
            kwargs.setdefault("output_type", "latent")
            self.last_record_latents = self(*args, **kwargs)
            rec = self.teacache_record
        finally:
            self.teacache_record = None
            self.teacache_threshold, self.cfg_skip_ratio = old_thresh, old_skip
        mods = np.stack([r[0] for r in rec])      # [steps, rows, 6, D]
        rel_res = np.stack([r[1] for r in rec])   # [steps, rows]
        prev, cur = mods[:-1], mods[1:]
        rel_e0 = (np.abs(cur - prev).mean(axis=(2, 3))
                  / np.maximum(np.abs(prev).mean(axis=(2, 3)), 1e-8))
        return rel_e0, rel_res[1:]

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
    @_under_mesh
    def encode_texts(self, texts) -> torch.Tensor:
        """-> [len(texts), text_len, text_dim], one T5 pass."""
        toks = self.tokenizer(list(texts), max_length=self.t5_cfg.text_length)
        ids = torch.as_tensor(toks["input_ids"], device=self.device)
        mask = torch.as_tensor(toks["attention_mask"], device=self.device)
        return t5_encode(self.t5_params, self.t5_cfg, ids, mask)

    def _vae_encode(self, x):
        """A [B, 3, T, H, W] video in [-1, 1] -> latents; above
        VAE_STREAM_THRESHOLD voxels (T > 1) through the streaming encoder."""
        if x.shape[2] > 1 and math.prod(x.shape[2:]) > self.VAE_STREAM_THRESHOLD:
            return vae_encode_chunked(self.vae_params, self.vae_cfg, x)
        return vae_encode(self.vae_params, self.vae_cfg, x)

    @torch.no_grad()
    def encode_controls(self, control_videos: Sequence[np.ndarray],
                        mask_video: np.ndarray, dtype=torch.bfloat16,
                        subject_ref_images: Optional[Sequence[np.ndarray]] = None
                        ) -> Tuple[torch.Tensor, int]:
        """control_videos: list of [B, 3, T, H, W] in [0, 1]; mask_video
        [B, 1, T, H, W] -> (geoada context [B, n*z + s*s, R + T', H/s, W/s],
        R). Each subject reference frame ([B, 3, 1, H, W]) is VAE-encoded
        and prepended on the time axis in the first control's channel block,
        zeros elsewhere and in the mask channels; R counts those latent
        frames."""
        lat = []
        for cv in control_videos:
            x = torch.as_tensor(np.asarray(cv), device=self.device).to(dtype) * 2.0 - 1.0
            z = self._vae_encode(x)
            del x
            lat.append(z.to(dtype))
        zs = torch.cat(lat, dim=1)
        stride = (self.vae_cfg.temporal_compression_ratio,
                  self.vae_cfg.spatial_compression_ratio,
                  self.vae_cfg.spatial_compression_ratio)
        m = torch.as_tensor(np.asarray(mask_video), device=self.device).to(dtype)
        m = encode_mask_pixelshuffle(m, zs.shape[2], vae_stride=stride).to(dtype)
        n_ref = 0
        if subject_ref_images:
            refs = []
            for r in subject_ref_images:
                x = torch.as_tensor(np.asarray(r), device=self.device).to(dtype) * 2.0 - 1.0
                rl = self._vae_encode(x).to(dtype)
                pad = rl.new_zeros((rl.shape[0], zs.shape[1] - rl.shape[1], *rl.shape[2:]))
                refs.append(torch.cat([rl, pad], dim=1))
            ref_lat = torch.cat(refs, dim=2)
            n_ref = ref_lat.shape[2]
            zs = torch.cat([ref_lat, zs], dim=2)
            m = torch.cat([m.new_zeros((m.shape[0], m.shape[1], n_ref, *m.shape[3:])), m],
                          dim=2)
        return torch.cat([zs, m], dim=1), n_ref

    @torch.no_grad()
    @_under_mesh
    def denoise_step(self, latents, t: float, context, geoada_context, cos, sin,
                     guidance_scale: float, geoada_scale: float, use_cfg: bool,
                     blocks: Optional[Callable] = None, extras=None, params=None):
        """One model evaluation: the batched-CFG forward (cond + uncond as one
        batch, uncond + g*(cond - uncond)) or the cond-only forward over the
        second half of `context`. blocks: None runs the whole DiT; otherwise
        a function (run_blocks, tokens, e0) -> tokens that wraps the blocks
        section (TeaCache's gate or its record pass) between the embeddings
        and the head. extras: the step-invariant conditioning {"y",
        "clip_fea", "y_camera"} of the batch (duplicated over both CFG
        halves: CFG applies to the text only). params: the expert to run
        (default dit_params). Under a mesh the blocks run on this rank's
        token slice and the prediction comes back whole."""
        extras = extras or {}
        if use_cfg:
            x = torch.cat([latents, latents], dim=0)
            g = torch.cat([geoada_context, geoada_context], dim=0)
            ctx = context
            extras = {k: torch.cat([v, v], dim=0) for k, v in extras.items()}
        else:
            x, g, ctx = latents, geoada_context, context[context.shape[0] // 2:]
        if "y" in extras:
            x = torch.cat([x, extras["y"]], dim=1)
        tvec = torch.full((x.shape[0],), float(t), dtype=torch.float32,
                          device=self.device)
        p, cfg = self.dit_params_for_step(params), self.dit_cfg
        tokens, e, e0, ctx_e, ctx_img, grid = wan_dit_embed(
            p, cfg, x, tvec, ctx, extras.get("clip_fea"), extras.get("y_camera"))
        gtok = geoada_patch_embedding(p, cfg, g) if cfg.has_geoadapter else None
        tokens, gtok = shd.constrain_tokens(tokens), shd.constrain_tokens(gtok)
        cos, sin = cos.to(x.device), sin.to(x.device)

        def run(tk):
            return wan_dit_blocks(p, cfg, tk, e0, cos, sin, ctx_e,
                                  geoada_tokens=gtok, geoada_scale=geoada_scale,
                                  context_img=ctx_img)

        tokens = run(tokens) if blocks is None else blocks(run, tokens, e0)
        pred = wan_dit_head(p, cfg, tokens, e, grid)
        if use_cfg:
            pred = cfg_combine(*pred.chunk(2, dim=0), guidance_scale)
        return pred

    @torch.no_grad()
    @_under_mesh
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
        device), or the latents as a tensor ('latent'). The wall time of each
        stage (text_encode, clip_encode when a clip_image is encoded,
        encode_controls, denoise, vae_decode, download) goes to
        last_wall_profile.

        The base-Wan conditioning: `y` [B, C_y, T', H/8, W/8] i2v latents
        concatenated on channels; `clip_fea` [B, 257, 1280] CLIP image
        tokens, or `clip_image` [H, W, 3] encoded by the pipeline's CLIP
        tower and broadcast to the batch; `camera_video` [B, C, F*pt,
        H_lat*ds, W_lat*ds] camera-pose maps for the SimpleAdapter.
        `subject_ref_images` (list of [B, 3, 1, H, W]) are prepended to the
        control latents and their latent frames stripped before the decode;
        the noise is drawn at the longer latent length. `video` [B, 3, T, H,
        W] in [0, 1] without control_videos becomes the single control
        video, masked to v * keep + 0.5 * (1 - keep), keep = mask_video <
        0.5 (mask_video required)."""
        if self.expert_swap is not None and self.dit_params_high is not None:
            raise ValueError("expert_swap and a resident dit_params_high are "
                             "mutually exclusive")
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

        if clip_fea is None and clip_image is not None:
            if self.clip_params is None:
                raise ValueError("clip_image given but pipeline has no "
                                 "clip_params (CLIP vision tower)")
            from versecrafter_tpu_torch.models.clip import encode_image
            clip_fea = encode_image(self.clip_params, self.clip_cfg, clip_image)
            clip_fea = clip_fea.expand(batch, *clip_fea.shape[1:])
            mark("clip_encode")
        extras = {}
        if y is not None:
            extras["y"] = torch.as_tensor(y, device=self.device).to(dtype)
        if clip_fea is not None:
            extras["clip_fea"] = torch.as_tensor(clip_fea, device=self.device).to(dtype)
        if camera_video is not None:
            if self.dit_params is not None and "control_adapter" not in self.dit_params:
                raise ValueError(
                    "camera_video given but the DiT has no control_adapter "
                    "(checkpoint lacks SimpleAdapter weights / "
                    "cfg.add_control_adapter is off)")
            extras["y_camera"] = torch.as_tensor(camera_video, device=self.device).to(dtype)

        n_ref = 0
        if geoada_context is None:
            if control_videos is None and video is not None:
                # masked init video: the region to generate becomes 0.5
                # (0 after encode_controls' v * 2 - 1)
                if mask_video is None:
                    raise ValueError("video= conditioning needs mask_video")
                keep = (np.asarray(mask_video, np.float32) < 0.5).astype(np.float32)
                v = np.asarray(video, np.float32)
                control_videos = [v * keep + 0.5 * (1.0 - keep)]
            if control_videos is None:
                raise ValueError("need control_videos, video or geoada_context")
            if mask_video is None:
                mask_video = np.ones((batch, 1, num_frames, height, width), np.float32)
            geoada_context, n_ref = self.encode_controls(
                control_videos, mask_video, dtype, subject_ref_images=subject_ref_images)
        else:
            geoada_context = torch.as_tensor(geoada_context, device=self.device).to(dtype)
        mark("encode_controls")

        t_lat = geoada_context.shape[2]
        h_lat = height // self.vae_cfg.spatial_compression_ratio
        w_lat = width // self.vae_cfg.spatial_compression_ratio
        pt, ph, pw = self.dit_cfg.patch_size
        grid = (t_lat // pt, h_lat // ph, w_lat // pw)
        cos, sin = grid_cos_sin(self._angles, *grid, device=self.device)

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

        denoise = Denoiser(self, batch, math.prod(grid), guidance_scale, dtype,
                           num_inference_steps)
        if self.teacache_debug:
            self.teacache_accum_history = []
        for i, t in enumerate(timesteps):
            params = self.expert_for(t)
            noise_pred = denoise.step(i, float(np.float32(t)), latents, context,
                                      geoada_context, cos, sin, geoada_context_scale,
                                      params=params, extras=extras)
            del params
            latents = sched.step(noise_pred, i, latents)
            if callback_on_step_end is not None:
                out = callback_on_step_end(self, i, float(t), {"latents": latents})
                if out:
                    latents = out.pop("latents", latents)
            if progress is not None:
                progress(i + 1, num_inference_steps)
        mark("denoise")
        if n_ref:  # strip the prepended reference-frame slots
            latents = latents[:, :, n_ref:]
        if output_type == "latent":
            self.last_wall_profile = wall
            return latents
        out = self.decode_latents(latents, output_type, mark)
        self.last_wall_profile = wall
        return out

    @torch.no_grad()
    def decode_latents(self, latents, output_type: str = "numpy",
                       mark: Callable[[str], None] = lambda name: None) -> np.ndarray:
        """VAE-decode latents -> frames [B, T, H, W, 3] in [0, 1] (float32)
        or 0..255 (uint8, quantized on the device). Above
        VAE_STREAM_THRESHOLD output voxels the streaming decoder runs, its
        chunks moved to the host as they finish. mark(name) closes the
        'vae_decode' and 'download' stages."""
        out_voxels = (math.prod(latents.shape[2:])
                      * self.vae_cfg.temporal_compression_ratio
                      * self.vae_cfg.spatial_compression_ratio ** 2)
        if latents.shape[2] > 1 and out_voxels > self.VAE_STREAM_THRESHOLD:
            return self._decode_stream_overlapped(latents, output_type, mark)
        video = _finalize_pixels(vae_decode(self.vae_params, self.vae_cfg, latents),
                                 output_type)
        mark("vae_decode")
        out = video.permute(0, 2, 3, 4, 1).cpu().numpy()
        mark("download")
        return out

    def _decode_stream_overlapped(self, latents, output_type: str,
                                  mark: Callable[[str], None] = lambda name: None
                                  ) -> np.ndarray:
        """Streaming decode whose chunks go to the host on a worker thread:
        chunk N is copied (on a side stream of its own, after an event that
        marks the end of the chunk's device work) while chunk N+1 decodes.
        An error of the worker is raised here."""
        cuda = latents.device.type == "cuda"
        copy_stream = torch.cuda.Stream(latents.device) if cuda else None
        chunks: list = []
        err: list = []
        work: "queue.Queue" = queue.Queue(maxsize=2)

        def downloader():
            while True:
                item = work.get()
                if item is None:
                    return
                frames, ready = item
                del item
                try:
                    if cuda:
                        with torch.cuda.stream(copy_stream):
                            copy_stream.wait_event(ready)
                            host = frames.cpu()
                    else:
                        host = frames
                    chunks.append(host.numpy().transpose(0, 2, 3, 4, 1))
                except Exception as e:  # noqa: BLE001 — raised by the caller
                    err.append(e)
                finally:
                    del frames

        worker = threading.Thread(target=downloader, daemon=True)
        worker.start()
        try:
            for y in vae_decode_stream(self.vae_params, self.vae_cfg, latents):
                frames = _finalize_pixels(y, output_type)
                del y
                ready = None
                if cuda:
                    ready = torch.cuda.Event()
                    ready.record()
                work.put((frames, ready))
                del frames
        finally:
            work.put(None)
            worker.join()
        if err:
            raise err[0]
        mark("vae_decode")
        out = np.concatenate(chunks, axis=1)
        mark("download")
        return out


def _finalize_pixels(y: torch.Tensor, output_type: str) -> torch.Tensor:
    """The decoder's output [-1, 1] -> [0, 1] fp32, or 0..255 uint8."""
    video = torch.clamp(y.float() / 2.0 + 0.5, 0.0, 1.0)
    if output_type == "uint8":
        video = (video * 255.0).to(torch.uint8)
    return video


class Denoiser:
    """One generation's model evaluations, step by step: batched or
    sequential CFG, cfg-skip, and the TeaCache states (cond and uncond under
    sequential CFG), gated on the device's fp32 arithmetic or, for
    sequential CFG above teacache.TEA_HOST_GATE_ROWS rows, by host_gate."""

    def __init__(self, pipe: VerseCrafterPipeline, batch: int, seq_len: int,
                 guidance_scale: float, dtype, num_steps: int):
        self.pipe, self.batch, self.guidance = pipe, batch, guidance_scale
        self.do_cfg = guidance_scale > 1.0
        self.seq_cfg = self.do_cfg and not pipe.cfg_parallel
        self.recording = pipe.teacache_record is not None
        self.tea = pipe.teacache_threshold > 0.0 or self.recording
        self.host_gated = (self.seq_cfg and pipe.teacache_threshold > 0.0
                           and not self.recording
                           and batch * seq_len > tc.TEA_HOST_GATE_ROWS)
        self.skip_from = num_steps * (1.0 - pipe.cfg_skip_ratio)
        dim = pipe.dit_cfg.dim
        rows = 2 * batch if self.do_cfg and not self.seq_cfg else batch
        seq = seq_len
        if self.recording and rows * seq_len > tc.TEA_RECORD_SUBSAMPLE_ROWS:
            seq = -(-seq_len // tc.RECORD_SUBSAMPLE_STRIDE)
        self.states = {}
        if self.tea:
            self.states["c"] = pipe._shard_tea_state(
                tc.init_state(rows, seq, dim, dtype, device=pipe.device))
            if self.seq_cfg:
                self.states["u"] = pipe._shard_tea_state(
                    tc.init_state(batch, seq, dim, dtype, device=pipe.device))
        self.hosts = ({"c": tc.HostTeaState(batch, dim), "u": tc.HostTeaState(batch, dim)}
                      if self.host_gated else None)

    def step(self, i: int, t: float, latents, context, geo, cos, sin, gscale,
             params=None, extras=None):
        """The step's prediction; params: the step's expert (default the
        pipeline's dit_params), extras: the batch's conditioning (see
        denoise_step)."""
        pipe, batch = self.pipe, self.batch
        use_cfg = self.do_cfg and not (pipe.cfg_skip_ratio > 0.0 and i >= self.skip_from)
        if (self.tea and not self.seq_cfg
                and use_cfg != (tc.res_shape(self.states["c"])[0] == 2 * batch)):
            # cfg-skip starts: keep the cond half of the state
            self.states["c"] = tc.slice_rows(self.states["c"], slice(-batch, None))
        e0_host = None
        if self.host_gated:
            tvec = torch.full((batch,), t, dtype=torch.float32, device=pipe.device)
            e0_host = wan_dit_e0(pipe.dit_params_for_step(params), pipe.dit_cfg,
                                 tvec)[1].cpu().numpy()

        def evaluate(name, ctx, batched):
            blocks = (None if not self.tea else
                      lambda run, tokens, e0: self._blocks(name, i, e0_host, run, tokens, e0))
            return pipe.denoise_step(latents, t, ctx, geo, cos, sin, self.guidance,
                                     gscale, batched, blocks=blocks, extras=extras,
                                     params=params)

        if self.seq_cfg:
            pred = evaluate("c", context, False)
            if use_cfg:  # the negative prompts as the cond-only forward's context
                ctx_u = torch.cat([context[batch:], context[:batch]])
                pred = cfg_combine(evaluate("u", ctx_u, False), pred, self.guidance)
        else:
            pred = evaluate("c", context, use_cfg)
        if self.recording:
            st = self.states["c"]
            pipe.teacache_record.append((st.prev_mod.cpu().numpy(), st.accum.cpu().numpy()))
        if pipe.teacache_debug and pipe.teacache_threshold > 0.0:
            pipe.teacache_accum_history.append(
                self.hosts["c"].accum.copy() if self.host_gated
                else self.states["c"].accum.cpu().numpy())
        return pred

    def _blocks(self, name, i, e0_host, run, tokens, e0):
        pipe, state = self.pipe, self.states[name]
        if self.recording:
            out, self.states[name] = tc.recording_blocks(run, tokens, e0, state)
        elif self.host_gated:
            calc = bool(tc.host_gate(self.hosts[name], e0_host, i, pipe.teacache_threshold,
                                     pipe.teacache_skip_start,
                                     pipe.teacache_coefficients).any())
            should = torch.full((tokens.shape[0],), calc, dtype=torch.bool)
            out, res = tc.apply_gate(run, tokens, state.prev_residual, should)
            self.states[name] = state._replace(prev_residual=res)
        else:
            out, self.states[name] = tc.gated_blocks(
                run, tokens, e0, state, i, pipe.teacache_threshold,
                pipe.teacache_skip_start, pipe.teacache_coefficients)
        return out
