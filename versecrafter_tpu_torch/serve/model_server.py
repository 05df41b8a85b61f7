"""Resident model host: one process owns the pipeline on the device;
requests arrive over HTTP and enter one queue that a single worker thread
serves in order (the port's counterpart of
``versecrafter_tpu.serve.model_server``).

Endpoints:
  GET  /health        -> {status, model_loaded}
  POST /generate      -> {task_id}
  GET  /status/<id>   -> the task
  POST /unload        -> {unloaded}
  GET  /metrics       -> queue depth, task count, the last request's
                         per-step timing and per-stage wall split

    python -m versecrafter_tpu_torch.serve.model_server --model_path <dir> --port 8191
    python -m versecrafter_tpu_torch.serve.model_server --staged --staged_scale 14b
    torchrun --standalone --nproc_per_node 8 -m versecrafter_tpu_torch.serve.model_server \
        --model_path <dir> --ulysses_degree 8

A request names a control-map directory by the reference's file contract
(load_request_inputs); reading its mp4s needs OpenCV (utils/video.py).
run_loaded_request serves a request whose control videos are already
arrays. The pipeline comes from default_pipeline_factory: a reference-layout
checkpoint directory (core.convert.load_versecrafter) or random weights.
With --staged the host keeps a shell pipeline and builds and frees each
component per request stage (sampling/staged.py: umT5, the VAE, the DiT in
--quantize_bits with W8A8 / W4A8 compute); a request's `cfg_parallel` pins
batched or sequential CFG, else the card's memory model picks.

Under torchrun (one process per GPU, --ulysses_degree x --ring_degree x
--tp ranks, or --auto_mesh) the pipeline is sharded over the world's mesh
(resolve_mesh, sampling/pipeline.set_mesh). Rank 0 owns HTTP and the
queue and announces each task (load, generate, unload, shutdown) to the
other ranks before it runs it (RankTasks, on the world's control group, so
the other ranks may wait for the next request however long the server sits
idle); every rank runs it, the ranks agree on whether it succeeded, and
rank 0 saves the video. --resident_weights and a request's quantize params
apply on any mesh, --tp included: a request's quantization gathers each
part of the sharded DiT whole, quantizes it and shards it again
(VerseCrafterPipeline.quantize_weights).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import os
import queue
import threading
import traceback
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from versecrafter_tpu_torch import resolve_device
from versecrafter_tpu_torch.core.config import (
    T5Config, VAEConfig, WAN21_1_3B, WanDiTConfig, versecrafter_14b)
from versecrafter_tpu_torch.core.mesh import (
    auto_mesh_spec, check_world, make_mesh, spec_from_degrees, world_size)
from versecrafter_tpu_torch.serve.http import Router, make_server
from versecrafter_tpu_torch.serve.tasks import COMPLETED, FAILED, RUNNING, TaskRegistry

CONTROL_NAMES = ["background_RGB.mp4", "background_depth.mp4",
                 "3D_gaussian_RGB.mp4", "3D_gaussian_depth.mp4"]
# the model server's --resident_weights -> default_pipeline_factory's
# quantize (bits, int8_compute)
RESIDENT_WEIGHTS = {"bf16": None, "int8": (8, False), "int4": (4, False),
                    "w8a8": (8, True), "w4a8": (4, True)}


def pipeline_configs(scale: str):
    """(dit_cfg, vae_cfg, t5_cfg) of a factory scale: '14b' is
    Wan2.1-T2V-14B + GeoAdapter (40 layers, dim 5120, 40 heads, the
    GeoAdapter every 2nd layer with 128 control channels), '1.3b'
    Wan2.1-1.3B + GeoAdapter (15 blocks), both with the full umT5-xxl and
    the Wan VAE; 'i2v-1.3b' the widths of Wan2.1-Fun-1.3B-InP (i2v: in_dim
    36 = 16 noise + 4 mask + 16 image latents, img_emb from 1280-wide CLIP
    tokens) with the same GeoAdapter and the SimpleAdapter at its config
    defaults (24 camera channels, downscale 8, one residual block), whose
    factory adds the CLIP ViT-H/14 tower; 'tiny' the wiring-smoke widths
    (head_dim 16, so it runs on the CPU only, where attention takes the
    kernel's plain version)."""
    if scale == "14b":
        return versecrafter_14b(), VAEConfig(), T5Config()
    if scale in ("1.3b", "i2v-1.3b"):
        t5_cfg = T5Config()
        cfg = dataclasses.replace(WAN21_1_3B, geoada_layers=(), geoada_in_dim=128,
                                  text_dim=t5_cfg.dim)
        if scale == "i2v-1.3b":
            cfg = dataclasses.replace(cfg, model_type="i2v", in_dim=36, add_img_emb=True,
                                      add_control_adapter=True)
        return cfg, VAEConfig(), t5_cfg
    if scale == "tiny":
        t5_cfg = T5Config(num_layers=2, dim=512, dim_attn=512, dim_ffn=1024,
                          num_heads=8, vocab=1024)
        return (WanDiTConfig(dim=128, ffn_dim=256, num_heads=8, num_layers=4,
                             geoada_layers=(), geoada_in_dim=128, text_dim=t5_cfg.dim),
                VAEConfig(), t5_cfg)
    raise ValueError(f"unknown scale {scale!r}")


def build_dit(cfg: WanDiTConfig, seed: int, device=None, dtype=torch.bfloat16):
    """A random-weight DiT of `cfg` from `seed`, on the device (the
    factory's DiT at seed offset 0)."""
    from versecrafter_tpu_torch.models.wan_dit import init_wan_dit
    dev = resolve_device(device)
    return init_wan_dit(cfg, torch.Generator(device=dev).manual_seed(seed), dtype)


def resolve_mesh(mesh_spec=None, auto: bool = False, num_heads: int = 40, device=None):
    """The serving mesh over the torchrun world: mesh_spec, or with `auto`
    auto_mesh_spec(world size, num_heads). None for one device. A world of
    another size than the mesh raises ValueError (core.mesh.check_world),
    as does a world of several ranks with no mesh to put them on."""
    if auto and mesh_spec is None:
        mesh_spec = auto_mesh_spec(world_size(), num_heads=num_heads)
    check_world(mesh_spec)
    if mesh_spec is None or mesh_spec.size == 1:
        return None
    return make_mesh(mesh_spec, resolve_device(device))


def default_pipeline_factory(model_path: Optional[str] = None,
                             dtype_name: str = "bfloat16",
                             scale: str = "1.3b", device=None, seed: int = 0,
                             with_dit: bool = True, moe: bool = False,
                             quantize: Optional[Tuple[int, bool]] = None,
                             mesh_spec=None, auto_mesh: bool = False):
    """A factory of the pipeline, built on the device when called: from the
    reference-layout checkpoint directory `model_path`
    (core.convert.load_versecrafter, weights in `dtype_name`; an expert
    pair where the directory holds one), else the pipeline of `scale`
    (pipeline_configs) from random weights made from `seed`: the DiT from
    seed (with moe, a resident Wan2.2 expert pair: the low-noise expert from
    seed, the high-noise one from seed + 1, as the generate CLI's --moe
    builds them), the VAE (fp32) from seed + 1, umT5 from seed + 2, an i2v
    scale's CLIP tower (ViT-H/14) from seed + 3. quantize=(bits,
    int8_compute) quantizes each expert as soon as it exists, before the
    next one is made (utils/quantize.quantize_dit, dynamic activation
    scales): the pipeline then serves that mode for its life, as after a
    request that asked for it (run_loaded_request). with_dit=False leaves
    the DiT out (dit_params None: the shell an expert_swap fills).
    mesh_spec / auto_mesh shard the pipeline over the torchrun world
    (resolve_mesh): every rank calls the factory. Without them the
    pipeline stays unsharded, for a caller that shards it itself (the
    generate CLI, after its weight flags)."""
    if model_path:
        def load():
            from versecrafter_tpu_torch.core.convert import load_versecrafter
            pipe = load_versecrafter(model_path, dtype=getattr(torch, dtype_name),
                                     device=device, load_dit_params=with_dit,
                                     quantize=quantize)
            pipe._quantized = quantize
            if mesh_spec is not None or auto_mesh:
                pipe.set_mesh(resolve_mesh(mesh_spec, auto_mesh, pipe.dit_cfg.num_heads,
                                           device))
            return pipe
        return load
    cfg, vae_cfg, t5_cfg = pipeline_configs(scale)

    def factory():
        from versecrafter_tpu_torch.models.clip import VIT_HUGE_14, init_clip_vision
        from versecrafter_tpu_torch.models.t5 import init_t5
        from versecrafter_tpu_torch.models.vae import init_vae
        from versecrafter_tpu_torch.sampling.pipeline import VerseCrafterPipeline
        from versecrafter_tpu_torch.utils import quantize as qz

        dev = resolve_device(device)
        dtype = getattr(torch, dtype_name)

        def gen(offset):
            return torch.Generator(device=dev).manual_seed(seed + offset)

        def expert(offset):
            params = build_dit(cfg, seed + offset, dev, dtype)
            return params if quantize is None else qz.quantize_dit(params, *quantize)

        clip = (init_clip_vision(VIT_HUGE_14, gen(3), dtype) if cfg.model_type == "i2v"
                else None)
        pipe = VerseCrafterPipeline(
            dit_params=expert(0) if with_dit else None,
            dit_params_high=expert(1) if with_dit and moe else None,
            dit_cfg=cfg,
            vae_params=init_vae(vae_cfg, gen(1), torch.float32),
            vae_cfg=vae_cfg,
            t5_params=init_t5(t5_cfg, gen(2), dtype),
            t5_cfg=t5_cfg,
            clip_params=clip, clip_cfg=VIT_HUGE_14 if clip is not None else None,
            device=dev,
        )
        pipe._quantized = quantize
        if mesh_spec is not None or auto_mesh:
            pipe.set_mesh(resolve_mesh(mesh_spec, auto_mesh, cfg.num_heads, dev))
        return pipe
    return factory


def _call_pipe(pipe, params, controls, mask, h, w, n, progress):
    """One generate request's parameters -> a pipeline call (uint8 frames,
    quantized on the device)."""
    return pipe(
        params.get("prompt", ""),
        negative_prompt=params.get("negative_prompt", ""),
        control_videos=controls,
        mask_video=mask,
        height=h, width=w, num_frames=n,
        num_inference_steps=int(params.get("num_inference_steps", 30)),
        guidance_scale=float(params.get("guidance_scale", 5.0)),
        shift=float(params.get("shift", 16.0)),
        seed=int(params.get("seed", 2025)),
        geoada_context_scale=float(params.get("geoada_context_scale", 1.0)),
        progress=progress,
        output_type="uint8",
    )


def _call_pipe_staged(pipe, params, controls, mask, h, w, n, progress, factories):
    """One generate request under staged residency: CFG batched or
    sequential as the request's `cfg_parallel` says, else as
    staged.auto_cfg_parallel decides for the request's tokens."""
    from versecrafter_tpu_torch.sampling.staged import (
        auto_cfg_parallel, generate_staged, request_tokens)

    if "cfg_parallel" in params:
        pipe.cfg_parallel = bool(params["cfg_parallel"])
    else:
        pipe.cfg_parallel = auto_cfg_parallel(
            pipe.dit_cfg, factories.bits, request_tokens(pipe.dit_cfg, pipe.vae_cfg, h, w, n))
    return generate_staged(
        pipe, factories, params.get("prompt", ""),
        negative_prompt=params.get("negative_prompt", ""),
        control_videos=controls, mask_video=mask, height=h, width=w, num_frames=n,
        num_inference_steps=int(params.get("num_inference_steps", 30)),
        guidance_scale=float(params.get("guidance_scale", 5.0)),
        shift=float(params.get("shift", 16.0)),
        seed=int(params.get("seed", 2025)),
        geoada_context_scale=float(params.get("geoada_context_scale", 1.0)),
        progress=progress, output_type="uint8")


def run_loaded_request(pipe, params: dict, controls, mask, progress=None,
                       staged_factories=None):
    """One generate request whose control videos and mask are loaded: the
    per-request toggles of the JAX server's run_generate_request, then the
    pipeline call (uint8 frames [B, T, H, W, 3]). `int8_attention` sets
    int8 QK^T scoring, `teacache_threshold` (with `teacache_skip_start`,
    default 5, and `teacache_coefficients`, default the pipeline's) TeaCache
    and `cfg_skip_ratio` cfg-skip for this request; the previous settings
    are restored afterwards, also when the request raises.

    `quantize_int8` / `int8_compute` / `quantize_bits` (_requested_quant_mode)
    quantize the resident DiT on the first request that asks; the mode then
    stays for the pipeline's life (the weights are rewritten), and a request
    for another mode raises ValueError. Every param is applied inside the
    try, so a raising request leaves no toggle behind.

    staged_factories (sampling.staged.StageFactories): `pipe` is a shell
    whose weights are built and freed per stage (_call_pipe_staged); the
    factories fix the quantization, so quantize params raise ValueError."""
    from versecrafter_tpu_torch.models import wan_dit

    h = int(params.get("height", 480))
    w = int(params.get("width", 832))
    n = int(params.get("num_frames", 81))
    saved = (pipe.teacache_threshold, pipe.teacache_skip_start,
             pipe.teacache_coefficients, pipe.cfg_skip_ratio)
    saved_int8_attn = wan_dit.INT8_QK_SCORE
    try:
        if "int8_attention" in params:
            pipe.enable_int8_attention(bool(params["int8_attention"]))
        if "teacache_threshold" in params:
            pipe.enable_teacache(float(params["teacache_threshold"]),
                                 int(params.get("teacache_skip_start", 5)),
                                 coefficients=params.get("teacache_coefficients",
                                                         pipe.teacache_coefficients))
        if "cfg_skip_ratio" in params:
            pipe.enable_cfg_skip(float(params["cfg_skip_ratio"]))
        qmode = _requested_quant_mode(params)
        if staged_factories is not None:
            if qmode is not None:
                raise ValueError("staged-residency host: the stage factories fix the "
                                 "quantization; drop the quantize params")
            return _call_pipe_staged(pipe, params, controls, mask, h, w, n, progress,
                                     staged_factories)
        if qmode is not None:
            resident = getattr(pipe, "_quantized", None)
            if resident is None:
                pipe.quantize_weights(int8_compute=qmode[1], bits=qmode[0])
                pipe._quantized = qmode
            elif resident != qmode:
                raise ValueError(
                    f"pipeline already quantized as {resident} (bits, int8_compute); "
                    f"cannot re-quantize as {qmode}")
        return _call_pipe(pipe, params, controls, mask, h, w, n, progress)
    finally:
        (pipe.teacache_threshold, pipe.teacache_skip_start,
         pipe.teacache_coefficients, pipe.cfg_skip_ratio) = saved
        wan_dit.INT8_QK_SCORE = saved_int8_attn


def _requested_quant_mode(params):
    """(bits, int8_compute) a request asks for, or None. quantize_bits alone
    means weight quantization (a bare {"quantize_bits": 4} must not run
    bf16)."""
    if not (params.get("quantize_int8") or params.get("int8_compute")
            or "quantize_bits" in params):
        return None
    return int(params.get("quantize_bits", 8)), bool(params.get("int8_compute"))


def load_request_inputs(params: dict):
    """(control_videos, mask_video) of a generate request by the reference's
    file contract: the four control mp4s of CONTROL_NAMES and
    merged_mask.mp4 in params["rendering_maps_path"], resampled to
    params["fps"] (16) and cut or padded to num_frames at height x width;
    the mask's frame 0 zeroed (kept), all ones without a mask file; the
    input image, when given, over control 0's frame 0. A missing control
    stream becomes zeros in its own slot (a warning names each stream that
    is filled); with none of them present, FileNotFoundError."""
    from versecrafter_tpu_torch.utils.video import load_image, load_video

    maps_dir = params["rendering_maps_path"]
    h = int(params.get("height", 480))
    w = int(params.get("width", 832))
    n = int(params.get("num_frames", 81))
    fps = int(params.get("fps", 16))
    paths = [os.path.join(maps_dir, name) for name in CONTROL_NAMES]
    controls = [load_video(p, num_frames=n, size=(h, w), fps=fps)
                if os.path.exists(p) else None for p in paths]
    loaded = [c for c in controls if c is not None]
    if not loaded:
        raise FileNotFoundError(
            f"no control maps in {maps_dir!r} (need at least one of "
            f"{CONTROL_NAMES}; run the render step first)")
    for i, p in enumerate(paths):
        if controls[i] is None:
            print(f"warning: control video not found, zero-filled: {p}", flush=True)
            controls[i] = np.zeros_like(loaded[0])
    mask_p = os.path.join(maps_dir, "merged_mask.mp4")
    if os.path.exists(mask_p):
        mask = load_video(mask_p, num_frames=n, size=(h, w), fps=fps)[:, :1]
        mask[:, :, 0] = 0.0  # frame 0 is kept
    else:
        mask = np.ones((1, 1, n, h, w), np.float32)
    if params.get("input_image_path"):
        img = load_image(params["input_image_path"], size=(h, w))
        controls[0][:, :, 0] = img[:, :, 0]
    return controls, mask


def run_generate_request(pipe, params: dict, progress=None,
                         staged_factories=None) -> np.ndarray:
    """One generate request: load_request_inputs, then run_loaded_request
    (uint8 frames [B, T, H, W, 3]; staged residency with
    `staged_factories`). Shared by the model server, the API server's
    in-process tier and the generate CLI."""
    controls, mask = load_request_inputs(params)
    return run_loaded_request(pipe, params, controls, mask, progress, staged_factories)


def save_generated_video(video: np.ndarray, params: dict,
                         default_dir: str = "outputs/serve") -> str:
    """Writes video[0] as <save_path>/generated_video_N.mp4 (N counts the
    files there) and returns the path."""
    from versecrafter_tpu_torch.utils.video import save_video

    out_dir = params.get("save_path", default_dir)
    os.makedirs(out_dir, exist_ok=True)
    idx = len([p for p in os.listdir(out_dir) if p.startswith("generated_video_")])
    path = os.path.join(out_dir, f"generated_video_{idx}.mp4")
    save_video(video[0], path, fps=int(params.get("fps", 16)))
    return path


class RankTasks:
    """The model's tasks in a torchrun world. Rank 0 announces each one,
    (op, params) with op in load / generate / unload / shutdown, before it
    runs it (task()), and the other ranks run the same ones in follow().
    Announcements travel on utils/cache.control_group(), whose timeout
    covers any idle time. After each task every rank reports whether it
    succeeded and whether it holds the pipeline: rank 0 fails the task when
    any rank failed, and where the ranks disagree on the pipeline each drops
    its own, so the next task builds it on all of them. `lock` keeps one
    announced task at a time on rank 0 (its collectives must not
    interleave). loaded / drop: rank 0's pipeline, held by its server. One
    process: no announcements."""

    def __init__(self, loaded: Callable[[], bool] = lambda: False,
                 drop: Callable[[], None] = lambda: None):
        import torch.distributed as dist
        self.world = world_size()
        self.rank = dist.get_rank() if self.world > 1 else 0
        self.lock = threading.RLock()
        self._loaded, self._drop = loaded, drop

    def _send(self, op: str, params: Optional[dict] = None) -> None:
        import torch.distributed as dist
        from versecrafter_tpu_torch.utils.cache import control_group
        dist.broadcast_object_list([(op, params)], src=0, group=control_group())

    def _receive(self):
        import torch.distributed as dist
        from versecrafter_tpu_torch.utils.cache import control_group
        box = [None]
        dist.broadcast_object_list(box, src=0, group=control_group())
        return box[0]

    def _agree(self, ok: bool, loaded: bool):
        """Every rank's outcome of the last task -> (the ranks where it
        failed, whether the ranks disagree on holding the pipeline)."""
        import torch.distributed as dist
        from versecrafter_tpu_torch.utils.cache import control_group
        states = [None] * self.world
        dist.all_gather_object(states, (ok, loaded), group=control_group())
        return ([r for r, (good, _) in enumerate(states) if not good],
                len({held for _, held in states}) > 1)

    @contextlib.contextmanager
    def task(self, op: str, params: Optional[dict] = None):
        """Rank 0 runs the body as task `op`: announced first, agreed on
        after. RuntimeError when it failed on another rank only."""
        with self.lock:
            if self.world == 1:
                yield
                return
            self._send(op, params)
            ok = False
            try:
                yield
                ok = True
            finally:
                failed, mixed = self._agree(ok, self._loaded())
                if mixed:
                    self._drop()
            if failed:
                raise RuntimeError(f"task {op!r} failed on rank(s) {failed}")

    def shutdown(self) -> None:
        """Rank 0 ends every other rank's follow()."""
        with self.lock:
            if self.world > 1:
                self._send("shutdown")

    def follow(self, pipeline_factory: Callable[[], Any], staged_factories=None) -> None:
        """A rank > 0: run rank 0's tasks until it announces shutdown."""
        pipe = None
        while True:
            op, params = self._receive()
            if op == "shutdown":
                return
            ok = False
            try:
                if op == "unload":
                    pipe = None
                    _free_device()
                else:
                    if pipe is None:
                        pipe = pipeline_factory()
                    if op == "generate":
                        run_generate_request(pipe, params, None, staged_factories)
                ok = True
            except Exception:  # noqa: BLE001 — rank 0 reports the task's failure
                traceback.print_exc()
            _, mixed = self._agree(ok, pipe is not None)
            if mixed:
                pipe = None
                _free_device()


def _free_device():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class ModelServer:
    """pipeline_factory builds the pipeline on the first request; requests
    run one at a time, in order, on one worker thread. _generate and _save
    are the override points (what a request runs and where its frames go).
    staged_factories (sampling.staged.StageFactories): serve with staged
    residency, the pipeline a shell whose weights each request builds and
    frees stage by stage (staged.staged_pipeline_factory makes both). In a
    torchrun world this object lives on every rank: rank 0 serves (serve())
    and the others follow its tasks."""

    def __init__(self, pipeline_factory: Callable[[], Any],
                 output_dir: str = "outputs/serve", staged_factories=None):
        self.pipeline_factory = pipeline_factory
        self.staged_factories = staged_factories
        self.output_dir = output_dir
        self.tasks = TaskRegistry()
        self.queue: "queue.Queue" = queue.Queue()
        self.last_step_stats: dict = {}
        self.last_wall_profile: dict = {}
        self.last_stage_profile: dict = {}
        self._pipeline = None
        self._lock = threading.Lock()
        self.ranks = RankTasks(loaded=lambda: self._pipeline is not None,
                               drop=self._drop_pipeline)
        if self.ranks.rank == 0:
            self._worker = threading.Thread(target=self._work_loop, daemon=True)
            self._worker.start()

    @property
    def model_loaded(self) -> bool:
        return self._pipeline is not None

    def _drop_pipeline(self):
        with self._lock:
            self._pipeline = None

    def _get_pipeline(self):
        with self._lock:
            if self._pipeline is None:
                self._pipeline = self.pipeline_factory()
            return self._pipeline

    def _work_loop(self):
        while True:
            self._run_task(*self.queue.get())

    def _run_task(self, task_id: str, params: dict):
        """One queued request. Its references to the pipeline and the frames
        end when it returns, so an /unload while the worker waits for the
        next request frees the device memory."""
        from versecrafter_tpu_torch.utils.profiling import StepTimer

        try:
            self.tasks.update(task_id, status=RUNNING, message="loading model")
            timer = StepTimer()

            def progress(i, n):
                timer.tick(i, n)
                self.tasks.update(task_id, progress=int(100 * i / n),
                                  message=f"step {i}/{n}")

            with self.ranks.task("generate", params):
                pipe = self._get_pipeline()
                self.tasks.update(task_id, status=RUNNING, message="generating")
                video = self._generate(pipe, params, progress)
            self.last_step_stats = timer.summary()
            self.last_wall_profile = dict(getattr(pipe, "last_wall_profile", {}))
            self.last_stage_profile = dict(getattr(pipe, "last_stage_profile", {}))
            out_path = self._save(video, params)
            self.tasks.update(task_id, status=COMPLETED, progress=100,
                              result={"video_path": out_path})
        except Exception as e:  # noqa: BLE001 — task boundary
            self.tasks.update(task_id, status=FAILED, error=str(e),
                              message=traceback.format_exc()[-2000:])

    def _generate(self, pipe, params: dict, progress):
        return run_generate_request(pipe, params, progress, self.staged_factories)

    def _save(self, video: np.ndarray, params: dict) -> str:
        return save_generated_video(video, params, self.output_dir)

    def submit(self, params: dict) -> str:
        t = self.tasks.create("generate")
        self.queue.put((t.task_id, params))
        return t.task_id

    def unload(self) -> bool:
        """Drops the pipeline and returns the device's cached blocks (on
        every rank); the next request builds it again. True if one was
        loaded."""
        with self.ranks.task("unload"):
            with self._lock:
                was = self._pipeline is not None
                self._pipeline = None
            _free_device()
        return was

    def serve(self, host: str, port: int) -> None:
        """Rank 0 serves HTTP until interrupted, then tells the other ranks
        to stop; every other rank follows rank 0's tasks."""
        if self.ranks.rank > 0:
            self.ranks.follow(self.pipeline_factory, self.staged_factories)
            return
        httpd = make_server(build_router(self), host, port)
        print(f"model server on {host}:{port} ({self.ranks.world} rank(s))", flush=True)
        try:
            httpd.serve_forever()
        finally:
            self.ranks.shutdown()


def build_router(server: ModelServer) -> Router:
    r = Router()

    @r.route("GET", "/health")
    def health(req):
        return 200, {"status": "ok", "model_loaded": server.model_loaded}

    @r.route("POST", "/generate")
    def generate(req):
        return 200, {"task_id": server.submit(req.json())}

    @r.route("GET", "/status/<task_id>")
    def status(req):
        t = server.tasks.get(req.params["task_id"])
        return (200, t) if t else (404, {"error": "unknown task"})

    @r.route("POST", "/unload")
    def unload(req):
        return 200, {"unloaded": server.unload()}

    @r.route("GET", "/metrics")
    def metrics(req):
        return 200, {
            "model_loaded": server.model_loaded,
            "queue_depth": server.queue.qsize(),
            "tasks": len(server.tasks.all()),
            "last_generation_step_ms": server.last_step_stats,
            "last_generation_wall_profile_s": server.last_wall_profile,
            # staged residency: the last request's build / run split by stage
            "last_generation_stage_profile_s": server.last_stage_profile,
        }

    return r


def main(argv=None):
    p = argparse.ArgumentParser(description="VerseCrafter model server (PyTorch)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8191)
    p.add_argument("--model_path", default=None,
                   help="reference-layout model directory (config.json, DiT "
                        "safetensors, Wan2.1_VAE.pth, umT5 .pth); the random-"
                        "weight 1.3B pipeline without it")
    p.add_argument("--output_dir", default="outputs/serve")
    p.add_argument("--device", default="cuda")
    p.add_argument("--ulysses_degree", type=int, default=1)
    p.add_argument("--ring_degree", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--auto_mesh", action="store_true",
                   help="factorise the torchrun world into (sp, tp) (core.mesh."
                        "auto_mesh_spec)")
    p.add_argument("--staged", action="store_true",
                   help="staged weight residency: umT5, the VAE and the quantized DiT "
                        "built and freed per request stage instead of staying resident")
    p.add_argument("--staged_scale", default="14b", choices=["14b", "1.3b", "tiny"],
                   help="with --staged and no --model_path: the random-weight size")
    p.add_argument("--quantize_bits", type=int, default=4, choices=(8, 4),
                   help="with --staged: the DiT's weight width (W8A8 / W4A8)")
    p.add_argument("--resident_weights", default="bf16", choices=sorted(RESIDENT_WEIGHTS),
                   help="the DiT quantized as it loads, each expert of a pair before "
                        "the next is read (a Wan2.2-A14B pair fits one 80 GB card as "
                        "int8 or w8a8, not as bf16)")
    args = p.parse_args(argv)
    from versecrafter_tpu_torch.utils.cache import maybe_init_distributed
    maybe_init_distributed(resolve_device(args.device))
    spec = spec_from_degrees(args.ulysses_degree, args.ring_degree, args.tp)
    check_world(spec if spec.size > 1 else None, args.auto_mesh)  # before any build

    if args.staged:
        if world_size() > 1:
            raise ValueError("--staged serves on one device")
        from versecrafter_tpu_torch.sampling.staged import staged_pipeline_factory
        factory, staged_factories = staged_pipeline_factory(
            args.model_path, scale=args.staged_scale, bits=args.quantize_bits,
            int8_compute=True, device=args.device)
        server = ModelServer(factory, output_dir=args.output_dir,
                             staged_factories=staged_factories)
    else:
        mesh = {"mesh_spec": spec} if spec.size > 1 else {}
        if args.auto_mesh:
            mesh["auto_mesh"] = True
        server = ModelServer(default_pipeline_factory(
            args.model_path, device=args.device,
            quantize=RESIDENT_WEIGHTS[args.resident_weights], **mesh),
            output_dir=args.output_dir)
    server.serve(args.host, args.port)


if __name__ == "__main__":
    main()
