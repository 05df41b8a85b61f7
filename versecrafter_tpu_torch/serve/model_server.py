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

A request names a control-map directory by the reference's file contract
(load_request_inputs); reading its mp4s needs OpenCV (utils/video.py).
run_loaded_request serves a request whose control videos are already
arrays. The pipeline comes from default_pipeline_factory: a reference-layout
checkpoint directory (core.convert.load_versecrafter) or random weights.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import os
import queue
import threading
import traceback
from typing import Any, Callable, Optional

import numpy as np
import torch

from versecrafter_tpu_torch import resolve_device
from versecrafter_tpu_torch.core.config import (
    T5Config, VAEConfig, WAN21_1_3B, WanDiTConfig, versecrafter_14b)
from versecrafter_tpu_torch.serve.http import Router, make_server
from versecrafter_tpu_torch.serve.tasks import COMPLETED, FAILED, RUNNING, TaskRegistry

CONTROL_NAMES = ["background_RGB.mp4", "background_depth.mp4",
                 "3D_gaussian_RGB.mp4", "3D_gaussian_depth.mp4"]
STAGED = "(ROADMAP queue 1, item 6: staged residency)"
MESH = "(ROADMAP queue 1, item 11: parallelism)"


def pipeline_configs(scale: str):
    """(dit_cfg, vae_cfg, t5_cfg) of a factory scale: '14b' is
    Wan2.1-T2V-14B + GeoAdapter (40 layers, dim 5120, 40 heads, the
    GeoAdapter every 2nd layer with 128 control channels), '1.3b'
    Wan2.1-1.3B + GeoAdapter (15 blocks), both with the full umT5-xxl and
    the Wan VAE; 'tiny' the wiring-smoke widths (head_dim 16, so it runs on
    the CPU only, where attention takes the kernel's plain version)."""
    if scale == "14b":
        return versecrafter_14b(), VAEConfig(), T5Config()
    if scale == "1.3b":
        t5_cfg = T5Config()
        return (dataclasses.replace(WAN21_1_3B, geoada_layers=(), geoada_in_dim=128,
                                    text_dim=t5_cfg.dim), VAEConfig(), t5_cfg)
    if scale == "tiny":
        t5_cfg = T5Config(num_layers=2, dim=512, dim_attn=512, dim_ffn=1024,
                          num_heads=8, vocab=1024)
        return (WanDiTConfig(dim=128, ffn_dim=256, num_heads=8, num_layers=4,
                             geoada_layers=(), geoada_in_dim=128, text_dim=t5_cfg.dim),
                VAEConfig(), t5_cfg)
    raise ValueError(f"unknown scale {scale!r}")


def default_pipeline_factory(model_path: Optional[str] = None,
                             dtype_name: str = "bfloat16",
                             scale: str = "1.3b", device=None, seed: int = 0):
    """A factory of the pipeline, built on the device when called: from the
    reference-layout checkpoint directory `model_path`
    (core.convert.load_versecrafter, weights in `dtype_name`), else the
    pipeline of `scale` (pipeline_configs) from random weights made from
    `seed`: the DiT from seed, the VAE (fp32) from seed + 1, umT5 from
    seed + 2."""
    if model_path:
        def load():
            from versecrafter_tpu_torch.core.convert import load_versecrafter
            return load_versecrafter(model_path, dtype=getattr(torch, dtype_name),
                                     device=device)
        return load
    cfg, vae_cfg, t5_cfg = pipeline_configs(scale)

    def factory():
        from versecrafter_tpu_torch.models.t5 import init_t5
        from versecrafter_tpu_torch.models.vae import init_vae
        from versecrafter_tpu_torch.models.wan_dit import init_wan_dit
        from versecrafter_tpu_torch.sampling.pipeline import VerseCrafterPipeline

        dev = resolve_device(device)
        dtype = getattr(torch, dtype_name)

        def gen(offset):
            return torch.Generator(device=dev).manual_seed(seed + offset)

        return VerseCrafterPipeline(
            dit_params=init_wan_dit(cfg, gen(0), dtype),
            dit_cfg=cfg,
            vae_params=init_vae(vae_cfg, gen(1), torch.float32),
            vae_cfg=vae_cfg,
            t5_params=init_t5(t5_cfg, gen(2), dtype),
            t5_cfg=t5_cfg,
            device=dev,
        )
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


def run_loaded_request(pipe, params: dict, controls, mask, progress=None):
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
    try, so a raising request leaves no toggle behind."""
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
    (uint8 frames [B, T, H, W, 3]). Shared by the model server, the API
    server's in-process tier and the generate CLI. Staged residency raises
    NotImplementedError."""
    if staged_factories is not None:
        raise NotImplementedError(f"staged weight residency is not ported yet {STAGED}")
    controls, mask = load_request_inputs(params)
    return run_loaded_request(pipe, params, controls, mask, progress)


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


class ModelServer:
    """pipeline_factory builds the pipeline on the first request; requests
    run one at a time, in order, on one worker thread. _generate and _save
    are the override points (what a request runs and where its frames go)."""

    def __init__(self, pipeline_factory: Callable[[], Any],
                 output_dir: str = "outputs/serve", staged_factories=None):
        if staged_factories is not None:
            raise NotImplementedError(f"staged weight residency is not ported yet {STAGED}")
        self.pipeline_factory = pipeline_factory
        self.output_dir = output_dir
        self.tasks = TaskRegistry()
        self.queue: "queue.Queue" = queue.Queue()
        self.last_step_stats: dict = {}
        self.last_wall_profile: dict = {}
        self._pipeline = None
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self._work_loop, daemon=True)
        self._worker.start()

    @property
    def model_loaded(self) -> bool:
        return self._pipeline is not None

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
            pipe = self._get_pipeline()
            self.tasks.update(task_id, status=RUNNING, message="generating")
            timer = StepTimer()

            def progress(i, n):
                timer.tick(i, n)
                self.tasks.update(task_id, progress=int(100 * i / n),
                                  message=f"step {i}/{n}")

            video = self._generate(pipe, params, progress)
            self.last_step_stats = timer.summary()
            self.last_wall_profile = dict(getattr(pipe, "last_wall_profile", {}))
            out_path = self._save(video, params)
            self.tasks.update(task_id, status=COMPLETED, progress=100,
                              result={"video_path": out_path})
        except Exception as e:  # noqa: BLE001 — task boundary
            self.tasks.update(task_id, status=FAILED, error=str(e),
                              message=traceback.format_exc()[-2000:])

    def _generate(self, pipe, params: dict, progress):
        return run_generate_request(pipe, params, progress)

    def _save(self, video: np.ndarray, params: dict) -> str:
        return save_generated_video(video, params, self.output_dir)

    def submit(self, params: dict) -> str:
        t = self.tasks.create("generate")
        self.queue.put((t.task_id, params))
        return t.task_id

    def unload(self) -> bool:
        """Drops the pipeline and returns the device's cached blocks; the
        next request builds it again. True if one was loaded."""
        with self._lock:
            was = self._pipeline is not None
            self._pipeline = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return was


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
        }

    return r


def check_ported_serving_flags(args) -> None:
    """The servers' and the generate CLI's flags that are not ported raise
    NotImplementedError naming their ROADMAP item. --staged_scale and
    --quantize_bits act only under --staged, as in the JAX model server, so
    without it they are accepted and do nothing."""
    degrees = [getattr(args, k, 1) for k in ("ulysses_degree", "ring_degree", "tp")]
    if max(degrees) > 1 or getattr(args, "auto_mesh", False) or getattr(
            args, "auto_parallel", False):
        raise NotImplementedError(
            f"sequence / tensor parallel serving is not ported yet {MESH}")
    if getattr(args, "staged", False):
        raise NotImplementedError(f"--staged is not ported yet {STAGED}")


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
    p.add_argument("--auto_mesh", action="store_true", help="not ported yet")
    p.add_argument("--staged", action="store_true", help="not ported yet")
    p.add_argument("--staged_scale", default="14b", choices=["14b", "1.3b", "tiny"],
                   help="with --staged (not ported yet)")
    p.add_argument("--quantize_bits", type=int, default=4, choices=(8, 4),
                   help="with --staged (not ported yet)")
    args = p.parse_args(argv)
    check_ported_serving_flags(args)
    resolve_device(args.device)

    server = ModelServer(default_pipeline_factory(args.model_path, device=args.device),
                         output_dir=args.output_dir)
    httpd = make_server(build_router(server), args.host, args.port)
    print(f"model server on {args.host}:{args.port} ({args.device})", flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
