"""API orchestrator: the HTTP surface the Blender add-on and the reference's
clients call (the port's counterpart of ``versecrafter_tpu.serve.api_server``).

A generate request is dispatched by one of three tiers:
  1. a resident model server (serve/model_server.py) over HTTP, its task's
     progress mirrored every POLL_S seconds and the task failed when the
     remote makes no progress for `model_server_stall_timeout` seconds;
  2. in process, on a pipeline this server loads (in the background with
     start_model_loading_async, else at the first request);
  3. with `subprocess_fallback`, when tier 1 or 2 raised: a fresh
     ``python -m versecrafter_tpu_torch.cli.inference`` process, whose
     "denoise i / n" lines and last line (the mp4 path) are parsed.

Endpoints:
  POST/GET /api/generate[_get]    control maps -> video
  POST/GET /api/render[_get]      trajectories -> the six control videos
                                  (geometry/render.py, on `device`)
  POST     /api/workflow          render, then generate from the rendered maps
  POST/GET /api/preprocess[_get], POST /api/preprocess_sync (blocking)
                                  image -> depth (MoGe) + masks (segmenter)
                                  + fitted Gaussians, on `device`
  GET      /api/status/<task_id>, /api/tasks
  POST     /api/upload, /api/upload_base64, /api/upload_chunk,
           /api/upload_complete; GET /api/upload_base64[_get]
  GET      /api/download/<path>, /api/download_base64/<path>,
           /api/download_chunk/<path> (?offset=&size=), /api/list_files
  GET      /api/health, /health, /api/model_status, /system_stats
  POST/GET /api/unload_model

Every path a request names is resolved inside the workdir (safe_path).

    python -m versecrafter_tpu_torch.serve.api_server --model_server_url http://127.0.0.1:8191
"""

from __future__ import annotations

import argparse
import base64
import gc
import json
import os
import shlex
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
from typing import Optional

import torch

from versecrafter_tpu_torch.serve.http import Router, make_server
from versecrafter_tpu_torch.serve.tasks import (
    COMPLETED, FAILED, RUNNING, ChunkStore, TaskRegistry)

class ApiServer:
    POLL_S = 2.0  # tier 1: seconds between two polls of the model server

    def __init__(self, workdir: str = "outputs/api",
                 model_server_url: Optional[str] = None,
                 pipeline_factory=None,
                 model_server_stall_timeout: float = 1800.0,
                 unload_after_generate: bool = False,
                 subprocess_fallback: bool = False,
                 subprocess_model_args: Optional[list] = None,
                 device=None):
        """`pipeline_factory` builds the in-process pipeline (default: the
        random-weight 1.3B of serve.model_server.default_pipeline_factory on
        `device`); `subprocess_model_args` is appended to every tier-3
        command line (the model it builds), which also gets `--device`.
        unload_after_generate frees the in-process pipeline after each
        request."""
        self.workdir = os.path.abspath(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        self.tasks = TaskRegistry()
        self.chunks = ChunkStore()
        self.model_server_url = model_server_url
        self.model_server_stall_timeout = model_server_stall_timeout
        self.unload_after_generate = unload_after_generate
        self.subprocess_fallback = subprocess_fallback
        self.subprocess_model_args = list(subprocess_model_args or ())
        self.device = device
        self._pipeline = None
        self._pipeline_factory = pipeline_factory
        # a torchrun world's in-process model: the other ranks run what this
        # one announces (serve.model_server.RankTasks)
        from versecrafter_tpu_torch.serve.model_server import RankTasks
        self.ranks = RankTasks(loaded=lambda: self._pipeline is not None,
                               drop=self._drop_pipeline)
        self._loading_lock = threading.Lock()
        self._model_loading = False
        self._model_load_error: Optional[str] = None

    # -- the in-process model's lifecycle ------------------------------------
    def _load_pipeline_locked(self):
        from versecrafter_tpu_torch.serve.model_server import default_pipeline_factory
        factory = self._pipeline_factory or default_pipeline_factory(device=self.device)
        with self.ranks.task("load"):
            self._pipeline = factory()

    def _drop_pipeline(self):
        self._pipeline = None

    def start_model_loading_async(self):
        """Loads the in-process pipeline on a background thread (progress in
        /api/model_status); nothing to do when it is loaded or loading, or
        when generation goes to a model server."""
        with self._loading_lock:
            if (self._pipeline is not None or self._model_loading
                    or self.model_server_url):
                return
            self._model_loading = True

        def worker():
            try:
                with self._loading_lock:
                    if self._pipeline is None:
                        self._load_pipeline_locked()
                self._model_load_error = None
            except Exception as e:  # noqa: BLE001 — surfaced via model_status
                self._model_load_error = str(e)
            finally:
                self._model_loading = False

        threading.Thread(target=worker, daemon=True).start()

    def model_loading_status(self) -> dict:
        return {"model_loaded": self._pipeline is not None,
                "loading": self._model_loading,
                "error": self._model_load_error,
                "model_server_url": self.model_server_url}

    def unload_model(self) -> dict:
        """Drops the in-process pipeline and returns the device's cached
        blocks; the next generate loads it again."""
        with self._loading_lock, self.ranks.task("unload"):
            was_loaded = self._pipeline is not None
            self._pipeline = None
            self._model_load_error = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return {"unloaded": was_loaded}

    def safe_path(self, name: str) -> str:
        """`name` resolved inside the workdir; PermissionError if it escapes."""
        p = os.path.abspath(os.path.join(self.workdir, name))
        if not p.startswith(self.workdir + os.sep) and p != self.workdir:
            raise PermissionError(f"path escapes workdir: {name}")
        return p

    # -- stage runners (threads) ---------------------------------------------
    def _fail(self, task_id: str, error: Exception):
        self.tasks.update(task_id, status=FAILED, error=f"{type(error).__name__}: {error}",
                          message=traceback.format_exc()[-2000:])

    def run_preprocess(self, task_id: str, params: dict):
        """A request's image (inside the workdir) -> estimated_depth/
        (depth_intrinsics.npz + views), object_mask/ (the segmenter's files)
        and fitted_3D_gaussian/gaussian_params.json beside it; result
        {"depth_npz", "gaussian_params", "mask_dir", "num_objects"}, relative
        to the workdir. The detection knobs ride the request (backend,
        box_threshold, text_threshold, min_area_ratio, max_area_ratio,
        max_objects, text_prompt); MoGe runs on `device`. Images and PNGs go
        through the port's own codecs (utils/video.py)."""
        try:
            import numpy as np

            from versecrafter_tpu_torch.geometry.gaussians import process_single_image
            from versecrafter_tpu_torch.perception import moge
            from versecrafter_tpu_torch.perception.segmenter import ImageSegmenter
            from versecrafter_tpu_torch.utils.video import read_image

            self.tasks.update(task_id, status=RUNNING, progress=5, message="estimating depth")
            img_path = self.safe_path(params["image"])
            out_root = os.path.dirname(img_path)
            img = read_image(img_path)
            ph, pw = -img.shape[0] % 14, -img.shape[1] % 14  # the ViT patch multiple
            pimg = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge") if ph or pw else img
            mparams = self._moge_params(params.get("moge_checkpoint"),
                                        params.get("model_version", "v2"))
            out = moge.infer(mparams, pimg.astype(np.float32) / 255.0)
            depth = out["depth"][: img.shape[0], : img.shape[1]]
            out["depth"] = depth
            depth_dir = os.path.join(out_root, "estimated_depth")
            moge.save_outputs(out, depth_dir)

            self.tasks.update(task_id, progress=40, message="segmenting")
            seg = ImageSegmenter(
                backend=params.get("backend", "saliency"),
                box_threshold=float(params.get("box_threshold", 0.25)),
                text_threshold=float(params.get("text_threshold", 0.25)),
                min_area_ratio=float(params.get("min_area_ratio", 0.002)),
                max_area_ratio=float(params.get("max_area_ratio", 0.6)),
                max_objects=int(params.get("max_objects", 5)))
            dets = seg.segment_image(img, params.get("text_prompt", "object."), depth=depth)
            mask_dir = os.path.join(out_root, "object_mask")
            seg.save_results(img, dets, mask_dir, stem=os.path.splitext(
                os.path.basename(img_path))[0])

            self.tasks.update(task_id, progress=70, message="fitting gaussians")
            gdir = os.path.join(out_root, "fitted_3D_gaussian")
            process_single_image(os.path.join(depth_dir, "depth_intrinsics.npz"),
                                 os.path.join(mask_dir, "masks"), gdir,
                                 input_image_path=img_path)
            self.tasks.update(task_id, status=COMPLETED, progress=100, result={
                "depth_npz": os.path.relpath(os.path.join(depth_dir, "depth_intrinsics.npz"),
                                             self.workdir),
                "gaussian_params": os.path.relpath(os.path.join(gdir, "gaussian_params.json"),
                                                   self.workdir),
                "mask_dir": os.path.relpath(mask_dir, self.workdir),
                "num_objects": len(dets),
            })
        except Exception as e:  # noqa: BLE001 — task boundary
            self._fail(task_id, e)

    def _moge_params(self, ckpt: Optional[str], version: str = "v2"):
        """MoGe parameters for a preprocess request: the request's checkpoint
        (inside the workdir), else self.moge_checkpoints[version] when
        configured ('v1' / 'v2', the add-on's depth-model knob), else a
        random full ViT-L from seed 0 on `device`, built once and cached."""
        from versecrafter_tpu_torch import resolve_device
        from versecrafter_tpu_torch.perception import moge

        if not ckpt:
            ckpt = getattr(self, "moge_checkpoints", {}).get(version)
        dev = resolve_device(self.device)
        if ckpt:
            return moge.load_checkpoint(self.safe_path(ckpt), device=dev)
        if getattr(self, "_moge_cache", None) is None:
            self._moge_cache = moge.init_moge(torch.Generator(device=dev).manual_seed(0))
        return self._moge_cache

    def run_render(self, task_id: str, params: dict):
        """The control maps of a request's image, depth npz, masks and
        trajectories (every path inside the workdir) as six mp4s under
        `output_dir`; result {"output_dir", "videos"}, relative to the
        workdir."""
        try:
            from versecrafter_tpu_torch.geometry.render import render_from_files

            self.tasks.update(task_id, status=RUNNING, progress=5,
                              message="rendering control maps")
            out_dir = self.safe_path(params.get("output_dir", "rendering_4D_maps"))
            paths = render_from_files(
                png_path=self.safe_path(params["image"]),
                npz_path=self.safe_path(params["depth_npz"]),
                mask_dir=self.safe_path(params["mask_dir"]) if params.get("mask_dir") else None,
                trajectory_npz=self.safe_path(params["trajectory_npz"]),
                ellipsoid_json=self.safe_path(params["ellipsoid_json"]),
                output_dir=out_dir,
                point_size=float(params.get("point_size", 0.005)),
                fps=int(params.get("fps", 16)),
                device=self.device)
            self.tasks.update(task_id, status=COMPLETED, progress=100, result={
                "output_dir": os.path.relpath(out_dir, self.workdir),
                "videos": {k: os.path.relpath(v, self.workdir) for k, v in paths.items()}})
        except Exception as e:  # noqa: BLE001 — task boundary
            self._fail(task_id, e)

    def run_generate(self, task_id: str, params: dict):
        try:
            params = dict(params)
            params["rendering_maps_path"] = self.safe_path(params["rendering_maps_path"])
            if params.get("input_image_path"):
                params["input_image_path"] = self.safe_path(params["input_image_path"])
            params.setdefault("save_path", os.path.join(self.workdir, "generated"))
            try:
                if self.model_server_url:
                    self._generate_via_model_server(task_id, params)
                else:
                    self._generate_in_process(task_id, params)
            except Exception as e:  # noqa: BLE001 — tier-3 degraded path
                if not self.subprocess_fallback:
                    raise
                self.tasks.update(task_id, status=RUNNING,
                                  message=f"resident generation failed ({e}); "
                                          "falling back to subprocess")
                self._generate_via_subprocess(task_id, params)
        except Exception as e:  # noqa: BLE001 — task boundary
            self._fail(task_id, e)

    def _generate_via_model_server(self, task_id: str, params: dict):
        """Tier 1: POST /generate, then mirror /status/<id> every POLL_S s.
        Five failed polls in a row, or a remote task that stays RUNNING with
        no change of status, progress or message for
        model_server_stall_timeout seconds, raise."""
        self.tasks.update(task_id, status=RUNNING, message="dispatching")
        req = urllib.request.Request(
            f"{self.model_server_url}/generate", data=json.dumps(params).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            remote_id = json.loads(resp.read())["task_id"]

        errors = 0
        last_state = None
        last_change = time.monotonic()
        while True:
            try:
                with urllib.request.urlopen(
                        f"{self.model_server_url}/status/{remote_id}", timeout=30) as r:
                    st = json.loads(r.read())
                errors = 0
            except Exception as e:  # noqa: BLE001 — transient poll failure
                errors += 1
                if errors >= 5:
                    raise RuntimeError(f"model server unreachable after {errors} polls: {e}")
                time.sleep(self.POLL_S)
                continue
            self.tasks.update(task_id, progress=st["progress"], message=st["message"])
            if st["status"] in (COMPLETED, FAILED):
                self.tasks.update(task_id, status=st["status"], result=st.get("result"),
                                  error=st.get("error"))
                return
            state = (st["status"], st["progress"], st["message"])
            if state != last_state:
                last_state = state
                last_change = time.monotonic()
            elif time.monotonic() - last_change > self.model_server_stall_timeout:
                raise RuntimeError(
                    f"model server task {remote_id} made no progress for "
                    f"{self.model_server_stall_timeout:.0f}s (stuck at {state}); giving up")
            time.sleep(self.POLL_S)

    def _generate_in_process(self, task_id: str, params: dict):
        from versecrafter_tpu_torch.serve.model_server import (
            run_generate_request, save_generated_video)

        with self._loading_lock:  # waits out a background load in flight
            if self._pipeline is None:
                self.tasks.update(task_id, status=RUNNING, message="loading model")
                self._load_pipeline_locked()
        self.tasks.update(task_id, status=RUNNING, message="generating")

        def progress(i, n):
            self.tasks.update(task_id, progress=int(100 * i / n), message=f"step {i}/{n}")

        with self.ranks.task("generate", params):
            video = run_generate_request(self._pipeline, params, progress)
        out = save_generated_video(video, params, params["save_path"])
        self.tasks.update(task_id, status=COMPLETED, progress=100,
                          result={"video_path": os.path.relpath(out, self.workdir)})
        if self.unload_after_generate:
            self.unload_model()

    def _build_subprocess_argv(self, params: dict) -> list:
        """A generate request -> the generate CLI's command line (tier 3):
        the params that have a flag (a quantize mode as --quantize_int8
        --quantize_bits N, with --int8_compute), TeaCache pinned off unless
        the request sets it (the CLI's default is 0.10), --device, then
        subprocess_model_args."""
        from versecrafter_tpu_torch.serve.model_server import _requested_quant_mode

        argv = [sys.executable, "-m", "versecrafter_tpu_torch.cli.inference",
                "--rendering_maps_path", params["rendering_maps_path"],
                "--prompt", str(params.get("prompt", "")),
                "--input_image_path", str(params.get("input_image_path", "")),
                "--save_path", params.get("save_path", os.path.join(self.workdir, "generated")),
                "--sample_size", f"{int(params.get('height', 480))},"
                                 f"{int(params.get('width', 832))}",
                "--video_length", str(int(params.get("num_frames", 81)))]
        flag_map = {"num_inference_steps": int, "guidance_scale": float,
                    "seed": int, "fps": int, "shift": float,
                    "teacache_threshold": float, "teacache_skip_start": int,
                    "cfg_skip_ratio": float}
        for key, cast in flag_map.items():
            if key in params:
                argv += [f"--{key}", str(cast(params[key]))]
        if "teacache_threshold" not in params:
            argv += ["--teacache_threshold", "0"]
        if params.get("int8_attention"):
            argv.append("--int8_attention")
        qmode = _requested_quant_mode(params)
        if qmode is not None:  # the CLI quantizes only with --quantize_int8
            argv += ["--quantize_int8", "--quantize_bits", str(qmode[0])]
            if qmode[1]:
                argv.append("--int8_compute")
        argv += ["--device", str(self.device or "cuda")]
        return argv + self.subprocess_model_args

    def _generate_via_subprocess(self, task_id: str, params: dict):
        """Tier 3: the request in a fresh generate-CLI process; its output is
        streamed into the task (progress from "denoise i / n", the result
        from the last line naming an existing .mp4)."""
        argv = self._build_subprocess_argv(params)
        self.tasks.update(task_id, status=RUNNING, message="subprocess: starting")
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        last_path = None
        tail = []
        for line in proc.stdout:
            line = line.strip()
            if not line:
                continue
            tail = (tail + [line])[-20:]
            if line.startswith("denoise "):
                try:  # "denoise i / n"
                    i, n = line[8:].split(" / ")
                    self.tasks.update(task_id, progress=int(100 * int(i) / int(n)),
                                      message=f"subprocess: step {i}/{n}")
                except ValueError:
                    pass
            elif line.endswith(".mp4") and os.path.exists(line):
                last_path = line
        rc = proc.wait()
        if rc != 0 or last_path is None:
            raise RuntimeError(f"subprocess fallback failed (rc={rc}); tail:\n"
                               + "\n".join(tail))
        self.tasks.update(task_id, status=COMPLETED, progress=100,
                          result={"video_path": os.path.relpath(last_path, self.workdir)})

    def run_workflow(self, task_id: str, params: dict):
        """Render, then generate from the rendered maps."""
        self.run_render(task_id, params)
        st = self.tasks.get(task_id)
        if st["status"] != COMPLETED:
            return
        gen = dict(params)
        gen["rendering_maps_path"] = st["result"]["output_dir"]
        self.tasks.update(task_id, status=RUNNING, progress=50,
                          message="rendering done; generating")
        self.run_generate(task_id, gen)


def system_stats() -> dict:
    """The visible CUDA devices: name, bytes allocated by this process, and
    free / total bytes on the card."""
    devices = []
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            free, total = torch.cuda.mem_get_info(i)
            devices.append({"id": i, "platform": "gpu",
                            "kind": torch.cuda.get_device_name(i),
                            "bytes_in_use": torch.cuda.memory_allocated(i),
                            "bytes_free": free, "bytes_limit": total})
    return {"devices": devices, "backend": "cuda" if devices else "cpu"}


def build_router(server: ApiServer) -> Router:
    r = Router()

    def spawn(kind, runner, params):
        t = server.tasks.create(kind)
        threading.Thread(target=runner, args=(t.task_id, params), daemon=True).start()
        return 200, {"task_id": t.task_id, "status": "PENDING"}

    # --- workflow endpoints (POST + GET mirrors) ----------------------------
    for kind, runner in (("preprocess", server.run_preprocess),
                         ("render", server.run_render),
                         ("generate", server.run_generate),
                         ("workflow", server.run_workflow)):
        def make(kind=kind, runner=runner):
            def post(req):
                return spawn(kind, runner, req.json())

            def get(req):
                return spawn(kind, runner, dict(req.query))
            return post, get
        post, get = make()
        r.add("POST", f"/api/{kind}", post)
        r.add("GET", f"/api/{kind}_get", get)

    @r.route("GET", "/api/status/<task_id>")
    def status(req):
        t = server.tasks.get(req.params["task_id"])
        return (200, t) if t else (404, {"error": "unknown task"})

    @r.route("GET", "/api/tasks")
    def tasks(req):
        return 200, {"tasks": server.tasks.all()}

    # --- uploads -------------------------------------------------------------
    def _write(name, data, append=False):
        p = server.safe_path(name)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "ab" if append else "wb") as f:
            f.write(data)

    @r.route("POST", "/api/upload")
    def upload(req):
        name = req.query.get("filename") or req.headers.get("X-Filename")
        if not name:
            return 400, {"error": "filename required (query or X-Filename)"}
        _write(name, req.body)
        return 200, {"filename": name, "size": len(req.body)}

    def _write_b64(name, data, append=False):
        if not name:
            return 400, {"error": "filename required"}
        _write(name, base64.b64decode(data), append)
        return 200, {"success": True, "filename": name}

    @r.route("GET", "/api/upload_base64_get")
    def upload_b64(req):
        return _write_b64(req.query.get("filename"), req.query.get("data", ""),
                          append=req.query.get("append") == "1")

    @r.route("POST", "/api/upload_base64")
    def upload_b64_post(req):
        body = req.json() or {}
        return _write_b64(body.get("filename"), body.get("data", ""))

    @r.route("GET", "/api/upload_base64")
    def upload_b64_get_alias(req):
        return _write_b64(req.query.get("filename"), req.query.get("data", ""))

    @r.route("POST", "/api/upload_chunk")
    def upload_chunk(req):
        q = req.query
        server.chunks.put(q["upload_id"], int(q["index"]), req.body,
                          total=int(q["total"]) if "total" in q else None,
                          filename=q.get("filename"))
        return 200, {"received": int(q["index"])}

    @r.route("POST", "/api/upload_complete")
    def upload_complete(req):
        q = req.json() or req.query
        data = server.chunks.complete(q["upload_id"])
        if data is None:
            return 400, {"error": "missing chunks"}
        _write(q["filename"], data)
        return 200, {"filename": q["filename"], "size": len(data)}

    # --- downloads -----------------------------------------------------------
    def _file(req):
        p = server.safe_path(req.params["path"].replace("%2F", "/"))
        return p if os.path.isfile(p) else None

    @r.route("GET", "/api/download/<path:path>")
    def download(req):
        p = _file(req)
        if p is None:
            return 404, {"error": "not found"}
        with open(p, "rb") as f:
            return 200, (f.read(), "application/octet-stream")

    @r.route("GET", "/api/download_base64/<path:path>")
    def download_b64(req):
        p = _file(req)
        if p is None:
            return 404, {"error": "not found"}
        with open(p, "rb") as f:
            return 200, {"data": base64.b64encode(f.read()).decode()}

    @r.route("GET", "/api/download_chunk/<path:path>")
    def download_chunk(req):
        p = _file(req)
        if p is None:
            return 404, {"error": "not found"}
        off = int(req.query.get("offset", 0))
        size = int(req.query.get("size", 1 << 20))
        total = os.path.getsize(p)
        with open(p, "rb") as f:
            f.seek(off)
            chunk = f.read(size)
        return 200, {"data": base64.b64encode(chunk).decode(),
                     "offset": off, "total": total, "done": off + len(chunk) >= total}

    @r.route("GET", "/api/list_files")
    def list_files(req):
        rel = req.query.get("path", "")
        try:
            dirpath = server.safe_path(rel) if rel else server.workdir
        except PermissionError as e:
            return 400, {"error": str(e)}
        if not os.path.isdir(dirpath):
            return 404, {"error": f"Directory not found: {rel}"}
        files = []
        for item in sorted(os.listdir(dirpath)):
            ip = os.path.join(dirpath, item)
            files.append({"name": item, "path": os.path.relpath(ip, server.workdir),
                          "is_dir": os.path.isdir(ip),
                          "size": os.path.getsize(ip) if os.path.isfile(ip) else 0})
        return 200, {"files": files, "path": rel}

    @r.route("POST", "/api/preprocess_sync")
    def preprocess_sync(req):
        params = req.json() or {}
        if "image" not in params:
            return 400, {"error": "Missing required field: image"}
        t = server.tasks.create("preprocess_sync")
        server.run_preprocess(t.task_id, params)  # blocking, in the request
        st = server.tasks.get(t.task_id)
        if st["status"] == COMPLETED:
            return 200, {"status": "completed", "result": st["result"]}
        return 500, {"status": "failed", "error": st.get("error")}

    # --- status / stats ------------------------------------------------------
    @r.route("GET", "/api/health")
    def health(req):
        return 200, {"status": "ok"}

    @r.route("GET", "/health")
    def health_top(req):
        return 200, {"status": "ok", "server": "VerseCrafter API", "version": "1.0"}

    @r.route("POST", "/api/unload_model")
    def unload_model(req):
        return 200, server.unload_model()

    @r.route("GET", "/api/unload_model")
    def unload_model_get(req):
        return 200, server.unload_model()

    @r.route("GET", "/api/model_status")
    def model_status(req):
        return 200, server.model_loading_status()

    @r.route("GET", "/system_stats")
    def stats(req):
        return 200, system_stats()

    return r


def main(argv=None):
    p = argparse.ArgumentParser(description="VerseCrafter API server (PyTorch)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8190)
    p.add_argument("--workdir", default="outputs/api")
    p.add_argument("--model_server_url", default=None)
    p.add_argument("--model_path", default=None,
                   help="reference-layout model directory for the in-process tier")
    p.add_argument("--device", default="cuda")
    p.add_argument("--auto_mesh", action="store_true",
                   help="shard the in-process model over the torchrun world "
                        "(core.mesh.auto_mesh_spec of its size); rank 0 serves")
    p.add_argument("--preload_model", action="store_true",
                   help="load the in-process model in the background at start-up "
                        "(progress at /api/model_status)")
    p.add_argument("--unload_after_generate", action="store_true",
                   help="free the in-process model after each generation")
    p.add_argument("--subprocess_fallback", action="store_true",
                   help="when the resident tiers raise, run the request in a "
                        "fresh generate-CLI process")
    p.add_argument("--subprocess_model_args", default="",
                   help="argv appended to every fallback command line, e.g. "
                        "'--model_name <dir>'")
    args = p.parse_args(argv)

    from versecrafter_tpu_torch import resolve_device
    from versecrafter_tpu_torch.serve.model_server import RankTasks, default_pipeline_factory
    from versecrafter_tpu_torch.utils.cache import maybe_init_distributed
    maybe_init_distributed(resolve_device(args.device))
    factory = default_pipeline_factory(args.model_path, device=args.device,
                                       auto_mesh=args.auto_mesh)
    ranks = RankTasks()
    if ranks.rank > 0:  # the in-process model's other ranks
        ranks.follow(factory)
        return
    server = ApiServer(workdir=args.workdir,
                       model_server_url=args.model_server_url,
                       pipeline_factory=factory,
                       unload_after_generate=args.unload_after_generate,
                       subprocess_fallback=args.subprocess_fallback,
                       subprocess_model_args=shlex.split(args.subprocess_model_args),
                       device=args.device)
    if args.preload_model:
        server.start_model_loading_async()
    httpd = make_server(build_router(server), args.host, args.port)
    print(f"api server on {args.host}:{args.port} (workdir {server.workdir}, "
          f"{args.device})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        server.ranks.shutdown()


if __name__ == "__main__":
    main()
