"""Port parity for the serving tiers over real HTTP on 127.0.0.1 (CPU): the
port's ModelServer serving a request by the mp4 map contract against the
JAX package's run_generate_request on the same weights; the ApiServer's
uploads, downloads and path guard, its model-server, in-process and
subprocess tiers; the render and workflow tasks; the generate CLI; and the
tasks and flags that wait for unported slices."""

import base64
import dataclasses
import json
import os
import sys
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_convert import _port, _randomized_dit, _init
from test_torch_pipeline import DIT_CFG, T5_CFG, VAE_CFG
from test_torch_video_io import _maps
from test_torch_render import write_scene_files
from versecrafter_tpu.sampling import pipeline as jpipe
from versecrafter_tpu.serve import api_server as japi
from versecrafter_tpu.serve import model_server as jserve
from versecrafter_tpu.utils import video as jvideo
from versecrafter_tpu_torch.cli import inference as tinf
from versecrafter_tpu_torch.core import config as tconfig
from versecrafter_tpu_torch.core.convert import params_from_jax
from versecrafter_tpu_torch.models import t5 as tt5
from versecrafter_tpu_torch.models import vae as tvae
from versecrafter_tpu_torch.models import wan_dit as twan
from versecrafter_tpu_torch.sampling import pipeline as tpipe
from versecrafter_tpu_torch.serve import api_server as tapi
from versecrafter_tpu_torch.serve import model_server as tserve
from versecrafter_tpu_torch.geometry.synthetic import synthetic_scene
from versecrafter_tpu_torch.serve.http import make_server, serve_forever_in_thread
from versecrafter_tpu_torch.utils.tokenizer import HashTokenizer
from tests.jax_prng import threefry_default  # noqa: F401

# four control videos of z_dim 4 plus the 2x2 pixel-shuffled mask
CFG = dataclasses.replace(DIT_CFG, geoada_in_dim=20)
H, W, N = 8, 16, 5
REQUEST = {"prompt": "a car drives left", "negative_prompt": "static",
           "num_inference_steps": 2, "guidance_scale": 2.0, "shift": 3.0,
           "seed": 7, "height": H, "width": W, "num_frames": N, "fps": 16}


class JaxFP32(jpipe.VerseCrafterPipeline):
    """The serving path calls the pipeline without a dtype (bf16); these
    test pipelines compute in fp32, where the two packages agree within
    1e-4*max (tests/test_torch_pipeline.py), so their uint8 frames lie at
    most one level apart."""

    def __call__(self, *a, **kw):
        return super().__call__(*a, dtype=jnp.float32, **kw)


class TorchFP32(tpipe.VerseCrafterPipeline):
    def __call__(self, *a, **kw):
        return super().__call__(*a, dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def pipes():
    dit = _randomized_dit(CFG, seed=3)
    vae = _init(tvae.init_vae, VAE_CFG, 4, tconfig.VAEConfig)
    t5 = _init(tt5.init_t5, T5_CFG, 5, tconfig.T5Config)
    tok = HashTokenizer(T5_CFG.vocab)
    jp = JaxFP32(
        dit_params=dit, dit_cfg=CFG, vae_params=vae, vae_cfg=VAE_CFG, t5_params=t5,
        t5_cfg=T5_CFG, attn_impl="pallas", tokenizer=tok)
    tp = TorchFP32(
        dit_params=params_from_jax(dit), dit_cfg=_port(CFG, tconfig.WanDiTConfig),
        vae_params=params_from_jax(vae), vae_cfg=_port(VAE_CFG, tconfig.VAEConfig),
        t5_params=params_from_jax(t5), t5_cfg=_port(T5_CFG, tconfig.T5Config),
        tokenizer=tok, device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The API server's workdir, holding a map directory (background_RGB.mp4
    missing, as in the reference's demo clips) and an input image."""
    d = tmp_path_factory.mktemp("api")
    _maps(str(d / "maps"), tserve.CONTROL_NAMES[1:] + ["merged_mask.mp4"])
    jvideo.save_image(np.full((12, 20, 3), 0.25, np.float32), str(d / "input.png"))
    return d


class KeepingModelServer(tserve.ModelServer):
    """Keeps each request's frames beside the mp4 it writes."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.frames = []

    def _save(self, video, params):
        self.frames.append(video)
        return super()._save(video, params)


def _serve(router):
    httpd = make_server(router, "127.0.0.1", 0)
    serve_forever_in_thread(httpd)
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _call(url, method="GET", body=None, headers=None):
    """(status, parsed JSON or raw bytes) of one HTTP call."""
    data = (body if isinstance(body, bytes) or body is None
            else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            status, raw, ctype = r.status, r.read(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        status, raw, ctype = e.code, e.read(), e.headers["Content-Type"]
    return status, (json.loads(raw) if ctype == "application/json" else raw)


def _wait(url, timeout=120):
    """Polls a task until it ends; returns its last state and every
    progress value seen."""
    seen = []
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        st = _call(url)[1]
        seen.append(st["progress"])
        if st["status"] in ("COMPLETED", "FAILED"):
            return st, seen
        time.sleep(0.05)
    raise AssertionError(f"{url} did not finish in {timeout} s")


@pytest.fixture(scope="module")
def model_server(pipes, workdir):
    server = KeepingModelServer(lambda: pipes[1], output_dir=str(workdir / "served"))
    httpd, url = _serve(tserve.build_router(server))
    yield server, url
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture(scope="module")
def api(model_server, workdir):
    """An ApiServer whose generate tier is the model server above."""
    server = tapi.ApiServer(workdir=str(workdir), model_server_url=model_server[1],
                            device="cpu")
    server.POLL_S = 0.1
    httpd, url = _serve(tapi.build_router(server))
    yield server, url
    httpd.shutdown()
    httpd.server_close()


def _request(workdir, **kw):
    return {**REQUEST, "rendering_maps_path": str(workdir / "maps"),
            "input_image_path": str(workdir / "input.png"), **kw}


def test_model_server_serves_the_jax_request(pipes, model_server, workdir):
    """/health, /generate, /status, /metrics and /unload over HTTP; the
    served frames are the JAX package's run_generate_request's."""
    jp, _ = pipes
    server, url = model_server
    assert _call(f"{url}/health")[1] == {"status": "ok", "model_loaded": False}
    params = _request(workdir)
    status, body = _call(f"{url}/generate", "POST", params)
    assert status == 200
    st, seen = _wait(f"{url}/status/{body['task_id']}")
    assert st["status"] == "COMPLETED", st
    assert seen == sorted(seen) and seen[-1] == 100
    assert os.path.isfile(st["result"]["video_path"])
    assert _call(f"{url}/health")[1]["model_loaded"] is True
    metrics = _call(f"{url}/metrics")[1]
    assert metrics["queue_depth"] == 0 and metrics["tasks"] >= 1
    assert metrics["last_generation_step_ms"]["steps"] == REQUEST["num_inference_steps"] - 1
    assert {"text_encode", "encode_controls", "denoise", "vae_decode"} <= set(
        metrics["last_generation_wall_profile_s"])

    ref = np.asarray(jserve.run_generate_request(jp, params))
    got = server.frames[-1]
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape == (1, N, H, W, 3)
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert _call(f"{url}/status/nope")[0] == 404
    assert _call(f"{url}/unload", "POST")[1] == {"unloaded": True}
    assert _call(f"{url}/health")[1]["model_loaded"] is False


@pytest.mark.parametrize("bad,match", [
    ({"rendering_maps_path": "/nonexistent/maps"}, "no control maps"),
    ({"quantize_bits": 3}, "must be 8 or 4"),
])
def test_model_server_failed_tasks(model_server, workdir, bad, match):
    _, url = model_server
    task = _call(f"{url}/generate", "POST", _request(workdir, **bad))[1]["task_id"]
    st, _ = _wait(f"{url}/status/{task}")
    assert st["status"] == "FAILED" and match in st["error"]


def test_toggles_restored_after_a_raising_request(pipes, model_server, workdir,
                                                  monkeypatch):
    """A request that applies int8 attention, TeaCache and cfg-skip and then
    raises inside the pipeline call leaves the resident pipeline as it was."""
    _, tp = pipes
    _, url = model_server
    seen = []

    def raising(pipe, *a):
        seen.append((twan.INT8_QK_SCORE, pipe.teacache_threshold, pipe.cfg_skip_ratio))
        raise RuntimeError("pipeline failed")
    monkeypatch.setattr(tserve, "_call_pipe", raising)
    before = (twan.INT8_QK_SCORE, tp.teacache_threshold, tp.teacache_skip_start,
              tp.teacache_coefficients, tp.cfg_skip_ratio)
    task = _call(f"{url}/generate", "POST", _request(
        workdir, int8_attention=True, teacache_threshold=0.3, teacache_skip_start=1,
        cfg_skip_ratio=0.5))[1]["task_id"]
    st, _ = _wait(f"{url}/status/{task}")
    assert st["status"] == "FAILED" and st["error"] == "pipeline failed"
    assert seen == [(True, 0.3, 0.5)]
    assert (twan.INT8_QK_SCORE, tp.teacache_threshold, tp.teacache_skip_start,
            tp.teacache_coefficients, tp.cfg_skip_ratio) == before


# ---------------------------------------------------------------------------
# the API server
# ---------------------------------------------------------------------------

def test_api_uploads_downloads_and_path_guard(api, workdir):
    _, url = api
    payload = bytes(range(256)) * 9
    assert _call(f"{url}/api/upload?filename=up/a.bin", "POST", payload)[1] == {
        "filename": "up/a.bin", "size": len(payload)}
    assert _call(f"{url}/api/upload", "POST", b"xy",
                 headers={"X-Filename": "up/h.bin"})[0] == 200
    assert _call(f"{url}/api/upload", "POST", b"xy")[0] == 400
    b64 = base64.b64encode(b"hello ").decode()
    assert _call(f"{url}/api/upload_base64", "POST",
                 {"filename": "up/b.txt", "data": b64})[1]["success"]
    assert _call(f"{url}/api/upload_base64_get?filename=up/b.txt&append=1&data="
                 + base64.b64encode(b"world").decode().replace("=", "%3D"))[0] == 200
    assert (workdir / "up" / "b.txt").read_bytes() == b"hello world"
    for i in (2, 0, 1):  # chunks in any order
        chunk = payload[i * 1000:(i + 1) * 1000 if i < 2 else None]
        _call(f"{url}/api/upload_chunk?upload_id=u1&index={i}&total=3", "POST", chunk)
    assert _call(f"{url}/api/upload_complete", "POST",
                 {"upload_id": "u1", "filename": "up/c.bin"})[1]["size"] == len(payload)
    _call(f"{url}/api/upload_chunk?upload_id=u2&index=0&total=2", "POST", b"ab")
    assert _call(f"{url}/api/upload_complete", "POST",
                 {"upload_id": "u2", "filename": "up/d.bin"})[0] == 400

    assert _call(f"{url}/api/download/up/c.bin")[1] == payload
    assert base64.b64decode(_call(f"{url}/api/download_base64/up/a.bin")[1]["data"]) == payload
    part = _call(f"{url}/api/download_chunk/up/c.bin?offset=2000&size=500")[1]
    assert base64.b64decode(part["data"]) == payload[2000:2304]
    assert part["total"] == len(payload) and part["done"]
    assert _call(f"{url}/api/download/up/missing.bin")[0] == 404
    names = [f["name"] for f in _call(f"{url}/api/list_files?path=up")[1]["files"]]
    assert names == ["a.bin", "b.txt", "c.bin", "h.bin"]
    # every path a request names stays inside the workdir
    status, body = _call(f"{url}/api/download/..%2F..%2Fetc%2Fpasswd")
    assert status == 500 and "escapes workdir" in body["error"]
    status, body = _call(f"{url}/api/upload?filename=../escape.bin", "POST", b"x")
    assert status == 500 and "escapes workdir" in body["error"]
    assert not (workdir.parent / "escape.bin").exists()
    assert _call(f"{url}/api/list_files?path=../..")[0] == 400


def test_api_status_endpoints(api):
    _, url = api
    assert _call(f"{url}/api/health")[1] == {"status": "ok"}
    assert _call(f"{url}/health")[1]["server"] == "VerseCrafter API"
    status = _call(f"{url}/api/model_status")[1]
    assert status["model_loaded"] is False and status["model_server_url"]
    stats = _call(f"{url}/system_stats")[1]
    assert stats == tapi.system_stats() and stats["backend"] in ("cpu", "cuda")
    assert _call(f"{url}/api/unload_model", "POST")[1] == {"unloaded": False}
    assert isinstance(_call(f"{url}/api/tasks")[1]["tasks"], list)
    assert _call(f"{url}/api/status/nope")[0] == 404


def test_api_model_server_tier(api, model_server, workdir):
    """POST /api/generate with paths relative to the workdir; the task
    mirrors the model server's progress and ends with its result."""
    _, url = api
    server, _ = model_server
    task = _call(f"{url}/api/generate", "POST", {
        **REQUEST, "rendering_maps_path": "maps", "input_image_path": "input.png",
        "save_path": str(workdir / "via_model_server")})[1]["task_id"]
    st, seen = _wait(f"{url}/api/status/{task}")
    assert st["status"] == "COMPLETED", st
    assert seen == sorted(seen) and seen[-1] == 100
    assert st["result"]["video_path"].startswith(str(workdir / "via_model_server"))
    assert _call(f"{url}/api/generate", "POST", {**REQUEST, "rendering_maps_path": "/etc"})[0] == 200
    failed = _wait(f"{url}/api/status/{_call(f'{url}/api/tasks')[1]['tasks'][-1]['task_id']}")[0]
    assert failed["status"] == "FAILED" and "escapes workdir" in failed["error"]


def test_api_in_process_tier(pipes, model_server, workdir):
    """No model server: the API server's own pipeline serves the request,
    with the frames the model server gave for the same request."""
    server_m, _ = model_server
    server = tapi.ApiServer(workdir=str(workdir), pipeline_factory=lambda: pipes[1],
                            device="cpu", unload_after_generate=True)
    httpd, url = _serve(tapi.build_router(server))
    try:
        task = _call(f"{url}/api/generate_get?rendering_maps_path=maps&input_image_path="
                     f"input.png&prompt=a%20car%20drives%20left&negative_prompt=static"
                     f"&num_inference_steps=2&guidance_scale=2.0&shift=3.0&seed=7"
                     f"&height={H}&width={W}&num_frames={N}")[1]["task_id"]
        st, _ = _wait(f"{url}/api/status/{task}")
        assert st["status"] == "COMPLETED", st
        path = os.path.join(str(workdir), st["result"]["video_path"])
        assert path.startswith(str(workdir / "generated" / "generated_video_"))
        served = [p for p in sorted(os.listdir(workdir / "served")) if p.endswith(".mp4")]
        np.testing.assert_array_equal(
            jvideo.load_video(path), jvideo.load_video(str(workdir / "served" / served[0])))
        assert server.model_loading_status()["model_loaded"] is False  # unloaded
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_subprocess_tier_argv(workdir):
    server = tapi.ApiServer(workdir=str(workdir), device="cpu",
                            subprocess_model_args=["--offline_smoke"])
    argv = server._build_subprocess_argv({
        "rendering_maps_path": "/m", "prompt": "p", "height": 16, "width": 32,
        "num_frames": 5, "seed": 3, "guidance_scale": 4, "int8_attention": True})
    assert argv == [sys.executable, "-m", "versecrafter_tpu_torch.cli.inference",
                    "--rendering_maps_path", "/m", "--prompt", "p",
                    "--input_image_path", "", "--save_path",
                    str(workdir / "generated"), "--sample_size", "16,32",
                    "--video_length", "5", "--guidance_scale", "4.0", "--seed", "3",
                    "--teacache_threshold", "0", "--int8_attention", "--device", "cpu",
                    "--offline_smoke"]
    argv = server._build_subprocess_argv({"rendering_maps_path": "/m",
                                          "teacache_threshold": 0.2})
    assert argv[argv.index("--teacache_threshold") + 1] == "0.2"


def test_subprocess_tier_runs_the_cli(workdir):
    """The resident tier raises; the request runs in a fresh generate-CLI
    process on the CPU, its progress parsed from the CLI's output."""
    def broken():
        raise RuntimeError("resident pipeline unavailable")
    server = tapi.ApiServer(workdir=str(workdir), pipeline_factory=broken, device="cpu",
                            subprocess_fallback=True,
                            subprocess_model_args=["--offline_smoke", "--smoke_scale", "tiny"])
    t = server.tasks.create("generate")
    server.run_generate(t.task_id, {"rendering_maps_path": "maps", "prompt": "x",
                                    "height": 16, "width": 16, "num_frames": 5,
                                    "num_inference_steps": 2,
                                    "save_path": str(workdir / "subprocess")})
    st = server.tasks.get(t.task_id)
    assert st["status"] == "COMPLETED", st
    assert st["progress"] == 100
    video = jvideo.load_video(os.path.join(str(workdir), st["result"]["video_path"]))
    assert video.shape == (1, 3, 5, 16, 16)


def test_subprocess_tier_runs_the_staged_cli(workdir):
    """Tier 3 with subprocess_model_args "--staged --smoke_scale tiny": the
    request runs in a fresh generate-CLI process under staged residency."""
    def broken():
        raise RuntimeError("resident pipeline unavailable")
    server = tapi.ApiServer(workdir=str(workdir), pipeline_factory=broken, device="cpu",
                            subprocess_fallback=True,
                            subprocess_model_args=["--staged", "--smoke_scale", "tiny"])
    t = server.tasks.create("generate")
    server.run_generate(t.task_id, {"rendering_maps_path": "maps", "prompt": "x",
                                    "height": 16, "width": 16, "num_frames": 5,
                                    "num_inference_steps": 2,
                                    "save_path": str(workdir / "subprocess_staged")})
    st = server.tasks.get(t.task_id)
    assert st["status"] == "COMPLETED", st
    video = jvideo.load_video(os.path.join(str(workdir), st["result"]["video_path"]))
    assert video.shape == (1, 3, 5, 16, 16)


@pytest.fixture(scope="module")
def render_request(workdir):
    """A render request on a seeded 16x32 scene of N frames written into the
    workdir (paths relative to it, as the Blender add-on uploads them)."""
    scene = synthetic_scene(16, 32, N, seed=4)
    paths = write_scene_files(scene, str(workdir / "scene"))
    return {k: os.path.relpath(v, str(workdir)) for k, v in paths.items()}


def test_api_render_then_workflow(api, workdir, render_request, monkeypatch):
    """/api/render gives the JAX server's result keys and six N-frame mp4s;
    /api/workflow renders, mirrors progress 50, then generates from the
    rendered maps on the model-server tier; a path outside the workdir is
    refused."""
    server, url = api
    req = {**render_request, "output_dir": "rendered"}
    task = _call(f"{url}/api/render", "POST", req)[1]["task_id"]
    st, _ = _wait(f"{url}/api/status/{task}")
    assert st["status"] == "COMPLETED", st
    want = japi.ApiServer(workdir=str(workdir))
    jt = want.tasks.create("render")
    want.run_render(jt.task_id, {**req, "output_dir": "rendered_jax"})
    jres = want.tasks.get(jt.task_id)
    assert jres["status"] == "COMPLETED", jres
    res = st["result"]
    assert set(res) == set(jres["result"]) and res["output_dir"] == "rendered"
    assert sorted(res["videos"]) == sorted(jres["result"]["videos"])
    for name, rel in res["videos"].items():
        assert rel == os.path.join("rendered", f"{name}.mp4")
        assert jvideo.load_video(str(workdir / rel)).shape == (1, 3, N, 16, 32)

    updates = []  # every progress the workflow's task is given (polls can miss one)
    update = server.tasks.update

    def recording(task_id, **kw):
        updates.append((task_id, kw.get("progress")))
        return update(task_id, **kw)
    monkeypatch.setattr(server.tasks, "update", recording)
    task = _call(f"{url}/api/workflow", "POST", {
        **render_request, **REQUEST, "output_dir": "workflow_maps",
        "input_image_path": render_request["image"]})[1]["task_id"]
    st, _ = _wait(f"{url}/api/status/{task}")
    assert st["status"] == "COMPLETED", st
    progress = [p for t, p in updates if t == task and p is not None]
    assert progress[:3] == [5, 100, 50] and progress[-1] == 100  # render, then generate
    assert jvideo.load_video(str(workdir / st["result"]["video_path"])).shape == (1, 3, N, H, W)
    assert os.path.isfile(workdir / "workflow_maps" / "merged_mask.mp4")

    task = _call(f"{url}/api/render_get?image=/etc/passwd&depth_npz=x&trajectory_npz=y"
                 f"&ellipsoid_json=z")[1]["task_id"]
    st, _ = _wait(f"{url}/api/status/{task}")
    assert st["status"] == "FAILED" and "escapes workdir" in st["error"]


def test_cli_in_process(workdir, capsys):
    """The generate CLI prints one 'denoise i / n' line a step and the mp4's
    path last."""
    out = tinf.main(["--offline_smoke", "--smoke_scale", "tiny", "--device", "cpu",
                     "--rendering_maps_path", str(workdir / "maps"), "--prompt", "x",
                     "--input_image_path", str(workdir / "input.png"),
                     "--sample_size", "16,16", "--video_length", "5",
                     "--num_inference_steps", "3", "--cfg_parallel", "off",
                     "--save_path", str(workdir / "cli")])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line for line in lines if line.startswith("denoise ")] == [
        "denoise 1 / 3", "denoise 2 / 3", "denoise 3 / 3"]
    assert lines[-1] == out and os.path.isfile(out)


def test_cli_quantizes_as_it_loads(workdir, monkeypatch, tmp_path):
    """Without --lora_path the quantize flags reach the pipeline's build
    (each expert quantized as it is made) instead of quantize_weights
    afterwards."""
    from versecrafter_tpu_torch.sampling import pipeline as tpipe

    seen = []
    orig = tserve.default_pipeline_factory
    monkeypatch.setattr(tserve, "default_pipeline_factory", lambda *a, **k: (
        seen.append(k.get("quantize")), orig(*a, **k))[1])
    monkeypatch.setattr(tpipe.VerseCrafterPipeline, "quantize_weights",
                        lambda self, **kw: seen.append("quantize_weights"))
    out = tinf.main(["--offline_smoke", "--smoke_scale", "tiny", "--device", "cpu",
                     "--rendering_maps_path", str(workdir / "maps"), "--prompt", "x",
                     "--input_image_path", "", "--sample_size", "16,16",
                     "--video_length", "5", "--num_inference_steps", "2",
                     "--int8_compute", "--save_path", str(tmp_path / "cli")])
    assert os.path.isfile(out) and seen == [(8, True)]


def test_factory_without_a_mesh_leaves_the_pipeline_unsharded(monkeypatch):
    """In a world of several ranks the factory called without mesh_spec /
    auto_mesh builds the unsharded pipeline, which the generate CLI shards
    after its weight flags (`--tp 2 --quantize_int8` under torchrun used to
    fail in the factory: a world of 2 ranks needs a mesh); resolve_mesh
    itself still refuses such a world."""
    from versecrafter_tpu_torch.core import mesh as tmesh

    monkeypatch.setattr(tmesh, "world_size", lambda: 2)
    pipe = tserve.default_pipeline_factory(scale="tiny", device="cpu")()
    assert pipe.mesh is None
    with pytest.raises(ValueError, match="needs a mesh of 2 ranks"):
        tserve.resolve_mesh(None, device="cpu")


def test_cli_tp_with_quantize_flags(workdir, monkeypatch, tmp_path):
    """The generate CLI on a 2-rank gloo world with --tp 2 and
    --quantize_int8 --int8_compute (the tiny DiT's block kernels quantized:
    MIN_SIZE lowered in the ranks and here; the bf16 VAE on width slices)
    gives the one-process run's frames within two uint8 levels: the frames
    are bf16 decoder outputs in [-1, 1], where one bf16 ulp (2^-7) is about
    one level, and each run rounds its own decode once."""
    from tests.torch_mesh import run_world
    from versecrafter_tpu_torch.utils import quantize as tq

    small = 1 << 10
    flags = ["--offline_smoke", "--smoke_scale", "tiny", "--device", "cpu",
             "--rendering_maps_path", str(workdir / "maps"), "--prompt", "x",
             "--input_image_path", "", "--sample_size", "16,16", "--video_length", "5",
             "--num_inference_steps", "2", "--quantize_int8", "--int8_compute",
             "--save_path", str(tmp_path / "cli")]
    frames = []
    monkeypatch.setattr(tq, "MIN_SIZE", small)
    monkeypatch.setattr(tserve, "save_generated_video",
                        lambda video, params, default_dir=None: frames.append(video) or "x")
    tinf.main(flags)
    out = tmp_path / "world"
    out.mkdir()
    run_world(2, {"cli": flags + ["--tp", "2"], "min_size": small}, {}, out)
    got = np.load(out / "frames.npy")
    assert got.dtype == frames[0].dtype == np.uint8 and got.shape == frames[0].shape
    assert got.std() > 0
    diff = np.abs(got.astype(np.int16) - frames[0].astype(np.int16))
    assert diff.max() <= 2, (diff.max(), got.mean(), frames[0].mean())


@pytest.mark.parametrize("source", ["fresh", "transformer_high_path"])
def test_cli_moe(workdir, capsys, monkeypatch, tmp_path, source):
    """--moe: a shell pipeline whose experts the swap builds where the
    schedule crosses --moe_boundary, high first, each build printed as
    {"expert_build": which, "s": ...}: from seeds 1 and 0 without
    --model_name, else the low expert from the model directory and the high
    one from --transformer_high_path."""
    built = []
    if source == "fresh":
        orig = tserve.build_dit
        monkeypatch.setattr(tserve, "build_dit", lambda cfg, seed, *a, **k: (
            built.append(seed), orig(cfg, seed, *a, **k))[1])
        flags = ["--offline_smoke", "--smoke_scale", "tiny"]
    else:
        from test_torch_convert import (DIR_CFG, _as_torch, _t5_to_torch_layout,
                                        _vae_to_torch_layout, _write_dit)
        from versecrafter_tpu_torch.core import convert as tconvert
        model = tmp_path / "model"
        _write_dit(str(model), DIR_CFG, 5)
        _write_dit(str(tmp_path / "high"), DIR_CFG, 6)
        vae = _init(tvae.init_vae, VAE_CFG, 6, tconfig.VAEConfig)
        torch.save(_as_torch(_vae_to_torch_layout(vae, VAE_CFG), torch.float32),
                   str(model / "Wan2.1_VAE.pth"))
        t5 = _init(tt5.init_t5, T5_CFG, 7, tconfig.T5Config)
        torch.save(_as_torch(_t5_to_torch_layout(t5, T5_CFG), torch.bfloat16),
                   str(model / "models_t5_umt5-xxl-enc-bf16.pth"))
        monkeypatch.setattr(tconvert, "T5Config", lambda: _port(T5_CFG, tconfig.T5Config))
        monkeypatch.setattr(tconvert, "VAEConfig", lambda: _port(VAE_CFG, tconfig.VAEConfig))
        orig = tconvert.load_dit
        monkeypatch.setattr(tconvert, "load_dit", lambda d, *a, **k: (
            built.append(os.path.basename(d)), orig(d, *a, **k))[1])
        flags = ["--model_name", str(model), "--transformer_high_path",
                 str(tmp_path / "high"), "--geoada_in_dim", "20"]
    out = tinf.main([*flags, "--moe", "--moe_boundary", "0.9", "--device", "cpu",
                     "--rendering_maps_path", str(workdir / "maps"), "--prompt", "x",
                     "--input_image_path", str(workdir / "input.png"),
                     "--sample_size", "16,16", "--video_length", "5",
                     "--num_inference_steps", "3", "--cfg_parallel", "off",
                     "--teacache_threshold", "0", "--save_path", str(tmp_path / "cli")])
    lines = capsys.readouterr().out.strip().splitlines()
    builds = [json.loads(x)["expert_build"] for x in lines if x.startswith('{"expert_build"')]
    assert builds == ["high", "low"]
    assert built == ([1, 0] if source == "fresh" else ["high", "model"])
    assert lines[-1] == out and os.path.isfile(out)


class _Built(Exception):
    pass


def _refuse_build(*a, **k):
    raise _Built()


@pytest.mark.parametrize("flags,raised", [
    (["--ring_degree", "2"], "needs 2 ranks, the world has 1"),
    (["--ulysses_degree", "2"], "needs 2 ranks, the world has 1"), (["--auto_parallel"], None),
])
def test_cli_unported_flags_raise(flags, raised, monkeypatch):
    """The mesh flags are ported: on one process a degree > 1 is refused
    before anything is built (the world must be the mesh), and
    --auto_parallel resolves to the single-device path and goes on to build
    the pipeline. The gloo worlds are in test_torch_mesh.py and
    test_sharded_model_server_matches_one_rank."""
    monkeypatch.setattr(tserve, "default_pipeline_factory", _refuse_build)
    with pytest.raises(ValueError if raised else _Built, match=raised):
        tinf.main(["--rendering_maps_path", "m", "--prompt", "x", "--input_image_path", "",
                   "--device", "cpu", *flags])


@pytest.mark.parametrize("flags,raised", [
    (["--tp", "2"], "needs 2 ranks, the world has 1"), (["--auto_mesh"], None),
    (["--staged_scale", "tiny", "--quantize_bits", "8", "--tp", "2"],
     "needs 2 ranks, the world has 1")])
def test_model_server_unported_flags_raise(flags, raised, monkeypatch):
    """The JAX model server's flags parse; --staged_scale and
    --quantize_bits act only under --staged, as there (the last case gets
    past them to --tp). On one process a mesh degree > 1 is refused before
    the server starts; --auto_mesh resolves to one device and serves."""
    monkeypatch.setattr(tserve, "make_server", _refuse_build)
    with pytest.raises(ValueError if raised else _Built, match=raised):
        tserve.main(["--device", "cpu", *flags])


STAGED_CLI = ["--staged", "--offline_smoke", "--smoke_scale", "tiny", "--device", "cpu",
              "--prompt", "x", "--input_image_path", "", "--sample_size", "16,16",
              "--video_length", "5"]


@pytest.mark.parametrize("cfg_parallel,moe", [("auto", False), ("on", False), ("off", False),
                                              ("auto", True)])
def test_cli_staged(workdir, capsys, tmp_path, cfg_parallel, moe):
    """--staged on the CPU: the {"cfg_parallel", "tokens", "est_step_gb"}
    line first (auto: the memory model's choice), one 'denoise i / n' line a
    step, the stage split, the mp4's path last; with --moe the staged swap
    builds the high expert (seed 1) and then the low one where sigma crosses
    the boundary (2 steps at shift 16: sigma 1.0, then 0.94)."""
    from versecrafter_tpu_torch.sampling import staged as tstaged

    flags = STAGED_CLI + ["--rendering_maps_path", str(workdir / "maps"),
                          "--num_inference_steps", "2", "--cfg_parallel", cfg_parallel,
                          "--save_path", str(tmp_path)]
    out = tinf.main(flags + (["--moe", "--moe_boundary", "0.97"] if moe else []))
    lines = capsys.readouterr().out.strip().splitlines()
    factories, cfg, vae_cfg, _ = tstaged.fresh_init_factories("tiny", bits=0, device="cpu")
    want = {"auto": tstaged.auto_cfg_parallel(cfg, 0, 2), "on": True, "off": False}[cfg_parallel]
    assert json.loads(lines[0]) == {
        "cfg_parallel": want, "tokens": 2,
        "est_step_gb": round(tstaged.estimate_denoise_gb(cfg, 0, 2, 2 if want else 1), 2)}
    assert [line for line in lines if line.startswith("denoise ")] == [
        "denoise 1 / 2", "denoise 2 / 2"]
    builds = [json.loads(line)["expert_build"] for line in lines if "expert_build" in line]
    assert builds == (["high", "low"] if moe else [])
    profile = json.loads(lines[-3])["staged_profile_s"]
    assert ("dit_build" in profile) != moe and "denoise" in profile
    assert lines[-1] == out and os.path.isfile(out)


def test_cli_fit_teacache(workdir, capsys, tmp_path):
    """--staged --fit_teacache OUT_JSON: the recorded trajectory's fit (five
    coefficients and a threshold) written to OUT_JSON, the recorded run's
    video saved first, then the fired generation's."""
    fit = tmp_path / "fit.json"
    out = tinf.main(STAGED_CLI + ["--rendering_maps_path", str(workdir / "maps"),
                                  "--num_inference_steps", "4", "--cfg_parallel", "on",
                                  "--fit_teacache", str(fit), "--save_path", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    saved = json.loads(fit.read_text())
    assert len(saved["coefficients"]) == 5 and saved["threshold"] > 0
    assert any(json.loads(line).get("teacache_fit") == saved for line in lines
               if line.startswith('{"teacache_fit"'))
    first = next(json.loads(line)["record_video"] for line in lines if "record_video" in line)
    assert os.path.basename(first) == "generated_video_0.mp4" and os.path.isfile(first)
    assert os.path.basename(out) == "generated_video_1.mp4" and os.path.isfile(out)


def test_model_server_staged(workdir, monkeypatch, tmp_path):
    """The model server's --staged --staged_scale tiny --quantize_bits 8
    over HTTP: a shell pipeline whose weights each request builds and frees;
    a request's cfg_parallel pins the CFG mode, without it the memory model
    picks; /metrics carries the stage split; quantize params fail the
    task."""
    from versecrafter_tpu_torch.sampling import staged as tstaged

    routers, modes = [], []

    class Stub:
        def serve_forever(self):
            pass

    monkeypatch.setattr(tserve, "make_server", lambda router, *a: routers.append(router) or Stub())
    generate = tstaged.generate_staged
    monkeypatch.setattr(tstaged, "generate_staged", lambda pipe, *a, **k: (
        modes.append(pipe.cfg_parallel), generate(pipe, *a, **k))[1])
    tserve.main(["--device", "cpu", "--staged", "--staged_scale", "tiny", "--quantize_bits", "8"])
    httpd, url = _serve(routers[0])
    try:
        req = {"rendering_maps_path": str(workdir / "maps"), "prompt": "x", "height": 16,
               "width": 16, "num_frames": 5, "num_inference_steps": 2,
               "save_path": str(tmp_path)}
        for pin in (False, None):
            body = dict(req, **({} if pin is None else {"cfg_parallel": pin}))
            task = _call(f"{url}/generate", "POST", body)[1]["task_id"]
            st, _ = _wait(f"{url}/status/{task}")
            assert st["status"] == "COMPLETED", st
        cfg = tstaged.fresh_init_factories("tiny", device="cpu")[1]
        assert modes == [False, tstaged.auto_cfg_parallel(cfg, 8, 2)]
        profile = _call(f"{url}/metrics")[1]["last_generation_stage_profile_s"]
        assert {"t5_build", "dit_build", "denoise", "decode", "total"} <= set(profile)
        task = _call(f"{url}/generate", "POST", dict(req, quantize_bits=4))[1]["task_id"]
        st, _ = _wait(f"{url}/status/{task}")
        assert st["status"] == "FAILED" and "stage factories" in st["error"]
        assert len(modes) == 2
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.mark.parametrize("weights,mode", [("bf16", None), ("int8", (8, False)),
                                          ("w8a8", (8, True)), ("w4a8", (4, True))])
def test_model_server_resident_weights(weights, mode, monkeypatch):
    """--resident_weights reaches default_pipeline_factory as its quantize
    (bits, int8_compute), so a model directory loads quantized."""
    seen = {}

    class Stub:
        def serve_forever(self):
            seen["served"] = True

    monkeypatch.setattr(tserve, "default_pipeline_factory",
                        lambda path, **kw: seen.update(path=path, **kw) or (lambda: None))
    monkeypatch.setattr(tserve, "make_server", lambda *a: Stub())
    tserve.main(["--device", "cpu", "--model_path", "m", "--resident_weights", weights])
    assert seen == {"path": "m", "device": "cpu", "quantize": mode, "served": True}


def test_api_server_auto_mesh_raises(monkeypatch):
    """--auto_mesh is ported: on one process it resolves to the
    single-device pipeline (built lazily) and the server starts."""
    seen = {}
    real = tserve.default_pipeline_factory
    monkeypatch.setattr(tserve, "default_pipeline_factory",
                        lambda *a, **k: seen.update(k) or real(*a, **k))
    monkeypatch.setattr(tapi, "make_server", _refuse_build)
    with pytest.raises(_Built):
        tapi.main(["--device", "cpu", "--auto_mesh"])
    assert seen["auto_mesh"] is True
    assert tserve.resolve_mesh(None, auto=True) is None
    with pytest.raises(SystemExit):  # choices as in the JAX parser
        tserve.main(["--device", "cpu", "--quantize_bits", "2"])


def test_entry_points_default_to_cuda():
    """Without CUDA an entry point raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.default_pipeline_factory(scale="tiny")()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinf.main(["--rendering_maps_path", "m", "--prompt", "x", "--input_image_path", ""])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.main(["--port", "0"])


def test_model_server_queues_a_second_request():
    """Two requests posted back to back: the second waits in the queue
    (depth 1 while the first runs) and both complete, in order."""
    import threading

    release, started, order = threading.Event(), threading.Event(), []

    class Held(tserve.ModelServer):
        def _generate(self, pipe, params, progress):
            order.append(params["seed"])
            started.set()
            assert release.wait(30)
            return np.zeros((1, 1, 2, 2, 3), np.uint8)

        def _save(self, video, params):
            return f"seed {params['seed']}"

    server = Held(lambda: object())
    httpd, url = _serve(tserve.build_router(server))
    try:
        ids = [_call(f"{url}/generate", "POST", {"seed": s})[1]["task_id"] for s in (1, 2)]
        assert started.wait(30)
        assert _call(f"{url}/metrics")[1]["queue_depth"] == 1
        release.set()
        for task_id in ids:
            st, _ = _wait(f"{url}/status/{task_id}")
            assert st["status"] == "COMPLETED", st
        assert order == [1, 2] and _call(f"{url}/metrics")[1]["queue_depth"] == 0
    finally:
        release.set()
        httpd.shutdown()
        httpd.server_close()


def test_unload_frees_the_pipeline_after_a_request():
    """After a served request and /unload, nothing holds the pipeline: the
    idle worker keeps no reference to it (its device memory is freed)."""
    import gc
    import weakref

    class Pipe:
        last_wall_profile = {}

    built = []

    class Server(tserve.ModelServer):
        def _generate(self, pipe, params, progress):
            return np.zeros((1, 1, 2, 2, 3), np.uint8)

        def _save(self, video, params):
            return "kept nowhere"

    server = Server(lambda: built.append(Pipe()) or built[-1])
    httpd, url = _serve(tserve.build_router(server))
    try:
        task_id = _call(f"{url}/generate", "POST", {"seed": 1})[1]["task_id"]
        st, _ = _wait(f"{url}/status/{task_id}")
        assert st["status"] == "COMPLETED", st
        alive = weakref.ref(built.pop())
        assert _call(f"{url}/unload", "POST")[1] == {"unloaded": True}
        gc.collect()
        assert alive() is None
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_sharded_model_server_matches_one_rank(pipes, model_server, workdir, tmp_path):
    """A model server of two gloo ranks (sp=2, Ulysses at 2 heads; tests/
    torch_mesh.py) started like torchrun's: rank 0 answers /health,
    /generate, /status and /unload over HTTP and the other rank follows
    its tasks. The served frames equal the one-rank server's within one
    uint8 level (fp32 pipelines). The default group's limit is lowered to
    2 s and the server sits idle for 3 s between two requests: the other
    rank waits for the next task on the control group and serves it. An
    unload that fails on rank 1 only fails on rank 0 too (the ranks agree
    on each task), and the world serves on."""
    from tests.torch_mesh import flatten, free_port, start_world, stop_world

    jp, _ = pipes
    server, url1 = model_server
    params = _request(workdir)
    task = _call(f"{url1}/generate", "POST", params)[1]["task_id"]
    assert _wait(f"{url1}/status/{task}")[0]["status"] == "COMPLETED"
    ref = server.frames[-1]

    port = free_port()
    arrays = {}
    for name, tree in (("dit", jp.dit_params), ("vae", jp.vae_params), ("t5", jp.t5_params)):
        arrays.update(flatten(tree, name))
    job = {"spec": [1, 1, 2, 1], "timeout_s": 2, "serve": {
        "port": port, "dit_cfg": dataclasses.asdict(CFG), "fail_first_unload_on": 1,
        "vae_cfg": dataclasses.asdict(VAE_CFG), "t5_cfg": dataclasses.asdict(T5_CFG)}}
    out = tmp_path / "out"
    out.mkdir()
    procs = start_world(2, job, arrays, out)
    try:
        url = f"http://127.0.0.1:{port}"
        t0 = time.monotonic()
        while True:
            try:
                if _call(f"{url}/health")[1] == {"status": "ok", "model_loaded": False}:
                    break
            except OSError:
                pass
            assert all(p.poll() is None for p in procs), "a rank exited"
            assert time.monotonic() - t0 < 60, "the server did not start"
            time.sleep(0.2)
        served = []
        for _ in range(2):
            task = _call(f"{url}/generate", "POST", params)[1]["task_id"]
            st = _wait(f"{url}/status/{task}")[0]
            assert st["status"] == "COMPLETED", st
            served.append(np.load(st["result"]["video_path"]))
            if len(served) == 1:
                time.sleep(3)  # idle past the default group's limit
                assert all(p.poll() is None for p in procs), "a rank exited while idle"
        status, body = _call(f"{url}/unload", "POST")
        assert status == 500 and "task 'unload' failed on rank(s) [1]" in body["error"], body
        assert _call(f"{url}/health")[1]["model_loaded"] is False
        task = _call(f"{url}/generate", "POST", params)[1]["task_id"]
        assert _wait(f"{url}/status/{task}")[0]["status"] == "COMPLETED"
        assert _call(f"{url}/unload", "POST")[1] == {"unloaded": True}
    finally:
        stop_world(procs)
    np.testing.assert_array_equal(served[1], served[0])
    got = served[0]
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1, diff.max()


def test_tp_model_server_quantizes_per_request(pipes, workdir, tmp_path, monkeypatch):
    """A model server of two gloo ranks at tp = 2 serves a W8A8 request (its
    quantize params quantize the sharded DiT: each part gathered whole,
    quantized and cut again per tp rank) and then refuses another mode,
    as the one-rank server does; the frames equal the one-rank server's
    W8A8 request within one uint8 level. MIN_SIZE is lowered in both so the
    tiny DiT's block kernels quantize."""
    import copy

    from tests.torch_mesh import flatten, free_port, start_world, stop_world
    from versecrafter_tpu_torch.utils import quantize as tq

    jp, tp = pipes
    small = 1 << 10
    monkeypatch.setattr(tq, "MIN_SIZE", small)
    params = _request(workdir, quantize_int8=True, int8_compute=True)
    one = KeepingModelServer(lambda: copy.copy(tp), output_dir=str(tmp_path / "one"))
    httpd, url1 = _serve(tserve.build_router(one))
    try:
        task = _call(f"{url1}/generate", "POST", params)[1]["task_id"]
        assert _wait(f"{url1}/status/{task}")[0]["status"] == "COMPLETED"
    finally:
        httpd.shutdown()
        httpd.server_close()
    ref = one.frames[-1]
    assert tq.has_quantized(one._pipeline.dit_params)

    port = free_port()
    arrays = {}
    for name, tree in (("dit", jp.dit_params), ("vae", jp.vae_params), ("t5", jp.t5_params)):
        arrays.update(flatten(tree, name))
    job = {"spec": [1, 1, 1, 2], "serve": {
        "port": port, "dit_cfg": dataclasses.asdict(CFG), "min_size": small,
        "vae_cfg": dataclasses.asdict(VAE_CFG), "t5_cfg": dataclasses.asdict(T5_CFG)}}
    out = tmp_path / "out"
    out.mkdir()
    procs = start_world(2, job, arrays, out)
    try:
        url = f"http://127.0.0.1:{port}"
        t0 = time.monotonic()
        while True:
            try:
                if _call(f"{url}/health")[1]["status"] == "ok":
                    break
            except OSError:
                pass
            assert all(p.poll() is None for p in procs), "a rank exited"
            assert time.monotonic() - t0 < 60, "the server did not start"
            time.sleep(0.2)
        task = _call(f"{url}/generate", "POST", params)[1]["task_id"]
        st = _wait(f"{url}/status/{task}")[0]
        assert st["status"] == "COMPLETED", st
        got = np.load(st["result"]["video_path"])
        task = _call(f"{url}/generate", "POST", {**params, "quantize_bits": 4})[1]["task_id"]
        st = _wait(f"{url}/status/{task}")[0]
        assert st["status"] == "FAILED" and "already quantized" in st["error"], st
    finally:
        stop_world(procs)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1, diff.max()
