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


@pytest.mark.parametrize("kind,items", [("preprocess", "item 10")])
def test_unported_stages_fail_naming_their_items(api, kind, items):
    _, url = api
    task = _call(f"{url}/api/{kind}", "POST", {"image": "input.png"})[1]["task_id"]
    st, _ = _wait(f"{url}/api/status/{task}")
    assert st["status"] == "FAILED"
    assert st["error"].startswith("NotImplementedError") and items in st["error"]
    status, body = _call(f"{url}/api/preprocess_sync", "POST", {"image": "input.png"})
    assert status == 500 and items in body["error"]


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


@pytest.mark.parametrize("flags,item", [
    (["--staged"], "item 6"), (["--fit_teacache"], "item 6"), (["--moe"], "item 8"),
    (["--transformer_high_path", "x"], "item 8"), (["--ring_degree", "2"], "item 11"),
    (["--ulysses_degree", "2"], "item 11"), (["--auto_parallel"], "item 11"),
])
def test_cli_unported_flags_raise(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        tinf.main(["--rendering_maps_path", "m", "--prompt", "x", "--input_image_path", "",
                   "--device", "cpu", *flags])


@pytest.mark.parametrize("flags,item", [(["--tp", "2"], "item 11"),
                                        (["--auto_mesh"], "item 11"),
                                        (["--staged"], "item 6"),
                                        (["--staged", "--staged_scale", "1.3b"], "item 6"),
                                        (["--staged", "--quantize_bits", "8"], "item 6"),
                                        (["--staged_scale", "tiny", "--quantize_bits", "8",
                                          "--tp", "2"], "item 11")])
def test_model_server_unported_flags_raise(flags, item):
    """The JAX model server's flags parse; --staged_scale and
    --quantize_bits act only under --staged, as there (the last case gets
    past them to --tp)."""
    with pytest.raises(NotImplementedError, match=item):
        tserve.main(["--device", "cpu", *flags])
    with pytest.raises(NotImplementedError, match="item 6"):
        tserve.ModelServer(lambda: None, staged_factories=object())


def test_api_server_auto_mesh_raises():
    with pytest.raises(NotImplementedError, match="item 11"):
        tapi.main(["--device", "cpu", "--auto_mesh"])
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
