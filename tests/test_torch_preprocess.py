"""The preprocess task of the port's API server and the one-process pipeline
CLI (CPU): POST /api/preprocess and /api/preprocess_sync over HTTP on
127.0.0.1 with a tiny MoGe; run_preprocess's result files against the JAX
server's on the same image and weights (depth within an fp16 step, the
saliency masks with cv2's generator seeded before the JAX server's run and
the port's (utils/cvops) before its own, the fitted
Gaussians); the missing-field 400; then cli/pipeline.py running depth ->
segment -> gaussian -> render -> generate on files the test writes."""

import json
import os
import shutil
import time
import urllib.error
import urllib.request

import cv2
import jax
import numpy as np
import pytest

from test_torch_moge import TINY_VIT, np_tree, randomized_head
from test_torch_render import write_scene_files
from versecrafter_tpu.perception import moge as jm
from versecrafter_tpu.serve import api_server as japi
from versecrafter_tpu_torch.core.convert import params_from_jax
from versecrafter_tpu_torch.geometry.synthetic import synthetic_scene
from versecrafter_tpu_torch.perception import moge as tm
from versecrafter_tpu_torch.serve import api_server as tapi
from versecrafter_tpu_torch.serve.http import make_server, serve_forever_in_thread
from versecrafter_tpu_torch.utils import cvops


def _call(url, method="GET", body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait(url, timeout=120):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        st = _call(url)[1]
        if st["status"] in ("COMPLETED", "FAILED"):
            return st
        time.sleep(0.05)
    raise AssertionError(f"{url} did not finish in {timeout} s")


@pytest.fixture(scope="module")
def jparams():
    return randomized_head(jm.init_moge(jax.random.key(0), vit_kwargs=TINY_VIT), 1)


def _image():
    img = np.full((64, 96, 3), 30, np.uint8)
    img[20:44, 30:60] = [220, 60, 60]
    img[5:15, 70:90] = [40, 200, 60]
    return img


@pytest.fixture(scope="module")
def api(tmp_path_factory, jparams):
    wd = tmp_path_factory.mktemp("pre")
    cv2.imwrite(str(wd / "input.png"), cv2.cvtColor(_image(), cv2.COLOR_RGB2BGR))
    server = tapi.ApiServer(workdir=str(wd), device="cpu")
    server._moge_cache = params_from_jax(np_tree(jparams))
    httpd = make_server(tapi.build_router(server), "127.0.0.1", 0)
    serve_forever_in_thread(httpd)
    yield server, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def test_preprocess_over_http(api):
    server, url = api
    task = _call(f"{url}/api/preprocess", "POST",
                 {"image": "input.png", "text_prompt": "box.", "max_objects": 3})[1]["task_id"]
    st = _wait(f"{url}/api/status/{task}")
    assert st["status"] == "COMPLETED", st
    res = st["result"]
    assert set(res) == {"depth_npz", "gaussian_params", "mask_dir", "num_objects"}
    for key in ("depth_npz", "gaussian_params", "mask_dir"):
        assert os.path.exists(os.path.join(server.workdir, res[key])), key
    assert json.load(open(os.path.join(server.workdir, res["gaussian_params"])))[
        "num_objects"] <= res["num_objects"] <= 3
    task = _call(f"{url}/api/preprocess_get?image=input.png&text_prompt=box.")[1]["task_id"]
    assert _wait(f"{url}/api/status/{task}")["status"] == "COMPLETED"
    status, body = _call(f"{url}/api/preprocess_sync", "POST",
                         {"image": "input.png", "text_prompt": "box."})
    assert status == 200 and body["status"] == "completed"
    assert body["result"]["depth_npz"] == res["depth_npz"]
    assert _call(f"{url}/api/preprocess_sync", "POST", {})[0] == 400
    status, body = _call(f"{url}/api/preprocess_sync", "POST", {"image": "../outside.png"})
    assert status == 500 and "escapes workdir" in body["error"]


def test_result_files_match_the_jax_server(tmp_path, jparams):
    """run_preprocess of both servers on the same image and MoGe weights."""
    results = {}
    for name, mod in (("jax", japi), ("port", tapi)):
        wd = tmp_path / name
        wd.mkdir()
        cv2.imwrite(str(wd / "input.png"), cv2.cvtColor(_image(), cv2.COLOR_RGB2BGR))
        server = mod.ApiServer(workdir=str(wd), **({"device": "cpu"} if mod is tapi else {}))
        server._moge_cache = jparams if mod is japi else params_from_jax(np_tree(jparams))
        t = server.tasks.create("preprocess")
        (cv2.setRNGSeed if mod is japi else cvops.set_rng_seed)(11)
        server.run_preprocess(t.task_id, {"image": "input.png", "text_prompt": "box. car.",
                                          "min_area_ratio": 0.01})
        st = server.tasks.get(t.task_id)
        assert st["status"] == "COMPLETED", st
        results[name] = (wd, st["result"])
    (jw, jr), (tw, tr) = results["jax"], results["port"]
    assert tr == jr and tr["num_objects"] > 0
    jd, td = np.load(jw / jr["depth_npz"]), np.load(tw / tr["depth_npz"])
    np.testing.assert_array_equal(td["intrinsic"], jd["intrinsic"])
    np.testing.assert_allclose(td["depth"].astype(np.float32), jd["depth"].astype(np.float32),
                               rtol=2e-3)
    masks = sorted(os.listdir(jw / jr["mask_dir"] / "masks"))
    assert masks == sorted(os.listdir(tw / tr["mask_dir"] / "masks"))
    for m in masks:
        a = cv2.imread(str(jw / jr["mask_dir"] / "masks" / m), cv2.IMREAD_GRAYSCALE)
        b = cv2.imread(str(tw / tr["mask_dir"] / "masks" / m), cv2.IMREAD_GRAYSCALE)
        assert (a == b).mean() > 0.999, m
    jg = json.load(open(jw / jr["gaussian_params"]))
    tg = json.load(open(tw / tr["gaussian_params"]))
    assert sorted(tg["gaussian_params"]) == sorted(jg["gaussian_params"])
    for k, v in jg["gaussian_params"].items():
        np.testing.assert_allclose(tg["gaussian_params"][k]["mean"], v["mean"], rtol=5e-3,
                                   atol=1e-4)


def test_moge_checkpoint_by_version(tmp_path, jparams, monkeypatch):
    """moge_checkpoints[version] (inside the workdir) is read when the
    request names no checkpoint; the JAX-written npz loads."""
    monkeypatch.setattr(tm, "VIT_L", dict(tm.VIT_L, **TINY_VIT))
    monkeypatch.setattr(tm, "HEAD_L", tm.HEAD_TINY)
    jm.save_checkpoint(jparams, str(tmp_path / "v1.npz"))
    server = tapi.ApiServer(workdir=str(tmp_path), device="cpu")
    server.moge_checkpoints = {"v1": "v1.npz"}
    got = server._moge_params(None, "v1")
    np.testing.assert_array_equal(got["head"]["projects"][0]["weight"].numpy(),
                                  np.asarray(jparams["head"]["projects"][0]["weight"]))


def test_pipeline_cli_runs_every_stage(tmp_path, monkeypatch, capsys):
    """cli/pipeline.py on a clip directory in the demo layout (the seeded
    scene's files): depth (tiny MoGe) -> segment (saliency) -> gaussian ->
    render -> generate (tiny random pipeline), --device cpu."""
    monkeypatch.setattr(tm, "VIT_L", dict(tm.VIT_L, **TINY_VIT))
    monkeypatch.setattr(tm, "HEAD_L", tm.HEAD_TINY)
    from versecrafter_tpu_torch.cli import pipeline

    h, w, n = 16, 32, 5
    files = write_scene_files(synthetic_scene(h, w, n, seed=4), str(tmp_path / "scene"))
    data = tmp_path / "clip"
    for sub in ("estimated_depth", "object_mask", "camera_object_0"):
        (data / sub).mkdir(parents=True)
    shutil.copy(files["image"], data / "0001.png")
    shutil.copy(files["depth_npz"], data / "estimated_depth" / "depth_intrinsics.npz")
    shutil.copytree(files["mask_dir"], data / "object_mask" / "masks")
    shutil.copy(files["trajectory_npz"], data / "camera_object_0")
    shutil.copy(files["ellipsoid_json"], data / "camera_object_0")
    out = tmp_path / "out"
    times = pipeline.main(["--data", str(data), "--out", str(out), "--smoke_scale", "tiny",
                           "--sample_size", f"{h},{w}", "--video_length", str(n),
                           "--num_inference_steps", "2", "--text_prompt", "box.",
                           "--device", "cpu"])
    assert list(times) == ["depth", "segment", "gaussian", "render", "generate"]
    for rel in ("estimated_depth/depth_intrinsics.npz", "object_mask/mask_combined.png",
                "fitted_3D_gaussian/gaussian_params.json",
                "rendering_4D_maps/merged_mask.mp4"):
        assert os.path.exists(out / rel), rel
    assert [f for f in os.listdir(out / "generated") if f.endswith(".mp4")]
    assert '"stage_wall_s"' in capsys.readouterr().out


def test_pipeline_cli_skips_and_staged(tmp_path, capsys):
    """--skip skips each stage; --staged generates from the maps directory
    with staged residency and a W4A8 DiT (the generate CLI's --staged
    --quantize_int8 --int8_compute --quantize_bits 4)."""
    from test_torch_video_io import _maps
    from versecrafter_tpu_torch.cli import pipeline
    from versecrafter_tpu_torch.serve.model_server import CONTROL_NAMES

    assert pipeline.main(["--data", str(tmp_path), "--out", str(tmp_path / "o"), "--skip",
                          "depth,segment,gaussian,render,generate", "--device", "cpu"]) == {}
    assert capsys.readouterr().out.count("skipped") == 5
    _maps(str(tmp_path / "o" / "rendering_4D_maps"), CONTROL_NAMES + ["merged_mask.mp4"])
    cv2.imwrite(str(tmp_path / "0001.png"), np.full((24, 40, 3), 90, np.uint8))
    times = pipeline.main(["--data", str(tmp_path), "--out", str(tmp_path / "o"), "--skip",
                           "depth,segment,gaussian,render", "--staged", "--smoke_scale", "tiny",
                           "--sample_size", "16,16", "--video_length", "5",
                           "--num_inference_steps", "2", "--device", "cpu"])
    assert list(times) == ["generate"]
    out = capsys.readouterr().out
    assert '"staged_profile_s"' in out and '"cfg_parallel"' in out
    assert [f for f in os.listdir(tmp_path / "o" / "generated") if f.endswith(".mp4")]
