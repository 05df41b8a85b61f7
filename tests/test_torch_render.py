"""Port parity for the whole renderer and its CLIs on the CPU:
render_control_maps against the jitted JAX one on a seeded scene
(48x64, 6 frames, 4 objects: one absent in frames 2-3, one behind the
camera from frame 2, one leaving the image; frame_batch 4 so the tail batch
is padded), the fit CLI's gaussian_params.json against the JAX package's,
and the render CLI on files written here.

Bars on the six uint8 streams: merged_mask agrees on >= 99.9 % of pixels;
every other stream is within one code on all but 0.1 % of its values
(uint8 truncation flips a code where the two packages' fp32 values lie
within an ulp of an integer, and a splat whose projection sits on a pixel
edge can move one pixel).
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from versecrafter_tpu.geometry import gaussians as jgauss
from versecrafter_tpu.geometry import render as jrender
from versecrafter_tpu_torch.cli import fit_gaussian as tfit_cli
from versecrafter_tpu_torch.cli import render_maps as trender_cli
from versecrafter_tpu_torch.geometry import pointcloud as tpc
from versecrafter_tpu_torch.geometry import render as trender
from versecrafter_tpu_torch.geometry.coords import blender_c2w_to_opencv_w2c
from versecrafter_tpu_torch.geometry.splat import TAB20
from versecrafter_tpu_torch.geometry.synthetic import synthetic_scene, trajectory_json

H, W, T = 48, 64, 6


def write_scene_files(scene: dict, d: str) -> dict:
    """The scene as the reference's files: image png, MoGe-style depth npz
    (normalised intrinsics), mask_{id}_{label}.png per object, the Blender
    camera trajectory npz and the Gaussian trajectory json. Returns the
    paths by the render request's / CLI's names."""
    os.makedirs(os.path.join(d, "masks"), exist_ok=True)
    h, w = scene["depth"].shape
    png = os.path.join(d, "image.png")
    cv2.imwrite(png, cv2.cvtColor(scene["image"], cv2.COLOR_RGB2BGR))
    K = scene["K"].copy()
    K[0] /= w
    K[1] /= h
    npz = os.path.join(d, "depth_intrinsics.npz")
    np.savez(npz, depth=scene["depth"][None], intrinsic=K)
    for i, m in enumerate(scene["masks"]):
        cv2.imwrite(os.path.join(d, "masks", f"mask_{i + 1}_box_{i}.png"),
                    m.astype(np.uint8) * 255)
    traj = os.path.join(d, "custom_camera_trajectory.npz")
    np.savez(traj, extrinsics=scene["c2w_blender"])
    ell = os.path.join(d, "custom_3D_gaussian_trajectory.json")
    with open(ell, "w") as f:
        json.dump(trajectory_json(scene), f)
    return {"image": png, "depth_npz": npz, "mask_dir": os.path.join(d, "masks"),
            "trajectory_npz": traj, "ellipsoid_json": ell}


@pytest.fixture(scope="module")
def scene():
    s = synthetic_scene(H, W, T, seed=0)
    pts, cols = tpc.build_background(s["image"], s["depth"], s["K"],
                                     s["masks"].any(0).astype(np.uint8))
    args = (pts, cols, s["K"], blender_c2w_to_opencv_w2c(s["c2w_blender"]), s["means"],
            s["covs"], s["present"], TAB20[s["color_idx"]], (H, W))
    return s, args


def _stream_gaps(got, want):
    """(share of values more than one code apart, share of pixels whose
    value differs) between two uint8 streams."""
    d = np.abs(got.astype(int) - want.astype(int))
    return (d > 1).mean(), (d > 0).any(-1).mean()


def test_render_control_maps_matches_jax(scene):
    s, args = scene
    want = jrender.render_control_maps(*args, frame_batch=4)
    got = trender.render_control_maps(*args, frame_batch=4, device="cpu")
    assert list(got) == list(want) == list(trender.OUTPUT_NAMES)
    for name in got:
        assert got[name].shape == want[name].shape == (T, H, W, 3), name
        assert got[name].dtype == np.uint8
        beyond_one, differ = _stream_gaps(got[name], want[name])
        print(f"{name}: {differ:.2e} of pixels differ, {beyond_one:.2e} of values by > 1")
        if name == "merged_mask":
            assert 1 - differ >= 0.999
        else:
            assert beyond_one <= 1e-3, name
    # each frame where an object is present, in front and on screen shows it
    gauss = got["3D_gaussian_RGB"].any(-1).any((1, 2))
    assert gauss[[0, 1, 4, 5]].all()
    prof = trender.last_render_profile
    assert prof["frames"] == T and set(prof["stages_s"]) == set(trender.STAGES)
    assert prof["depth_range"][0] > 0


def test_render_tail_batch_padding(scene):
    """Any frame_batch gives the same streams bit for bit."""
    _, args = scene
    a = trender.render_control_maps(*args, frame_batch=4, device="cpu")
    for fb in (1, 6, 27):
        b = trender.render_control_maps(*args, frame_batch=fb, device="cpu")
        assert all(np.array_equal(a[k], b[k]) for k in a), fb


def test_render_runs_on_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trender.render_control_maps(np.zeros((1, 3), np.float32), np.zeros((1, 3)),
                                    np.eye(3, dtype=np.float32), np.eye(4)[None],
                                    np.zeros((1, 1, 3)), np.eye(3)[None, None],
                                    np.ones((1, 1), bool), TAB20[:1], (8, 8))


def test_fit_gaussian_cli_matches_jax(tmp_path, capsys):
    s = synthetic_scene(H, W, T, seed=1)
    paths = write_scene_files(s, str(tmp_path))
    out = tfit_cli.main(["--npz_path", paths["depth_npz"], "--masks_dir", paths["mask_dir"],
                         "--output_dir", str(tmp_path / "port")])
    assert capsys.readouterr().out.startswith("fitted 4 objects")
    want = jgauss.process_single_image(paths["depth_npz"], paths["mask_dir"],
                                       str(tmp_path / "jax"))
    with open(tmp_path / "port" / "gaussian_params.json") as f:
        got = json.load(f)
    with open(tmp_path / "jax" / "gaussian_params.json") as f:
        assert got == json.load(f)
    assert out["num_objects"] == want["num_objects"] == 4
    for oid, p in want["gaussian_params"].items():
        assert out["gaussian_params"][oid]["num_points"] == p["num_points"] > 0
        np.testing.assert_array_equal(out["gaussian_params"][oid]["cov"], p["cov"])


def test_render_maps_cli_on_files(tmp_path, capsys):
    """--device cpu on the reference's input files: six mp4s of T frames
    at the image's size, named as the JAX renderer names them."""
    s = synthetic_scene(H, W, T, seed=2)
    paths = write_scene_files(s, str(tmp_path))
    out_dir = str(tmp_path / "maps")
    got = trender_cli.main(["--png_path", paths["image"], "--npz_path", paths["depth_npz"],
                            "--mask_dir", paths["mask_dir"],
                            "--trajectory_npz", paths["trajectory_npz"],
                            "--ellipsoid_json", paths["ellipsoid_json"],
                            "--output_dir", out_dir, "--device", "cpu", "--fps", "16",
                            "--render_batch_size", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0])["render_profile"]["frames"] == T
    assert lines[1:] == [f"saved {k}: {v}" for k, v in got.items()]
    assert sorted(got) == sorted(trender.OUTPUT_NAMES)
    for name, p in got.items():
        assert p == os.path.join(out_dir, f"{name}.mp4")
        cap = cv2.VideoCapture(p)
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        ok, frame = cap.read()
        cap.release()
        assert ok and n == T and frame.shape == (H, W, 3), name
    assert trender_cli.parse_args(["--npz_path", "x", "--trajectory_npz", "y",
                                   "--ellipsoid_json", "z"]).device == "cuda"
