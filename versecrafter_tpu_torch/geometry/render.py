"""The 4D control-map renderer (the port's counterpart of
``versecrafter_tpu.geometry.render``): the background point cloud, the
camera trajectory and the per-frame 3D Gaussians -> the six control videos
the generate path reads by file name (background_RGB, background_depth,
3D_gaussian_RGB, 3D_gaussian_depth, merged_mask and the
background_and_3D_gaussian preview), each uint8 [T, H, W, 3].

Frames render in batches of `frame_batch` (the tail batch padded with its
last frame): splat, ray-cast, Gaussian projection, then the four streams
that need no depth range are finalised to uint8 on the device and copied
to the host. The depth streams stay on the device until the 0.1 % / 99 %
depth range of all frames is known, and are then grayscaled in one pass.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from versecrafter_tpu_torch import resolve_device
from versecrafter_tpu_torch.geometry.coords import blender_c2w_to_opencv_w2c
from versecrafter_tpu_torch.geometry.pointcloud import load_background_from_files
from versecrafter_tpu_torch.geometry.rasterize import (
    composite_by_depth, composite_take, depth_to_grayscale, merge_masks,
    positive_quantiles, raster_ellipsoids, splat_points)
from versecrafter_tpu_torch.geometry.splat import composite_gaussian_projections, object_color
from versecrafter_tpu_torch.utils.video import save_video

OUTPUT_NAMES = ("background_RGB", "background_depth", "3D_gaussian_RGB",
                "3D_gaussian_depth", "merged_mask", "background_and_3D_gaussian")
STAGES = ("splat", "ellipsoids", "projection", "finalise", "depth_range", "grayscale")


def load_camera_trajectory(trajectory_npz: str) -> np.ndarray:
    """Blender camera-to-world 'extrinsics' [T, 4, 4] -> OpenCV
    world-to-camera [T, 4, 4]."""
    data = np.load(trajectory_npz)
    return blender_c2w_to_opencv_w2c(data["extrinsics"].astype(np.float32))


def load_gaussian_trajectory(json_path: str):
    """custom_3D_gaussian_trajectory.json -> stacked per-frame parameters:
    (means [T, K, 3], covs [T, K, 3, 3], present [T, K], colors [K, 3],
    obj_ids [K]); an object missing from a frame is absent there."""
    with open(json_path) as f:
        data = json.load(f)
    color_idx = {str(k): v for k, v in
                 data["metadata"]["obj_id_to_color_idx"].items()}
    obj_ids = sorted(color_idx.keys(), key=lambda s: int(s) if s.isdigit() else s)
    slot = {oid: i for i, oid in enumerate(obj_ids)}
    T = data["metadata"]["num_frames"]
    K = max(len(obj_ids), 1)

    means = np.zeros((T, K, 3), np.float32)
    covs = np.tile(np.eye(3, dtype=np.float32) * 1e-6, (T, K, 1, 1))
    present = np.zeros((T, K), bool)
    for fr in data["frames"]:
        t = fr["frame_index"]
        if t >= T:
            continue
        for obj in fr["objects"]:
            oid = str(obj["object_id"])
            if oid not in slot or obj["gaussian_3d"]["mean"] is None:
                continue
            k = slot[oid]
            means[t, k] = obj["gaussian_3d"]["mean"]
            covs[t, k] = obj["gaussian_3d"]["covariance"]
            present[t, k] = True

    colors = np.stack([object_color(color_idx[oid]) for oid in obj_ids]) \
        if obj_ids else np.zeros((1, 3), np.float32)
    return means, covs, present, colors, obj_ids


class _StageClock:
    """Seconds per render stage: CUDA events on the card (no host sync
    between stages), the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks = []  # (stage, start, end)

    def _now(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def start(self):
        self._t = self._now()

    def lap(self, stage: str):
        t = self._now()
        self.marks.append((stage, self._t, t))
        self._t = t

    def seconds(self) -> Dict[str, float]:
        out = dict.fromkeys(STAGES, 0.0)
        if self.cuda:
            torch.cuda.synchronize()
        for stage, a, b in self.marks:
            out[stage] += a.elapsed_time(b) / 1e3 if self.cuda else b - a
        return out


def _u8(x):
    return torch.clamp(x, 0, 255).to(torch.uint8)


def _rgb3(x):
    """[n, H, W] -> [n, H, W, 3] (a single-channel stream as RGB)."""
    return x[..., None].expand(*x.shape, 3)


def render_control_maps(
    bg_points: np.ndarray,
    bg_colors: np.ndarray,
    K: np.ndarray,
    w2cs: np.ndarray,
    means: np.ndarray,
    covs: np.ndarray,
    present: np.ndarray,
    obj_colors: np.ndarray,
    image_size: Tuple[int, int],
    point_size: float = 0.005,
    ellipsoid_scale: float = 2.5,
    gaussian_threshold: float = 0.003,
    frame_batch: int = 27,
    device=None,
) -> Dict[str, np.ndarray]:
    """Render every control map on `device` (cuda unless the caller asks
    for the CPU). Returns uint8 [T, H, W, 3] arrays keyed by output name
    (without .mp4); the time split lands in `last_render_profile`."""
    dev = resolve_device(device)
    H, W = image_size
    T = len(w2cs)
    radius_px = point_size * min(H, W) / 2.0  # pytorch3d's NDC radius in pixels
    footprint = max(1, int(np.ceil(radius_px)))

    def to_dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)).to(dev, dtype)

    Kt, pts = to_dev(K), to_dev(bg_points)
    cols, ocols = to_dev(bg_colors), to_dev(obj_colors)

    t_wall = time.perf_counter()
    prof = {"device_s": 0.0, "download_s": 0.0, "frames": T}
    clock = _StageClock(dev)
    outs = {k: np.empty((T, H, W, 3), np.uint8) for k in OUTPUT_NAMES}
    bg_ds, fg_ds, range_parts = [], [], []

    def download(name, s, x):
        t0 = time.perf_counter()
        torch.from_numpy(outs[name][s:s + x.shape[0]]).copy_(x)
        prof["download_s"] += time.perf_counter() - t0

    for s in range(0, T, frame_batch):
        e = min(s + frame_batch, T)
        n = e - s

        def pb(a, dtype=torch.float32):
            a = np.asarray(a[s:e])
            if n < frame_batch:  # pad the tail batch with its last frame
                a = np.concatenate([a, np.repeat(a[-1:], frame_batch - n, axis=0)])
            return to_dev(a, dtype)

        t0 = time.perf_counter()
        clock.start()
        w_b = pb(w2cs)
        m_b, c_b, p_b = pb(means), pb(covs), pb(present, torch.bool)
        bg_rgb, bg_d, bg_m = splat_points(pts, cols, Kt, w_b, H, W, radius_px=radius_px,
                                          footprint=footprint)
        clock.lap("splat")
        fg_rgb, fg_d, fg_m = raster_ellipsoids(m_b, c_b, ocols, p_b, Kt, w_b, H, W,
                                               scale_factor=ellipsoid_scale)
        clock.lap("ellipsoids")
        g_rgb, g_a = composite_gaussian_projections(m_b, c_b, ocols, p_b, Kt, w_b, H, W,
                                                    threshold=gaussian_threshold)
        clock.lap("projection")
        bg_rgb, bg_d, bg_m = bg_rgb[:n], bg_d[:n], bg_m[:n]
        fg_rgb, fg_d, fg_m = fg_rgb[:n], fg_d[:n], fg_m[:n]
        g_rgb, g_a = g_rgb[:n], g_a[:n, ..., None]
        merged = merge_masks(bg_d, fg_d, bg_m, fg_m)
        # the preview: the Gaussians blended over the background, then
        # composited by depth against it
        blend = g_rgb * 255.0 * g_a + bg_rgb * (1 - g_a)
        prev_rgb, _ = composite_by_depth(bg_rgb, bg_d, blend, fg_d, g_a[..., 0] > 0.001)
        final = {"background_RGB": _u8(bg_rgb),
                 "3D_gaussian_RGB": _u8(g_rgb * g_a * 255.0),
                 "merged_mask": _rgb3(merged.to(torch.uint8) * 255),
                 "background_and_3D_gaussian": _u8(prev_rgb)}
        take = composite_take(bg_d, fg_d, fg_m)
        range_parts.append(torch.cat([bg_d.reshape(-1), fg_d.reshape(-1),
                                      torch.where(take, fg_d, bg_d).reshape(-1)]))
        bg_ds.append(bg_d)
        fg_ds.append(fg_d)
        clock.lap("finalise")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        prof["device_s"] += time.perf_counter() - t0
        for name, x in final.items():
            download(name, s, x)
        del bg_rgb, bg_m, fg_rgb, fg_m, g_rgb, g_a, merged, blend, prev_rgb, final, take

    t0 = time.perf_counter()
    clock.start()
    dmin, dmax = positive_quantiles(torch.cat(range_parts))
    del range_parts
    clock.lap("depth_range")
    gray = {"background_depth": _rgb3(_u8(depth_to_grayscale(torch.cat(bg_ds), dmin, dmax))),
            "3D_gaussian_depth": _rgb3(_u8(depth_to_grayscale(torch.cat(fg_ds), dmin, dmax)))}
    del bg_ds, fg_ds
    clock.lap("grayscale")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    prof["device_s"] += time.perf_counter() - t0
    for name, x in gray.items():
        download(name, 0, x)
    prof["wall_s"] = time.perf_counter() - t_wall
    prof["device_fps"] = T / max(prof["device_s"], 1e-9)
    prof["stages_s"] = clock.seconds()
    prof["depth_range"] = (dmin, dmax)
    last_render_profile.clear()
    last_render_profile.update(prof)
    return outs


# the time split of the last render_control_maps call ("control-map render
# fps"): device_s is host time until the device finished each batch's
# render and finalise and the depth range and grayscale (no copy in it),
# download_s the copies to the host after them, wall_s the whole call;
# stages_s the device seconds per stage (CUDA events on the card)
last_render_profile: Dict[str, object] = {}


def render_from_files(
    png_path: str,
    npz_path: str,
    mask_dir: Optional[str],
    trajectory_npz: str,
    ellipsoid_json: str,
    output_dir: str,
    point_size: float = 0.005,
    fps: int = 10,
    frame_batch: int = 27,
    progress=None,
    device=None,
) -> Dict[str, str]:
    """The reference renderer's file contract: inputs as its CLI names them
    -> <output_dir>/<name>.mp4 for the six streams (paths returned).
    `progress` is accepted for the JAX package's signature and not called,
    as there."""
    bg_points, bg_colors, K, H, W = load_background_from_files(png_path, npz_path, mask_dir)
    w2cs = load_camera_trajectory(trajectory_npz)
    means, covs, present, obj_colors, _ = load_gaussian_trajectory(ellipsoid_json)
    T = min(len(w2cs), len(means))

    videos = render_control_maps(
        bg_points, bg_colors, K, w2cs[:T], means[:T], covs[:T], present[:T],
        obj_colors, (H, W), point_size=point_size, frame_batch=frame_batch, device=device)

    if last_render_profile:
        print(json.dumps({"render_profile": last_render_profile}), flush=True)

    return write_control_maps(videos, output_dir, fps)


def write_control_maps(videos: dict, output_dir: str, fps: int = 16) -> dict:
    """The rendered uint8 streams as <output_dir>/<name>.mp4, written the
    reference's way (as floats in [0, 1] through save_video), one stream a
    thread (each encoder runs on one); the paths."""
    from concurrent.futures import ThreadPoolExecutor

    os.makedirs(output_dir, exist_ok=True)
    paths = {name: os.path.join(output_dir, f"{name}.mp4") for name in videos}
    with ThreadPoolExecutor(max_workers=max(1, len(videos))) as pool:
        futures = [pool.submit(save_video, vid.astype(np.float32) / 255.0, paths[name], fps=fps)
                   for name, vid in videos.items()]
        for f in futures:
            f.result()
    return paths
