"""MoGe-style monocular geometry (depth + intrinsics), the port's counterpart
of ``versecrafter_tpu.perception.moge``.

`infer(params, image)` follows the reference's `model.infer` contract:
image [H, W, 3] in 0..1 -> {points, depth, mask, intrinsics (normalized)}.
The network is a ViT (the generic one of vit.py, or DINOv2 of dinov2.py for
converted weights) whose four taps feed the MoGe head (moge_head.py); the
head's patch-res x 8 output is resized to the image as jax.image.resize
"bilinear" does, z goes through exp, and channel 3 is the mask logit. The
focal and z-shift are recovered on the host from the point map by
`recover_focal_shift` (float64 numpy, the JAX package's code line for
line). Checkpoints are npz files of flattened JAX parameter paths
(`vit/blocks/qkv/kernel` stacked over the blocks, `head/projects/0/weight`,
...), so a file written by either package loads in the other. The PNG
views are written by utils/video.write_png and coloured by
utils/imgproc.colormap_turbo.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from versecrafter_tpu_torch.perception._ops import full_fp32, resize_bilinear
from versecrafter_tpu_torch.perception.vit import init_vit, vit_forward

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# intrinsics / shift recovery from an affine point map (host numpy)
# ---------------------------------------------------------------------------

def recover_focal_shift(points: np.ndarray, mask: Optional[np.ndarray] = None,
                        num_shift: int = 64) -> Tuple[float, float]:
    """(normalized focal, z-shift) of a point map [H, W, 3] that equals the
    camera-space points up to a global z-shift: for each candidate shift the
    least-squares focal in closed form, f = sum(p.q) / sum(p.p), over a
    deterministic even subsample of at most 4,096 valid points; the pair of
    least residual, then one refinement pass around the best shift."""
    h, w = points.shape[:2]
    if mask is None:
        mask = np.isfinite(points).all(-1) & (points[..., 2] > 0)
    yy, xx = np.mgrid[0:h, 0:w]
    scale = max(h, w)
    un = (xx + 0.5 - w / 2) / scale
    vn = (yy + 0.5 - h / 2) / scale

    m = mask.reshape(-1)
    x = points[..., 0].reshape(-1)[m]
    y = points[..., 1].reshape(-1)[m]
    z = points[..., 2].reshape(-1)[m]
    q = np.stack([un.reshape(-1)[m], vn.reshape(-1)[m]], -1)

    max_pts = 4096
    if x.size > max_pts:
        sel = np.linspace(0, x.size - 1, max_pts).astype(np.int64)
        x, y, z, q = x[sel], y[sel], z[sel], q[sel]

    zmin = float(z.min())
    shifts = np.linspace(-zmin + 1e-3, max(1.0, float(z.max())), num_shift)

    best = (1.0, 0.0, np.inf)
    for s in shifts:
        zz = z + s
        p = np.stack([x / zz, y / zz], -1)
        denom = float((p * p).sum())
        if denom < 1e-12:
            continue
        f = float((p * q).sum() / denom)
        if f <= 0:
            continue
        res = float(((f * p - q) ** 2).sum())
        if res < best[2]:
            best = (f, float(s), res)
    lo = best[1] - (shifts[1] - shifts[0])
    hi = best[1] + (shifts[1] - shifts[0])
    for s in np.linspace(lo, hi, num_shift):
        zz = z + s
        if np.any(zz <= 1e-6):
            continue
        p = np.stack([x / zz, y / zz], -1)
        denom = float((p * p).sum())
        if denom < 1e-12:
            continue
        f = float((p * q).sum() / denom)
        if f <= 0:
            continue
        res = float(((f * p - q) ** 2).sum())
        if res < best[2]:
            best = (f, float(s), res)
    return best[0], best[1]


def normalized_intrinsics(focal: float, h: int, w: int) -> np.ndarray:
    """MoGe normalized intrinsics of a focal in units of max(H, W) pixels
    (denormalized by K[0, 0] * W, K[1, 1] * H)."""
    scale = max(h, w)
    fx_pix = focal * scale
    fy_pix = focal * scale
    return np.array([[fx_pix / w, 0, 0.5], [0, fy_pix / h, 0.5], [0, 0, 1]], np.float32)


# ---------------------------------------------------------------------------
# network
# ---------------------------------------------------------------------------

VIT_L = dict(patch=14, dim=1024, depth=24, heads=16)
HEAD_TAPS = (5, 11, 17, 23)
HEAD_L = dict(dim_proj=512, dim_upsample=(256, 128, 64), num_res_blocks=2,
              last_res_blocks=0, last_conv_channels=32, last_conv_size=1)
HEAD_TINY = dict(dim_proj=16, dim_upsample=(16, 8, 8), num_res_blocks=1,
                 last_res_blocks=0, last_conv_channels=8, last_conv_size=1)


def _taps(depth: int) -> tuple:
    return tuple(max(0, min(depth - 1, int(round((i + 1) * depth / 4)) - 1))
                 for i in range(4))


def init_moge(generator: torch.Generator, dtype=torch.float32,
              vit_kwargs: Optional[dict] = None, backbone: str = "vit",
              head_kwargs: Optional[dict] = None) -> Params:
    """Random init from `generator` on its device. backbone: 'vit' (the
    generic ViT) or 'dinov2' (the converted-weights backbone); the head is
    HEAD_L at the ViT-L width, HEAD_TINY otherwise, as in the JAX init."""
    from versecrafter_tpu_torch.perception.moge_head import init_head

    vk = dict(VIT_L)
    vk.update(vit_kwargs or {})
    hk = dict(HEAD_L if vk == VIT_L else HEAD_TINY)
    hk.update(head_kwargs or {})
    if backbone == "dinov2":
        from versecrafter_tpu_torch.perception.dinov2 import init_dinov2
        bb = init_dinov2(generator, dict(hidden=vk["dim"], depth=vk["depth"],
                                         heads=vk["heads"], patch=vk["patch"], mlp_ratio=4),
                         dtype=dtype)
    else:
        bb = init_vit(generator, dtype=dtype, **vk)
    taps = _taps(vk["depth"])
    return {
        "vit": bb,
        "head": init_head(generator, dim_in=vk["dim"], num_features=len(taps), dim_out=4,
                          dtype=dtype, **hk),
        "_static": {"patch": vk["patch"], "heads": vk["heads"], "backbone": backbone,
                    "taps": taps},
    }


def _device(params: Params) -> torch.device:
    return params["head"]["projects"][0]["weight"].device


@torch.no_grad()
def moge_forward(params: Params, image: torch.Tensor):
    """image [B, H, W, 3] in [0, 1] -> (points [B, H, W, 3], mask_logit
    [B, H, W]); z > 0 through exp of the clipped channel."""
    from versecrafter_tpu_torch.perception.moge_head import head_forward

    st = params["_static"]
    patch, heads, taps = int(st["patch"]), int(st["heads"]), [int(t) for t in st["taps"]]
    b, h, w, _ = image.shape
    gh, gw = h // patch, w // patch
    x = image * 2.0 - 1.0
    with full_fp32():
        if st.get("backbone") == "dinov2":
            from versecrafter_tpu_torch.perception.dinov2 import dinov2_forward
            cfg = dict(hidden=params["vit"]["patch_embed"]["weight"].shape[1],
                       depth=len(params["vit"]["layers"]), heads=heads, patch=patch)
            _, feats = dinov2_forward(params["vit"], cfg, x.permute(0, 3, 1, 2),
                                      out_layers=taps, norm_taps=True)
        else:
            _, feats = vit_forward(params["vit"], x, patch=patch, heads=heads, out_layers=taps)
        feats = [f[:, -gh * gw:] for f in feats]
        out = head_forward(params["head"], feats, gh, gw, aspect=w / h)
        out = resize_bilinear(out, h, w)
    z = torch.exp(torch.clamp(out[..., 2:3], -10.0, 10.0))
    return torch.cat([out[..., :2], z], -1), out[..., 3]


def convert_moge_checkpoint(state_dict, dtype=torch.float32, heads: Optional[int] = None
                            ) -> Tuple[Params, Dict[str, Any]]:
    """A public MoGe torch checkpoint ({'model': sd} or a flat sd):
    `backbone.*` (facebookresearch dinov2 layout) + `head.*` (MoGe Head)
    -> (params, report of the keys left unconsumed)."""
    from versecrafter_tpu_torch.perception.dinov2 import convert_fb_dinov2
    from versecrafter_tpu_torch.perception.moge_head import convert_head

    if "model" in state_dict and not hasattr(state_dict["model"], "shape"):
        state_dict = state_dict["model"]
    bb = convert_fb_dinov2(state_dict, prefix="backbone.", dtype=dtype)
    head = convert_head(state_dict, prefix="head.", dtype=dtype)
    depth = len(bb["layers"])
    dim = bb["patch_embed"]["weight"].shape[1]
    heads_by_dim = {384: 6, 768: 12, 1024: 16, 1536: 24}
    if heads is None:
        heads = heads_by_dim.get(dim, max(1, dim // 64))
    patch = int(state_dict["backbone.patch_embed.proj.weight"].shape[-1])
    leftover = sorted(k for k in state_dict
                      if not k.startswith(("backbone.", "head.")) and not k.endswith("mask_token"))
    params = {"vit": bb, "head": head,
              "_static": {"patch": patch, "heads": heads, "backbone": "dinov2",
                          "taps": _taps(depth)}}
    return params, {"unconsumed_keys": leftover, "num_projects": len(head["projects"]),
                    "backbone_depth": depth}


def infer(params: Params, image: np.ndarray, fov_x: Optional[float] = None) -> dict:
    """image [H, W, 3] float 0..1 -> dict(points, depth, mask, intrinsics)
    in numpy, intrinsics normalized; the network runs on the params'
    device."""
    h, w = image.shape[:2]
    x = torch.from_numpy(np.ascontiguousarray(image, np.float32))[None].to(_device(params))
    pts, mlogit = moge_forward(params, x)
    pts = pts[0].float().cpu().numpy()
    mask = mlogit[0].cpu().numpy() > 0
    if fov_x is not None:
        focal = (w / max(h, w)) / (2 * math.tan(math.radians(fov_x) / 2))
        _, shift = recover_focal_shift(pts, mask if mask.any() else None)
    else:
        focal, shift = recover_focal_shift(pts, mask if mask.any() else None)
    depth = pts[..., 2] + shift
    points = pts.copy()
    points[..., 2] = depth
    return {"points": points, "depth": depth, "mask": mask,
            "intrinsics": normalized_intrinsics(focal, h, w)}


def replace_infs_with_max(depth: np.ndarray) -> np.ndarray:
    """Invalid (non-finite or <= 0) depths -> the largest valid one + 10."""
    d = depth.copy()
    valid = np.isfinite(d) & (d > 0)
    if not valid.any():
        raise ValueError("No valid depth values")
    d[~valid] = float(d[valid].max()) + 10.0
    return d


def grayscale_depth(depth: np.ndarray) -> np.ndarray:
    """Disparity grayscale [H, W, 3] uint8, normalized between its 0.1 %
    and 99 % quantiles."""
    d = depth.astype(np.float64)
    valid = (d > 0) & np.isfinite(d)
    disp = np.zeros_like(d)
    disp[valid] = 1.0 / d[valid]
    if valid.any():
        lo = float(np.quantile(disp[valid], 0.001))
        hi = float(np.quantile(disp[valid], 0.99))
        disp = (disp - lo) / max(hi - lo, 1e-8)
    g = (np.clip(disp, 0, 1) * 255).astype(np.uint8)
    return np.stack([g, g, g], -1)


def colorize_depth(depth: np.ndarray) -> np.ndarray:
    """The normalized disparity through OpenCV's TURBO colour map, RGB."""
    from versecrafter_tpu_torch.utils.imgproc import colormap_turbo
    return colormap_turbo(grayscale_depth(depth)[..., 0])


def export_mesh(output: dict, image: np.ndarray, out_dir: str, threshold: float = 0.04,
                save_glb: bool = True, save_ply: bool = True) -> Dict[str, str]:
    """Grid-triangulated mesh of the point map without its depth edges, in
    the OpenGL convention (vertices * [1, -1, -1], uv * [1, -1] + [0, 1]):
    mesh.glb with the image as texture, pointcloud.ply with vertex colours."""
    from versecrafter_tpu_torch.utils import mesh_export as me

    h, w = output["depth"].shape
    mask = output.get("mask")
    mask = np.ones((h, w), bool) if mask is None else mask.astype(bool)
    edge = me.depth_edge_mask(replace_infs_with_max(output["depth"]), rtol=threshold)
    mask = mask & ~edge
    if mask.sum() < 4:
        mask = ~edge
    if mask.sum() < 4:
        mask = np.ones((h, w), bool)
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    faces, vertices, colors, uvs = me.build_mesh_from_map(
        output["points"], img.astype(np.float32) / 255.0, me.image_uv(h, w), mask)
    vertices = vertices * np.array([1, -1, -1], np.float32)
    uvs = uvs * np.array([1, -1], np.float32) + np.array([0, 1], np.float32)
    os.makedirs(out_dir, exist_ok=True)
    paths: Dict[str, str] = {}
    if save_glb:
        paths["glb"] = os.path.join(out_dir, "mesh.glb")
        me.save_glb(paths["glb"], vertices, faces, vertex_uvs=uvs, texture_rgb=img)
    if save_ply:
        paths["ply"] = os.path.join(out_dir, "pointcloud.ply")
        me.save_ply(paths["ply"], vertices, np.zeros((0, 3), np.int32), colors)
    return paths


# ---------------------------------------------------------------------------
# checkpoints: npz of flattened JAX parameter paths
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    """(name, leaf) pairs under JAX's path names; a list under the key
    "blocks" (the generic ViT's) is named as the JAX tree's stacked blocks,
    its leaves stacked on a leading axis."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            name = f"{prefix}{k}"
            if k == "blocks" and isinstance(v, list):
                for sub, _ in _flat(v[0], name + "/"):
                    yield sub, [dict(_flat(b, name + "/"))[sub] for b in v]
            else:
                yield from _flat(v, name + "/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _to_numpy(leaf) -> Optional[np.ndarray]:
    if isinstance(leaf, list):  # stacked blocks
        return np.stack([_to_numpy(x) for x in leaf])
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    arr = np.asarray(leaf)
    return arr if np.issubdtype(arr.dtype, np.number) else None


def _fill(tree, flat, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            name = f"{prefix}{k}"
            if k == "blocks" and isinstance(v, list):
                out[k] = [_fill(b, {n[len(name) + 1:]: a[i] for n, a in flat.items()
                                    if n.startswith(name + "/")}, "") for i, b in enumerate(v)]
            else:
                out[k] = _fill(v, flat, name + "/")
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, flat, f"{prefix}{i}/") for i, v in enumerate(tree))
    name = prefix[:-1]
    if name not in flat:
        return tree
    if isinstance(tree, torch.Tensor):
        return torch.from_numpy(np.array(flat[name])).to(tree.device)
    return type(tree)(flat[name]) if isinstance(tree, (int, float)) else tree


def load_checkpoint(path: str, template: Optional[Params] = None, device=None) -> Params:
    """A MoGe checkpoint npz (flattened parameter paths, as save_checkpoint
    and the JAX package's save_checkpoint write them) over `template`'s
    tree (default: the full ViT-L model from seed 0 on `device`); leaves the
    file lacks keep the template's value."""
    flat = dict(np.load(path, allow_pickle=False))
    if template is None:
        gen = torch.Generator(device=device or "cpu").manual_seed(0)
        template = init_moge(gen)
    return _fill(template, flat)


def save_checkpoint(params: Params, path: str) -> None:
    """The numeric leaves under their flattened JAX paths, compressed npz
    (bf16 leaves written as float32)."""
    flat = {}
    for name, leaf in _flat(params):
        arr = _to_numpy(leaf)
        if arr is not None:
            flat[name] = arr
    np.savez_compressed(path, **flat)


def save_outputs(output: dict, out_dir: str) -> str:
    """depth_intrinsics.npz (fp16 depth + normalized intrinsics) and the
    depth_gray.png / depth_vis.png views."""
    from versecrafter_tpu_torch.utils.video import write_png
    os.makedirs(out_dir, exist_ok=True)
    depth = replace_infs_with_max(output["depth"])
    np.savez_compressed(os.path.join(out_dir, "depth_intrinsics.npz"),
                        depth=depth.astype(np.float16),
                        intrinsic=output["intrinsics"].astype(np.float16))
    write_png(os.path.join(out_dir, "depth_gray.png"), grayscale_depth(depth))
    write_png(os.path.join(out_dir, "depth_vis.png"), colorize_depth(depth))
    return os.path.join(out_dir, "depth_intrinsics.npz")
