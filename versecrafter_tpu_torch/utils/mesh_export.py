"""Mesh export for monocular-geometry outputs (the port's copy of
``versecrafter_tpu.utils.mesh_export``): grid triangulation, PLY and GLB
writers in numpy + struct, as the reference's MoGe CLI writes them
(`--glb` / `--ply`: a depth-edge-cleaned grid mesh in the OpenGL
convention). The depth-edge mask is a numpy max / min filter (OpenCV's
dilate / erode of a float map, borders ignored); OpenCV only encodes the
GLB's texture PNG, imported at first use.
"""

from __future__ import annotations

import json
import struct
from typing import Optional, Tuple

import numpy as np


def _filter3(d: np.ndarray, k: int, fn, fill: float) -> np.ndarray:
    """Max or min of each pixel's k x k window; pixels outside the image
    take `fill` (OpenCV's default morphology border leaves them out)."""
    h, w = d.shape
    r = k // 2
    pad = np.full((h + 2 * r, w + 2 * r), fill, d.dtype)
    pad[r:r + h, r:r + w] = d
    out = pad[0:h, 0:w].copy()
    for i in range(k):
        for j in range(k):
            out = fn(out, pad[i:i + h, j:j + w])
    return out


def depth_edge_mask(depth: np.ndarray, rtol: float = 0.04,
                    kernel_size: int = 3) -> np.ndarray:
    """True where depth has a discontinuity: the local max-min range within a
    ``kernel_size`` window exceeds ``rtol`` x the center depth
    (``utils3d.np.depth_map_edge`` semantics)."""
    d = depth.astype(np.float32)
    dmax = _filter3(d, kernel_size, np.maximum, -np.inf)
    dmin = _filter3(d, kernel_size, np.minimum, np.inf)
    return (dmax - dmin) > rtol * np.maximum(d, 1e-12)


def image_uv(h: int, w: int) -> np.ndarray:
    """Per-pixel UVs in [0,1], pixel centers (``utils3d.np.uv_map``)."""
    u = (np.arange(w, dtype=np.float32) + 0.5) / w
    v = (np.arange(h, dtype=np.float32) + 0.5) / h
    return np.stack(np.meshgrid(u, v, indexing="xy"), -1)


def build_mesh_from_map(points: np.ndarray, colors: Optional[np.ndarray],
                        uvs: Optional[np.ndarray],
                        mask: Optional[np.ndarray] = None
                        ) -> Tuple[np.ndarray, ...]:
    """Triangulate an [H, W, 3] point map on the pixel grid.

    Each quad splits into two triangles; a triangle is kept only when all of
    its corners are valid under ``mask``. Vertices are compacted to the used
    subset. Returns (faces [F,3] int32, vertices [V,3] f32, then compacted
    colors/uvs for each non-None input) — the return layout of
    ``utils3d.np.build_mesh_from_map``.
    """
    h, w = points.shape[:2]
    valid = np.ones((h, w), bool) if mask is None else mask.astype(bool)
    idx = np.arange(h * w, dtype=np.int64).reshape(h, w)

    tl, tr = idx[:-1, :-1], idx[:-1, 1:]
    bl, br = idx[1:, :-1], idx[1:, 1:]
    vflat = valid.reshape(-1)
    # consistent counter-clockwise winding for a y-down image grid viewed
    # from -z after the OpenGL flip
    t1 = np.stack([tl, bl, tr], -1).reshape(-1, 3)
    t2 = np.stack([tr, bl, br], -1).reshape(-1, 3)
    tris = np.concatenate([t1, t2], 0)
    keep = vflat[tris].all(-1)
    tris = tris[keep]

    used = np.zeros(h * w, bool)
    used[tris.reshape(-1)] = True
    remap = np.cumsum(used) - 1
    faces = remap[tris].astype(np.int32)

    outs = [faces, points.reshape(-1, 3)[used].astype(np.float32)]
    if colors is not None:
        outs.append(colors.reshape(-1, colors.shape[-1])[used].astype(np.float32))
    if uvs is not None:
        outs.append(uvs.reshape(-1, 2)[used].astype(np.float32))
    return tuple(outs)


def save_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
             vertex_colors: Optional[np.ndarray] = None,
             vertex_normals: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY (point cloud when ``faces`` is empty)."""
    n = len(vertices)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    cols = [vertices.astype("<f4")]
    if vertex_normals is not None:
        header += ["property float nx", "property float ny", "property float nz"]
        cols.append(vertex_normals.astype("<f4"))
    rec_parts = [("xyz", "<f4", 3)] + \
        ([("n", "<f4", 3)] if vertex_normals is not None else [])
    if vertex_colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
        c = vertex_colors
        c = (np.clip(c, 0, 1) * 255).astype(np.uint8) if c.dtype != np.uint8 else c
        cols.append(c)
        rec_parts.append(("rgb", "u1", 3))
    nf = len(faces)
    header.append(f"element face {nf}")
    header.append("property list uchar int vertex_indices")
    header.append("end_header")

    rec = np.dtype([(name, dt, (k,)) for name, dt, k in rec_parts])
    vbuf = np.empty(n, rec)
    for (name, _, _), col in zip(rec_parts, cols):
        vbuf[name] = col
    fdt = np.dtype([("k", "u1"), ("v", "<i4", (3,))])
    fbuf = np.empty(nf, fdt)
    if nf:
        fbuf["k"] = 3
        fbuf["v"] = faces.astype("<i4")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(vbuf.tobytes())
        f.write(fbuf.tobytes())


def _pad4(b: bytes, fill: bytes) -> bytes:
    return b + fill * (-len(b) % 4)


def save_glb(path: str, vertices: np.ndarray, faces: np.ndarray,
             vertex_uvs: Optional[np.ndarray] = None,
             texture_rgb: Optional[np.ndarray] = None,
             vertex_normals: Optional[np.ndarray] = None) -> None:
    """Minimal glTF-2.0 binary writer with an optional embedded PNG texture
    (struct + json; the texture PNG-encoded by OpenCV)."""
    vertices = np.ascontiguousarray(vertices, "<f4")
    indices = np.ascontiguousarray(faces.reshape(-1), "<u4")

    bin_parts = []
    views = []
    accessors = []

    def add_view(data: bytes, target: Optional[int]) -> int:
        off = sum(len(p) for p in bin_parts)
        bin_parts.append(_pad4(data, b"\x00"))
        v = {"buffer": 0, "byteOffset": off, "byteLength": len(data)}
        if target is not None:
            v["target"] = target
        views.append(v)
        return len(views) - 1

    def add_accessor(view: int, ctype: int, count: int, atype: str,
                     minmax=None) -> int:
        a = {"bufferView": view, "componentType": ctype, "count": count,
             "type": atype}
        if minmax is not None:
            a["min"], a["max"] = minmax
        accessors.append(a)
        return len(accessors) - 1

    vmin = vertices.min(0).tolist() if len(vertices) else [0.0, 0.0, 0.0]
    vmax = vertices.max(0).tolist() if len(vertices) else [0.0, 0.0, 0.0]
    attrs = {"POSITION": add_accessor(
        add_view(vertices.tobytes(), 34962), 5126, len(vertices), "VEC3",
        (vmin, vmax))}
    if vertex_normals is not None:
        nrm = np.ascontiguousarray(vertex_normals, "<f4")
        attrs["NORMAL"] = add_accessor(
            add_view(nrm.tobytes(), 34962), 5126, len(nrm), "VEC3")
    if vertex_uvs is not None:
        uv = np.ascontiguousarray(vertex_uvs, "<f4")
        attrs["TEXCOORD_0"] = add_accessor(
            add_view(uv.tobytes(), 34962), 5126, len(uv), "VEC2")
    idx_acc = add_accessor(add_view(indices.tobytes(), 34963), 5125,
                           len(indices), "SCALAR")

    gltf = {
        "asset": {"version": "2.0", "generator": "versecrafter_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [
            {"attributes": attrs, "indices": idx_acc, "mode": 4}]}],
        "buffers": [{}],
        "bufferViews": views,
        "accessors": accessors,
    }
    if texture_rgb is not None and vertex_uvs is not None:
        from versecrafter_tpu_torch.utils import png
        img_view = add_view(png.encode(np.ascontiguousarray(texture_rgb, np.uint8)), None)
        gltf["images"] = [{"bufferView": img_view, "mimeType": "image/png"}]
        gltf["samplers"] = [{"magFilter": 9729, "minFilter": 9729,
                             "wrapS": 33071, "wrapT": 33071}]
        gltf["textures"] = [{"source": 0, "sampler": 0}]
        gltf["materials"] = [{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
            "metallicFactor": 0.0, "roughnessFactor": 1.0},
            "doubleSided": True}]
        gltf["meshes"][0]["primitives"][0]["material"] = 0

    binary = b"".join(bin_parts)
    gltf["buffers"][0]["byteLength"] = len(binary)
    js = _pad4(json.dumps(gltf, separators=(",", ":")).encode(), b" ")
    total = 12 + 8 + len(js) + 8 + len(binary)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(binary), 0x004E4942) + binary)


def load_glb_meta(path: str) -> dict:
    """Parse a GLB's JSON chunk (for tests / inspection)."""
    with open(path, "rb") as f:
        magic, version, _ = struct.unpack("<III", f.read(12))
        assert magic == 0x46546C67 and version == 2
        jlen, jtype = struct.unpack("<II", f.read(8))
        assert jtype == 0x4E4F534A
        return json.loads(f.read(jlen))
