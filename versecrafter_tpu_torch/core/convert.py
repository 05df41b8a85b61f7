"""Parameter conversion: the JAX package's pytrees, and the reference's
torch checkpoints.

`params_from_jax` takes a DiT, VAE, T5, CLIP or perception (MoGe, DINOv2,
SAM 2.1, SAM, Grounding DINO) parameter tree given as nested
dicts/lists of numpy arrays (np.asarray of each JAX leaf) and returns the
port's tree: the same keys, every leaf a tensor of the same dtype (bf16
included), linear kernels kept [in, out] and conv kernels kept OIDHW/OIHW.
The DiT's stacked "blocks" / "geoada_blocks" ([L, ...] leading axis) become
lists of per-block dicts. A quantized tree (utils/quantize.py) carries over
too: each block gets its slice of qvalues / q4values / qscales and its
scalar a_dyn / a_scale, and the leaf's zero-size qdtype token unsliced.

`convert_wan_dit`, `convert_wan_vae` and `convert_wan_t5` map the
reference's torch state dicts (the DiT + GeoAdapter from sharded
safetensors, with the i2v `img_emb` / `k_img` / `v_img` keys and the
SimpleAdapter's `control_adapter.*` when present, `Wan2.1_VAE.pth`,
`models_t5_umt5-xxl-enc-bf16.pth`) into the same trees, as the JAX
package's converters of the same names do (`maybe_load_clip` reads a
`models_clip_*.pth` CLIP tower through models/clip.py):

- torch Linear [out, in] -> kernel [in, out];
- conv3d patch embedding [D, C, pt, ph, pw] -> matmul kernel
  [C*pt*ph*pw, D] (patchify uses the same (c, pt, ph, pw) channel order);
- a checkpoint leaf whose shape does not fit is skipped with a report;
  each converter returns (tree, {"skipped": [...], "unused": [...]}).

Each leaf goes to the target device as soon as it is read, and is cast
there, so no second host copy of a whole tree is ever held (a 14B DiT is
28 GB in bf16). State dicts come from `load_torch_state_dict`, whose
safetensors reader is the port's own (8-byte little-endian header length,
a JSON header, raw bytes) over mmap, and reads one tensor per key access;
`save_safetensors` writes the same format.
"""

from __future__ import annotations

import glob
import json
import math
import mmap
import os
import struct
import zipfile
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from versecrafter_tpu_torch.core.config import T5Config, VAEConfig, WanDiTConfig
from versecrafter_tpu_torch.utils import quantize as qz

_STACKED = ("blocks", "geoada_blocks")


def _leaf(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: exact via float32
        return torch.from_numpy(arr.astype(np.float32)).to(device=device,
                                                           dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def _unstack(tree, i: int):
    """Block i of a stacked subtree. A quantized leaf's zero-size `qdtype`
    token has no layer axis and goes into every block as it is."""
    if isinstance(tree, dict):
        return {k: np.asarray(v) if k == "qdtype" else _unstack(v, i)
                for k, v in tree.items()}
    return np.asarray(tree)[i]


def _num_stacked(tree) -> int:
    while isinstance(tree, dict):
        tree = next(v for k, v in tree.items() if k != "qdtype")
    return np.asarray(tree).shape[0]


def params_from_jax(tree: Any, device=None) -> Any:
    """Nested dicts/lists of numpy arrays -> the port's parameter tree.
    Python scalars and strings (the static config some perception trees
    carry, e.g. MoGe's "_static" or SAM's decoder "_heads") stay as they
    are."""
    if isinstance(tree, (str, bool, int, float)) or tree is None:
        return tree
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in _STACKED and isinstance(v, dict):
                v = [_unstack(v, i) for i in range(_num_stacked(v))]
            out[k] = params_from_jax(v, device)
        return out
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return _leaf(tree, device)


# ---------------------------------------------------------------------------
# reading checkpoint files
# ---------------------------------------------------------------------------

_ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
              "F64": torch.float64, "I64": torch.int64, "I32": torch.int32,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


class SafetensorsFile:
    """One .safetensors file: its header, and each tensor read on request
    from a private (copy-on-write) mmap of the file."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self.header: Dict[str, dict] = header
        self._base = 8 + n
        self._mm: Optional[mmap.mmap] = None

    def keys(self):
        return self.header.keys()

    def get(self, name: str) -> torch.Tensor:
        info = self.header[name]
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{self.path}: {name} has dtype {info['dtype']}, "
                             f"not one of {sorted(_ST_DTYPES)}")
        start, end = (self._base + o for o in info["data_offsets"])
        shape = tuple(info["shape"])
        if end == start:
            return torch.empty(shape, dtype=dtype)
        if self._mm is None:
            with open(self.path, "rb") as f:
                self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if start % itemsize:  # a misaligned tensor is copied out of the map
            buf = bytearray(self._mm[start:end])
            return torch.frombuffer(buf, dtype=dtype).reshape(shape)
        return torch.frombuffer(self._mm, dtype=dtype, count=(end - start) // itemsize,
                                offset=start).reshape(shape)


def save_safetensors(path: str, tensors: Mapping) -> int:
    """Writes {name: tensor} as a .safetensors file (the 8-byte
    little-endian header length, the JSON header {name: {dtype, shape,
    data_offsets}} padded to 8 bytes, then each tensor's bytes), one tensor
    at a time through the host; the dtypes SafetensorsFile reads. Returns
    the file's size."""
    names = {v: k for k, v in _ST_DTYPES.items()}
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        if t.dtype not in names:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name here")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw)
        for t in tensors.values():
            f.write(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy())
    return os.path.getsize(path)


class LazyStateDict(Mapping):
    """The keys of one or more safetensors files; reading a key reads that
    one tensor (a later file's key wins over an earlier one's)."""

    def __init__(self, files: List[SafetensorsFile]):
        self._where = {k: f for f in files for k in f.keys()}

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._where[name].get(name)

    def __iter__(self):
        return iter(self._where)

    def __len__(self):
        return len(self._where)

    def __contains__(self, name) -> bool:
        return name in self._where


class _NpzStateDict(Mapping):
    """An .npz archive whose arrays are read one per key access."""

    def __init__(self, path: str):
        self._npz = np.load(path)

    def __getitem__(self, name: str) -> torch.Tensor:
        return _as_tensor(self._npz[name])

    def __iter__(self):
        return iter(self._npz.files)

    def __len__(self):
        return len(self._npz.files)


def load_torch_state_dict(path: str) -> Mapping:
    """A state dict read lazily from a directory of *.safetensors shards, a
    single .safetensors, an .npz, or a torch .pth (torch.load with
    weights_only, memory-mapped when the file is a zip archive; its
    "state_dict" entry when it has one)."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
        if not files:
            raise FileNotFoundError(f"no *.safetensors in {path}")
        return LazyStateDict([SafetensorsFile(f) for f in files])
    if path.endswith(".safetensors"):
        return LazyStateDict([SafetensorsFile(path)])
    if path.endswith(".npz"):
        return _NpzStateDict(path)
    sd = torch.load(path, map_location="cpu", weights_only=True,
                    mmap=zipfile.is_zipfile(path))
    return sd.get("state_dict", sd)


# ---------------------------------------------------------------------------
# state-dict view
# ---------------------------------------------------------------------------

def _as_tensor(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach()
    arr = np.asarray(t)
    if not arr.flags.c_contiguous:
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: the same 16 bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class _SD:
    """A state dict seen leaf by leaf: what was read, what was skipped for
    its shape. A leaf is checked by its shape before it is read, moved to
    the device, cast there, transposed / reshaped and made contiguous."""

    def __init__(self, sd: Mapping, device):
        self.sd = sd
        self.device = device
        self.used = set()
        self.skipped: List[str] = []

    def get(self, name, dtype=None, transpose=False, reshape=None,
            expect=None) -> Optional[torch.Tensor]:
        if name not in self.sd:
            return None
        self.used.add(name)
        t = _as_tensor(self.sd[name])
        shape = tuple(t.shape[::-1]) if transpose else tuple(t.shape)
        if reshape is not None:
            shape = tuple(torch.empty(shape, device="meta").reshape(reshape).shape)
        if expect is not None and shape != tuple(expect):
            self.skipped.append(f"{name}: {shape} != {expect}")
            return None
        t = t.to(self.device, copy=True)
        if dtype is not None:
            t = t.to(dtype)
        if transpose:
            t = t.permute(*range(t.dim() - 1, -1, -1))
        if reshape is not None:
            t = t.reshape(reshape)
        return t.contiguous()

    def unused(self):
        return sorted(set(self.sd) - self.used)


def _maybe(dst: dict, key: str, val):
    if val is not None:
        dst[key] = val


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.t().contiguous()


# ---------------------------------------------------------------------------
# Wan DiT (+ GeoAdapter)
# ---------------------------------------------------------------------------

def _linear(sd: _SD, prefix: str, dtype, bias=True) -> dict:
    out = {}
    _maybe(out, "kernel", sd.get(f"{prefix}.weight", dtype, transpose=True))
    if bias:
        _maybe(out, "bias", sd.get(f"{prefix}.bias", dtype))
    return out


def _attn(sd: _SD, prefix: str, dtype, img_kv=False) -> dict:
    p = {n: _linear(sd, f"{prefix}.{n}", dtype) for n in ("q", "k", "v", "o")}
    nq = sd.get(f"{prefix}.norm_q.weight", torch.float32)
    nk = sd.get(f"{prefix}.norm_k.weight", torch.float32)
    if nq is not None:
        p["norm_q"] = {"scale": nq}
    if nk is not None:
        p["norm_k"] = {"scale": nk}
    if img_kv:  # the i2v image-token keys and values
        ki = _linear(sd, f"{prefix}.k_img", dtype)
        if ki:
            p["k_img"] = ki
            p["v_img"] = _linear(sd, f"{prefix}.v_img", dtype)
            nki = sd.get(f"{prefix}.norm_k_img.weight", torch.float32)
            if nki is not None:
                p["norm_k_img"] = {"scale": nki}
    return p


def _block(sd: _SD, prefix: str, cfg: WanDiTConfig, dtype, geoada=False) -> dict:
    p = {
        "self_attn": _attn(sd, f"{prefix}.self_attn", dtype),
        "cross_attn": _attn(sd, f"{prefix}.cross_attn", dtype,
                            img_kv=cfg.model_type == "i2v" and not geoada),
        "ffn_in": _linear(sd, f"{prefix}.ffn.0", dtype),
        "ffn_out": _linear(sd, f"{prefix}.ffn.2", dtype),
        "modulation": sd.get(f"{prefix}.modulation", torch.float32,
                             reshape=(6, cfg.dim)),
    }
    if cfg.cross_attn_norm:
        p["norm3"] = {
            "scale": sd.get(f"{prefix}.norm3.weight", torch.float32),
            "bias": sd.get(f"{prefix}.norm3.bias", torch.float32),
        }
    if geoada:
        p["after_proj"] = _linear(sd, f"{prefix}.after_proj", dtype)
    return p


def _init_linear_key0(d_in: int, d_out: int, dtype, device) -> dict:
    """The JAX package's `_init_linear(jax.random.key(0), d_in, d_out,
    dtype)`: a xavier-uniform kernel drawn in fp32 from split(key(0))[0]
    and cast, a zero bias; bit for bit, through utils/prng."""
    from versecrafter_tpu_torch.utils import prng

    kkey = prng.split(prng.key(0, device))[0]
    lim = math.sqrt(6.0 / (d_in + d_out))
    kernel = prng.uniform(kkey, (d_in, d_out), torch.float32, -lim, lim).to(dtype)
    return {"kernel": kernel, "bias": torch.zeros((d_out,), dtype=dtype, device=device)}


def _convert_simple_adapter(sd: _SD, cfg: WanDiTConfig, dtype) -> dict:
    """The SimpleAdapter's keys: PixelUnshuffle + Conv2d(kernel = stride =
    patch_size[1:]) as `control_adapter.conv`, whose [D, C*ds*ds, kh, kw]
    weight flattens in simple_adapter's (c', kh, kw) patch order, then
    residual blocks of Sequential(ReLU, Conv3x3, ReLU, Conv3x3) at
    `residual_blocks.{i}.block.1` / `.block.3`, their OIHW weights -> HWIO."""
    ca: dict = {"conv": {
        "kernel": _t(sd.get("control_adapter.conv.weight", dtype, reshape=(cfg.dim, -1))),
        "bias": sd.get("control_adapter.conv.bias", dtype)}, "res": []}

    def conv3x3(name):
        return {"kernel": sd.get(f"{name}.weight", dtype).permute(2, 3, 1, 0).contiguous(),
                "bias": sd.get(f"{name}.bias", dtype)}

    i = 0
    while f"control_adapter.residual_blocks.{i}.block.1.weight" in sd.sd:
        pre = f"control_adapter.residual_blocks.{i}.block"
        ca["res"].append({"conv1": conv3x3(f"{pre}.1"), "conv2": conv3x3(f"{pre}.3")})
        i += 1
    return ca


def convert_simple_adapter(state_dict: Mapping, cfg: WanDiTConfig, dtype=torch.bfloat16,
                           device=None) -> dict:
    """A bare SimpleAdapter state dict (keys prefixed 'control_adapter.')
    -> the adapter's tree."""
    device = torch.device("cpu") if device is None else torch.device(device)
    return _convert_simple_adapter(_SD(state_dict, device), cfg, dtype)


def convert_wan_dit(state_dict: Mapping, cfg: WanDiTConfig, dtype=torch.bfloat16,
                    device=None) -> Tuple[dict, dict]:
    """The reference DiT + GeoAdapter state dict -> (params, {"skipped",
    "unused"}). Linear kernels, biases and the patch embeddings in `dtype`;
    the time embedding and projection, modulations and norm scales in fp32.
    A checkpoint whose geoada_patch_embedding does not fit
    cfg.geoada_in_dim gets a fresh one, drawn as the JAX converter draws it.
    `control_adapter.*` keys give the SimpleAdapter, and an i2v config's
    `img_emb.proj.*` keys its image embedding (norms in fp32)."""
    device = torch.device("cpu") if device is None else torch.device(device)
    sd = _SD(state_dict, device)
    pt, ph, pw = cfg.patch_size

    params: dict = {
        "patch_embedding": {
            "kernel": _t(sd.get("patch_embedding.weight", dtype, reshape=(cfg.dim, -1))),
            "bias": sd.get("patch_embedding.bias", dtype),
        },
        "text_embedding": {
            "fc1": _linear(sd, "text_embedding.0", dtype),
            "fc2": _linear(sd, "text_embedding.2", dtype),
        },
        "time_embedding": {
            "fc1": _linear(sd, "time_embedding.0", torch.float32),
            "fc2": _linear(sd, "time_embedding.2", torch.float32),
        },
        "time_projection": _linear(sd, "time_projection.1", torch.float32),
        "head": {
            "head": _linear(sd, "head.head", dtype),
            "modulation": sd.get("head.modulation", torch.float32, reshape=(2, cfg.dim)),
        },
    }
    params["blocks"] = [_block(sd, f"blocks.{i}", cfg, dtype)
                        for i in range(cfg.num_layers)]

    if cfg.has_geoadapter:
        n_geo = len(cfg.resolved_geoada_layers)
        gblocks = [_block(sd, f"geoada_blocks.{n}", cfg, dtype, geoada=True)
                   for n in range(n_geo)]
        params["geoada_before_proj"] = _linear(sd, "geoada_blocks.0.before_proj", dtype)
        params["geoada_blocks"] = gblocks
        d_in = cfg.resolved_geoada_in_dim * pt * ph * pw
        gpe_w = sd.get("geoada_patch_embedding.weight", dtype, reshape=(cfg.dim, -1),
                       expect=(cfg.dim, d_in))
        if gpe_w is not None:
            params["geoada_patch_embedding"] = {
                "kernel": _t(gpe_w),
                "bias": sd.get("geoada_patch_embedding.bias", dtype),
            }
        else:  # geoada_in_dim differs from the checkpoint's: a fresh init
            params["geoada_patch_embedding"] = _init_linear_key0(d_in, cfg.dim, dtype,
                                                                 device)
    if "control_adapter.conv.weight" in state_dict:
        params["control_adapter"] = _convert_simple_adapter(sd, cfg, dtype)
    if cfg.model_type == "i2v" and "img_emb.proj.0.weight" in state_dict:
        params["img_emb"] = {
            "norm_in": {"scale": sd.get("img_emb.proj.0.weight", torch.float32),
                        "bias": sd.get("img_emb.proj.0.bias", torch.float32)},
            "fc1": _linear(sd, "img_emb.proj.1", dtype),
            "fc2": _linear(sd, "img_emb.proj.3", dtype),
            "norm_out": {"scale": sd.get("img_emb.proj.4.weight", torch.float32),
                         "bias": sd.get("img_emb.proj.4.bias", torch.float32)},
        }
    return params, {"skipped": sd.skipped, "unused": sd.unused()}


# ---------------------------------------------------------------------------
# Wan 3D VAE
# ---------------------------------------------------------------------------

def _conv(sd: _SD, prefix: str, dtype) -> dict:
    return {"kernel": sd.get(f"{prefix}.weight", dtype),
            "bias": sd.get(f"{prefix}.bias", dtype)}


def _gamma(sd: _SD, name: str) -> dict:
    return {"gamma": sd.get(name, torch.float32, reshape=(-1,))}


def _res(sd: _SD, prefix: str, dtype) -> dict:
    p = {
        "norm1": _gamma(sd, f"{prefix}.residual.0.gamma"),
        "conv1": _conv(sd, f"{prefix}.residual.2", dtype),
        "norm2": _gamma(sd, f"{prefix}.residual.3.gamma"),
        "conv2": _conv(sd, f"{prefix}.residual.6", dtype),
    }
    if f"{prefix}.shortcut.weight" in sd.sd:
        p["shortcut"] = _conv(sd, f"{prefix}.shortcut", dtype)
    return p


def _vattn(sd: _SD, prefix: str, dtype) -> dict:
    """1x1 Conv2d weights [out, in, 1, 1] -> dense kernels [in, out]."""
    qkv = sd.get(f"{prefix}.to_qkv.weight", dtype)
    proj = sd.get(f"{prefix}.proj.weight", dtype)
    return {
        "norm": _gamma(sd, f"{prefix}.norm.gamma"),
        "qkv": {"kernel": _t(qkv.reshape(qkv.shape[0], qkv.shape[1])),
                "bias": sd.get(f"{prefix}.to_qkv.bias", dtype)},
        "proj": {"kernel": _t(proj.reshape(proj.shape[0], proj.shape[1])),
                 "bias": sd.get(f"{prefix}.proj.bias", dtype)},
    }


def convert_wan_vae(state_dict: Mapping, cfg: VAEConfig = VAEConfig(),
                    dtype=torch.float32, device=None) -> Tuple[dict, dict]:
    """The Wan VAE's torch layout (encoder.conv1 / downsamples.N / middle /
    head, decoder.conv1 / middle / upsamples.N / head, the conv1 / conv2
    quant convs) -> (params, {"skipped", "unused"}). The encoder's
    downsamples index runs over each stage's res blocks then its resample;
    the decoder's stages take temporal_downsample reversed. The per-channel
    latent mean/std stay inside vae_encode / vae_decode (use_latent_stats),
    as in the JAX package."""
    device = torch.device("cpu") if device is None else torch.device(device)
    sd = _SD(state_dict, device)
    nres = cfg.num_res_blocks
    nstages = len(cfg.dim_mult)

    enc: dict = {"conv_in": _conv(sd, "encoder.conv1", dtype)}
    idx = 0
    stages = []
    for i in range(nstages):
        st = {"res": [_res(sd, f"encoder.downsamples.{idx + j}", dtype)
                      for j in range(nres)]}
        idx += nres
        if i != nstages - 1:
            st["down"] = {"conv": _conv(sd, f"encoder.downsamples.{idx}.resample.1", dtype)}
            if cfg.temporal_downsample[i]:
                st["down"]["time_conv"] = _conv(
                    sd, f"encoder.downsamples.{idx}.time_conv", dtype)
            idx += 1
        stages.append(st)
    enc["stages"] = stages
    enc["mid"] = {
        "res1": _res(sd, "encoder.middle.0", dtype),
        "attn": _vattn(sd, "encoder.middle.1", dtype),
        "res2": _res(sd, "encoder.middle.2", dtype),
    }
    enc["norm_out"] = _gamma(sd, "encoder.head.0.gamma")
    enc["conv_out"] = _conv(sd, "encoder.head.2", dtype)
    enc["quant_conv"] = _conv(sd, "conv1", dtype)

    dec: dict = {
        "post_quant_conv": _conv(sd, "conv2", dtype),
        "conv_in": _conv(sd, "decoder.conv1", dtype),
        "mid": {
            "res1": _res(sd, "decoder.middle.0", dtype),
            "attn": _vattn(sd, "decoder.middle.1", dtype),
            "res2": _res(sd, "decoder.middle.2", dtype),
        },
    }
    idx = 0
    ustages = []
    for i in range(nstages):
        st = {"res": [_res(sd, f"decoder.upsamples.{idx + j}", dtype)
                      for j in range(nres + 1)]}
        idx += nres + 1
        if i != nstages - 1:
            st["up"] = {"conv": _conv(sd, f"decoder.upsamples.{idx}.resample.1", dtype)}
            if cfg.temporal_downsample[::-1][i]:
                st["up"]["time_conv"] = _conv(sd, f"decoder.upsamples.{idx}.time_conv", dtype)
            idx += 1
        ustages.append(st)
    dec["stages"] = ustages
    dec["norm_out"] = _gamma(sd, "decoder.head.0.gamma")
    dec["conv_out"] = _conv(sd, "decoder.head.2", dtype)
    return {"encoder": enc, "decoder": dec}, {"skipped": sd.skipped, "unused": sd.unused()}


# ---------------------------------------------------------------------------
# umT5 encoder (the Wan t5.py layout)
# ---------------------------------------------------------------------------

def convert_wan_t5(state_dict: Mapping, cfg: T5Config, dtype=torch.bfloat16,
                   device=None) -> Tuple[dict, dict]:
    """The Wan umT5 encoder state dict (token_embedding / blocks.N.{norm1,
    attn.{q,k,v,o}, pos_embedding, norm2, ffn.{gate.0, fc1, fc2}} / norm,
    the layout of models_t5_umt5-xxl-enc-bf16.pth) -> (params, {"skipped",
    "unused"}); norms and the relative-position tables in fp32."""
    device = torch.device("cpu") if device is None else torch.device(device)
    sd = _SD(state_dict, device)

    def lin(name):
        return sd.get(name, dtype, transpose=True)

    params: dict = {
        "embed": sd.get("token_embedding.weight", dtype),
        "final_norm": sd.get("norm.weight", torch.float32),
        "blocks": [],
    }
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        params["blocks"].append({
            "norm1": sd.get(f"{pre}.norm1.weight", torch.float32),
            "attn": {
                "q": lin(f"{pre}.attn.q.weight"),
                "k": lin(f"{pre}.attn.k.weight"),
                "v": lin(f"{pre}.attn.v.weight"),
                "o": lin(f"{pre}.attn.o.weight"),
                "rel_bias": sd.get(f"{pre}.pos_embedding.embedding.weight", torch.float32),
            },
            "norm2": sd.get(f"{pre}.norm2.weight", torch.float32),
            "ffn": {
                "wi_0": lin(f"{pre}.ffn.gate.0.weight"),
                "wi_1": lin(f"{pre}.ffn.fc1.weight"),
                "wo": lin(f"{pre}.ffn.fc2.weight"),
            },
        })
    return params, {"skipped": sd.skipped, "unused": sd.unused()}


# ---------------------------------------------------------------------------
# a whole pipeline from a reference-layout model directory
# ---------------------------------------------------------------------------

def maybe_load_clip(model_dir: str, dtype=torch.bfloat16, device=None):
    """(params, cfg) of the CLIP vision tower a model directory ships as
    models_clip_*.pth (the first by name), converted by
    models/clip.convert_clip_vision; (None, None) without one."""
    ckpts = sorted(glob.glob(os.path.join(model_dir, "models_clip_*.pth")))
    if not ckpts:
        return None, None
    from versecrafter_tpu_torch.models.clip import convert_clip_vision
    return convert_clip_vision(load_torch_state_dict(ckpts[0]), dtype=dtype, device=device)


def _dit_config(tdir: str, geoada_in_dim) -> WanDiTConfig:
    with open(os.path.join(tdir, "config.json")) as f:
        tc = json.load(f)
    return WanDiTConfig(  # the JAX package's key fallbacks and defaults
        model_type=tc.get("model_type", "t2v"),
        patch_size=tuple(tc.get("patch_size", (1, 2, 2))),
        in_dim=tc.get("in_dim", tc.get("in_channels", 16)),
        dim=tc.get("dim", tc.get("hidden_size", 2048)),
        ffn_dim=tc.get("ffn_dim", 8192),
        freq_dim=tc.get("freq_dim", 256),
        text_dim=tc.get("text_dim", 4096),
        out_dim=tc.get("out_dim", 16),
        num_heads=tc.get("num_heads", 16),
        num_layers=tc.get("num_layers", 32),
        geoada_layers=tuple(tc["geoada_layers"]) if tc.get("geoada_layers")
        else (() if "geoada_in_dim" in tc or geoada_in_dim else None),
        geoada_in_dim=geoada_in_dim or tc.get("geoada_in_dim"),
    )


def load_dit(tdir: str, cfg: WanDiTConfig, dtype=torch.bfloat16, device=None,
             tag: str = "") -> dict:
    """The DiT tree of a directory of *.safetensors shards, leaf by leaf on
    `device`; skipped and unused keys are printed."""
    params, report = convert_wan_dit(load_torch_state_dict(tdir), cfg, dtype, device)
    if report["skipped"]:
        print(f"convert_wan_dit{tag} skipped: {report['skipped'][:8]}", flush=True)
    if report["unused"]:
        print(f"convert_wan_dit{tag} left {len(report['unused'])} keys unused: "
              f"{report['unused'][:8]}", flush=True)
    return params


def expert_dirs(model_dir: str, transformer_path: Optional[str] = None,
                high_noise_path: Optional[str] = None):
    """(low / single expert's dir, high-noise expert's dir or None): a
    Wan2.2 low_noise_model/ + high_noise_model/ pair under the transformer
    directory is found by itself; `high_noise_path` names the high expert
    elsewhere."""
    tdir = transformer_path or model_dir
    low_dir = os.path.join(tdir, "low_noise_model")
    high_dir = high_noise_path or os.path.join(tdir, "high_noise_model")
    if os.path.isdir(low_dir) and os.path.isdir(high_dir):
        tdir = low_dir
    elif not (high_noise_path and os.path.isdir(high_dir)):
        high_dir = None
    return tdir, high_dir


def load_versecrafter(model_dir: str, transformer_path: Optional[str] = None,
                      geoada_in_dim: int = 128, dtype=torch.bfloat16,
                      scheduler: str = "unipc", tokenizer_path: Optional[str] = None,
                      device=None, high_noise_path: Optional[str] = None,
                      moe_boundary: float = 0.875, load_dit_params: bool = True,
                      quantize: Optional[Tuple[int, bool]] = None):
    """The pipeline of a reference-layout model directory: config.json and
    the DiT + GeoAdapter as *.safetensors shards (in `transformer_path` if
    given), Wan2.1_VAE.pth (fp32) and models_t5_umt5-xxl-enc-bf16.pth (the
    full umT5-xxl), the tokenizer of google/umt5-xxl (the hash tokenizer
    where `transformers` is missing), and a models_clip_*.pth CLIP tower
    when present. A Wan2.2 low_noise_model/ + high_noise_model/ pair (or
    `high_noise_path`) gives a resident expert pair, the high-noise one
    taking the steps with sigma >= moe_boundary. Every leaf is placed on
    `device` (default cuda) as it is read. quantize=(bits, int8_compute)
    quantizes each expert in place (utils/quantize.quantize_dit, dynamic
    activation scales) before the next one is read, so a pair loads whose
    bf16 experts would not fit together (Wan2.2-A14B on one 80 GB card).
    load_dit_params=False reads the DiT's config only and leaves dit_params
    None (the shell an expert_swap fills)."""
    from versecrafter_tpu_torch import resolve_device
    from versecrafter_tpu_torch.sampling.pipeline import VerseCrafterPipeline
    from versecrafter_tpu_torch.utils.tokenizer import load_tokenizer

    dev = resolve_device(device)
    tdir, high_dir = expert_dirs(model_dir, transformer_path, high_noise_path)
    cfg = _dit_config(tdir, geoada_in_dim)

    def expert(d, tag=""):
        params = load_dit(d, cfg, dtype, dev, tag)
        return params if quantize is None else qz.quantize_dit(params, *quantize)

    dit_params = dit_params_high = None
    if load_dit_params:
        dit_params = expert(tdir)
        if high_dir:
            dit_params_high = expert(high_dir, " (high-noise)")

    vae_cfg = VAEConfig()
    vae_params, _ = convert_wan_vae(
        load_torch_state_dict(os.path.join(model_dir, "Wan2.1_VAE.pth")),
        vae_cfg, torch.float32, dev)

    t5_cfg = T5Config()
    t5_params, _ = convert_wan_t5(
        load_torch_state_dict(os.path.join(model_dir, "models_t5_umt5-xxl-enc-bf16.pth")),
        t5_cfg, dtype, dev)
    clip_params, clip_cfg = maybe_load_clip(model_dir, dtype, dev)

    return VerseCrafterPipeline(
        dit_params=dit_params, dit_cfg=cfg,
        vae_params=vae_params, vae_cfg=vae_cfg,
        t5_params=t5_params, t5_cfg=t5_cfg,
        tokenizer=load_tokenizer(tokenizer_path
                                 or os.path.join(model_dir, "google/umt5-xxl"),
                                 vocab_size=t5_cfg.vocab),
        clip_params=clip_params, clip_cfg=clip_cfg,
        dit_params_high=dit_params_high, moe_boundary=moe_boundary,
        scheduler_name=scheduler, device=dev)
