"""Typed configs of the port: field-for-field copies of the JAX package's
dataclasses (same names, same defaults — a test holds them together)."""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class WanDiTConfig:
    """Wan video DiT backbone + optional GeoAdapter control branch."""

    model_type: str = "t2v"
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 16
    dim: int = 2048
    ffn_dim: int = 8192
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 16
    num_layers: int = 32
    qk_norm: bool = True
    cross_attn_norm: bool = True
    # self-attention sliding window (left, right), -1 = unbounded
    window_size: Tuple[int, int] = (-1, -1)
    eps: float = 1e-6
    rope_max_pos: int = 1024
    rope_theta: float = 10000.0
    # GeoAdapter: None = plain backbone; () = every 2nd layer
    geoada_layers: Optional[Tuple[int, ...]] = None
    geoada_in_dim: Optional[int] = None
    # i2v extras
    add_img_emb: bool = False
    img_emb_dim: int = 1280
    # camera-pose control adapter (SimpleAdapter)
    add_control_adapter: bool = False
    in_dim_control_adapter: int = 24
    downscale_factor_control_adapter: int = 8
    control_adapter_residual_blocks: int = 1

    @property
    def head_dim(self) -> int:
        if self.dim % self.num_heads:
            raise ValueError(f"dim {self.dim} not divisible by {self.num_heads} heads")
        return self.dim // self.num_heads

    @property
    def resolved_geoada_layers(self) -> Tuple[int, ...]:
        if self.geoada_layers is None:
            return ()
        if len(self.geoada_layers) == 0:
            return tuple(range(0, self.num_layers, 2))
        return tuple(self.geoada_layers)

    @property
    def has_geoadapter(self) -> bool:
        return self.geoada_layers is not None

    @property
    def resolved_geoada_in_dim(self) -> int:
        return self.in_dim if self.geoada_in_dim is None else self.geoada_in_dim


# Published Wan scales (public model cards).
WAN21_1_3B = WanDiTConfig(dim=1536, ffn_dim=8960, num_heads=12, num_layers=30)
WAN21_14B = WanDiTConfig(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40)


def versecrafter_14b(geoada_in_dim: int = 128) -> WanDiTConfig:
    """Wan2.1-T2V-14B + GeoAdapter with 128-channel control latents."""
    return dataclasses.replace(
        WAN21_14B, geoada_layers=(), geoada_in_dim=geoada_in_dim)


@dataclass(frozen=True)
class VAEConfig:
    """Wan2.1 3D causal VAE (temporal 4x, spatial 8x, 16 latent channels)."""

    base_dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    dropout: float = 0.0
    temporal_compression_ratio: int = 4
    spatial_compression_ratio: int = 8
    # channel-wise latent normalization (Wan2.1 public stats)
    use_latent_stats: bool = True


@dataclass(frozen=True)
class T5Config:
    """umT5-xxl encoder."""

    vocab: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    rel_pos_max_distance: int = 128
    shared_pos: bool = False  # umT5: per-layer relative position bias
    text_length: int = 512
    eps: float = 1e-6


@dataclass(frozen=True)
class SchedulerConfig:
    """Flow-matching sampler settings."""

    name: str = "unipc"  # "euler" | "unipc" | "dpm++"
    num_train_timesteps: int = 1000
    shift: float = 16.0
    solver_order: int = 2
    use_dynamic_shifting: bool = False


@dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout (the JAX package's fields): the port's mesh is
    parallel/mesh.py's (dp, fsdp, sp, tp) over torch.distributed, and with
    sp > 1 its attention is Ulysses or, with ring_attention, the ring."""

    dp: int = 1        # data / CFG-batch parallel
    fsdp: int = 1      # parameter sharding
    sp: int = 1        # sequence (context) parallel
    tp: int = 1        # tensor parallel (heads / ffn)
    ring_attention: bool = True


@dataclass(frozen=True)
class PipelineConfig:
    """End-to-end generation settings (the canonical operating point)."""

    height: int = 480
    width: int = 832
    num_frames: int = 81
    num_inference_steps: int = 30
    guidance_scale: float = 5.0
    shift: float = 16.0
    fps: int = 16
    seed: int = 2025
    geoada_context_scale: float = 1.0
    # acceleration
    teacache_threshold: float = 0.0  # 0 disables
    teacache_skip_start: int = 5
    cfg_skip_ratio: float = 0.0
    riflex_k: Optional[int] = None


# ---------------------------------------------------------------------------
# the reference's model YAML (config/wan2.1/wan_civitai.yaml)
# ---------------------------------------------------------------------------

# PyYAML's SafeLoader resolvers (YAML 1.1) for the plain scalars this reader takes
_YAML_NULL = re.compile(r"~|null|Null|NULL")
_YAML_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True, "TRUE": True,
              "on": True, "On": True, "ON": True, "no": False, "No": False, "NO": False,
              "false": False, "False": False, "FALSE": False, "off": False, "Off": False,
              "OFF": False}
_YAML_INT = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|0|[1-9][0-9_]*|0x[0-9a-fA-F_]+)")
_YAML_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
_YAML_SEXAGESIMAL = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?")
_YAML_TIMESTAMP = re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
# what a plain scalar may not start with here, and what it would have been
_YAML_INDICATORS = {"&": "an anchor", "*": "an alias", "!": "a tag",
                    "|": "a literal block scalar", ">": "a folded block scalar",
                    "{": "a flow mapping", "}": "a flow mapping", "[": "a flow sequence",
                    "]": "a flow sequence", ",": "a flow separator", "'": "a quoted key",
                    '"': "a quoted key", "?": "a complex key", "%": "a directive",
                    "@": "a reserved indicator", "`": "a reserved indicator"}
_YAML_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v", "f": "\f",
                 "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
                 "_": "\xa0", "L": "\u2028", "P": "\u2029"}


class _YamlRefused(ValueError):
    pass


def _cut_comment(t: str) -> str:
    """A plain scalar or flow sequence without its comment (` #` onwards)."""
    m = re.search(r"(^|\s)#", t)
    return (t[:m.start()] if m else t).rstrip()


def _yaml_plain(t: str):
    """A plain scalar resolved as PyYAML's SafeLoader resolves it (null, bool,
    int, float, else str)."""
    if not t or _YAML_NULL.fullmatch(t):
        return None
    if t[0] in _YAML_INDICATORS:
        raise _YamlRefused(_YAML_INDICATORS[t[0]])
    if t in ("-", "?", ":") or t[:2] in ("- ", "? ", ": "):
        raise _YamlRefused("a block sequence" if t[0] == "-" else "a complex key")
    if ": " in t or t.endswith(":"):
        raise _YamlRefused("a mapping inside a value")
    if t in ("<<", "="):
        raise _YamlRefused("a merge or value key")
    if _YAML_SEXAGESIMAL.fullmatch(t):
        raise _YamlRefused("a base-60 number")
    if _YAML_TIMESTAMP.match(t):
        raise _YamlRefused("a timestamp")
    if t in _YAML_BOOL:
        return _YAML_BOOL[t]
    if _YAML_INT.fullmatch(t):
        v = t.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        return sign * int(v, 8 if len(v) > 1 and v[0] == "0" else 10)
    if _YAML_FLOAT.fullmatch(t):
        v = t.replace("_", "").lower()
        return float(v.replace(".", "") if v.endswith(("inf", "nan")) else v)
    return t


def _yaml_quoted(t: str) -> str:
    """A single- or double-quoted scalar that closes on its line, followed by
    nothing but a comment."""
    q, i, out = t[0], 1, []
    while i < len(t):
        c = t[i]
        if c == q and not (q == "'" and t[i + 1:i + 2] == "'"):
            break
        if q == "'" or c != "\\":
            out.append(c)
            i += 2 if c == "'" else 1
            continue
        e = t[i + 1:i + 2]
        width = {"x": 2, "u": 4, "U": 8}.get(e)
        if width and re.fullmatch(f"[0-9a-fA-F]{{{width}}}", t[i + 2:i + 2 + width]):
            out.append(chr(int(t[i + 2:i + 2 + width], 16)))
            i += 2 + width
        elif e in _YAML_ESCAPES:
            out.append(_YAML_ESCAPES[e])
            i += 2
        else:
            raise _YamlRefused("a malformed escape")
    if i >= len(t):
        raise _YamlRefused("a quoted scalar that does not close on its line")
    if _cut_comment(t[i + 1:]).strip():
        raise _YamlRefused("text after a quoted scalar")
    return "".join(out)


def _yaml_value(t: str):
    if t[0] in "'\"":
        return _yaml_quoted(t)
    t = _cut_comment(t)
    if t.startswith("["):
        if not t.endswith("]") or any(c in t[1:-1] for c in "[]{}'\""):
            raise _YamlRefused("a flow sequence other than one line of plain scalars")
        items = [x.strip() for x in t[1:-1].split(",")]
        if items[-1] == "":
            items.pop()  # a trailing comma, or []
        if "" in items:
            raise _YamlRefused("an empty flow sequence entry")
        return [_yaml_plain(x) for x in items]
    return _yaml_plain(t)


def parse_yaml(text: str):
    """The subset of YAML that the reference's model configs use, parsed as
    PyYAML's safe_load parses it: nested `key: value` block mappings by
    indentation, plain and quoted one-line scalars, one-line flow lists of
    plain scalars, comments. Anything else (block sequences, block scalars,
    anchors, aliases, tags, flow mappings, tabs, multi-line scalars, more
    than one document) raises ValueError. (The GPU machine has no PyYAML.)"""
    root: dict = {}
    stack = []  # (indent of the mapping's keys, mapping)
    pending = None  # (mapping, key, indent) of the last key, when it had no value
    ended = False
    for no, raw in enumerate(text.splitlines(), 1):
        body = raw.strip(" ")
        if not body or body.startswith("#"):
            continue
        try:
            if "\t" in raw:
                raise _YamlRefused("a tab")
            marker = _cut_comment(body)
            if ended or marker.startswith("---") and (stack or marker != "---"):
                raise _YamlRefused("more than one document")
            if marker in ("---", "..."):
                ended = marker == "..."
                continue
            indent = len(raw) - len(raw.lstrip(" "))
            if not stack:
                stack.append((indent, root))
            if pending is not None:
                mapping, key, key_indent = pending
                pending = None
                if indent > key_indent:
                    mapping[key] = {}
                    stack.append((indent, mapping[key]))
            if indent > stack[-1][0]:
                raise _YamlRefused("a line indented under a key that has a value")
            while len(stack) > 1 and indent < stack[-1][0]:
                stack.pop()
            if indent != stack[-1][0]:
                raise _YamlRefused("an indentation that matches no mapping above it")
            if body == "-" or body.startswith("- "):
                raise _YamlRefused("a block sequence")
            colon = next((i for i, c in enumerate(body)
                          if c == ":" and body[i + 1:i + 2] in ("", " ")), None)
            if colon is None:
                raise _YamlRefused("a line that is not `key: value`")
            key_text, value = body[:colon].rstrip(), _cut_comment(body[colon + 1:]).strip()
            if _cut_comment(key_text) != key_text:
                raise _YamlRefused("a comment inside a key")
            key = _yaml_plain(key_text)
            mapping = stack[-1][1]
            if value:
                mapping[key] = _yaml_value(body[colon + 1:].strip())
            else:
                mapping[key] = None
                pending = (mapping, key, indent)
        except _YamlRefused as e:
            raise ValueError(f"YAML line {no}: {e} is outside the subset this reader takes: "
                             f"{raw!r}") from None
    return root if stack else None


def load_yaml_config(path: str) -> dict:
    """A reference-format model YAML (e.g. config/wan2.1/wan_civitai.yaml)
    -> {"vae": VAEConfig, "t5": T5Config, "scheduler": SchedulerConfig,
    "raw": the parsed mapping}, as the JAX package's load_yaml_config."""
    with open(path) as f:
        raw = parse_yaml(f.read())

    def sub(key):
        return dict(raw.get(key) or {})

    te = sub("text_encoder_kwargs")
    t5 = T5Config(
        vocab=te.get("vocab", 256384),
        dim=te.get("dim", 4096),
        dim_attn=te.get("dim_attn", 4096),
        dim_ffn=te.get("dim_ffn", 10240),
        num_heads=te.get("num_heads", 64),
        num_layers=te.get("num_layers", 24),
        num_buckets=te.get("num_buckets", 32),
        shared_pos=te.get("shared_pos", False),
        text_length=te.get("text_length", 512),
    )
    vk = sub("vae_kwargs")
    vae = VAEConfig(
        temporal_compression_ratio=vk.get("temporal_compression_ratio", 4),
        spatial_compression_ratio=vk.get("spatial_compression_ratio", 8),
    )
    sk = sub("scheduler_kwargs")
    sched = SchedulerConfig(
        num_train_timesteps=sk.get("num_train_timesteps", 1000),
        shift=sk.get("shift", 5.0),
        use_dynamic_shifting=sk.get("use_dynamic_shifting", False),
    )
    return {"vae": vae, "t5": t5, "scheduler": sched, "raw": raw}
