"""Checkpoint save / load of the port's parameter trees, in the layout the
JAX package's orbax checkpoints restore.

save_checkpoint(path, tree) writes the directory that orbax's PyTree
handler writes without OCDBT, from numpy and json alone (the card machine
has no orbax, tensorstore or zstd):

- `_METADATA`: every leaf's key path ("key_type" 2 for a dict key, 1 for a
  list index) with `"use_ocdbt": false`;
- `_CHECKPOINT_METADATA`: the PyTree handler's name;
- `_sharding`: each leaf on one device of the reader's (a one-device
  NamedSharding over device id 0, which orbax resolves on any platform);
  orbax's restore, with or without a template, needs it;
- one zarr v2 array a leaf, named by its dotted path (`params.a.kernel`):
  `.zarray` (`"compressor": null`; bf16 as the `"bfloat16"` dtype) and the
  array as one C-order chunk.

The tree is written in the JAX package's layout (core/convert.params_to_jax:
block lists stacked to [L, ...]), so that
`versecrafter_tpu.core.checkpoint.load_checkpoint(path, template)` restores
it against the JAX train CLI's own template. load_checkpoint reads that
layout back into the port's (with a template: its structure, block lists
included, and every leaf's shape and dtype checked, the counterpart of
orbax's abstract restore), and still reads a `.pt` file of torch.save,
which save_checkpoint writes for a path that ends in `.pt` (a tree orbax
cannot hold, such as a quantized one's zero-size dtype tokens). Chunks that
orbax compressed (its default, zstd) are not read: that needs tensorstore.
"""

from __future__ import annotations

import base64
import json
import os
import shutil
from typing import Any

import torch

_ZARR_DTYPES = {torch.float32: "<f4", torch.float64: "<f8", torch.float16: "<f2",
                torch.bfloat16: "bfloat16", torch.int8: "|i1", torch.uint8: "|u1",
                torch.int16: "<i2", torch.int32: "<i4", torch.int64: "<i8",
                torch.bool: "|b1"}
_TORCH_DTYPES = {v: k for k, v in _ZARR_DTYPES.items()}
# a one-device sharding that orbax maps to device id 0 of whatever platform
# restores it
_SHARDING = json.dumps({"sharding_type": "NamedSharding", "shape": [1], "axis_names": ["d"],
                        "partition_spec": [], "device_mesh": {"mesh": [{"id": 0}]}})
_HANDLER = "orbax.checkpoint._src.handlers.pytree_checkpoint_handler.PyTreeCheckpointHandler"


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _leaves(tree, keys=()):
    """(key path, leaf) in order; a key is (name, key_type)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, keys + ((str(k), 2),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, keys + ((str(i), 1),))
    else:
        yield keys, tree


def _write_leaf(directory: str, t: torch.Tensor) -> None:
    t = t.detach().cpu().contiguous()
    if t.dtype not in _ZARR_DTYPES:
        raise ValueError(f"no zarr dtype for {t.dtype}")
    if t.numel() == 0:
        raise ValueError("orbax cannot hold a zero-size array; save such a tree to a .pt path")
    os.makedirs(directory)
    shape = list(t.shape)
    with open(os.path.join(directory, ".zarray"), "w") as f:
        json.dump({"chunks": shape, "compressor": None, "dimension_separator": ".",
                   "dtype": _ZARR_DTYPES[t.dtype], "fill_value": None, "filters": None,
                   "order": "C", "shape": shape, "zarr_format": 2}, f)
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    with open(os.path.join(directory, ".".join(["0"] * t.dim()) or "0"), "wb") as f:
        f.write(raw.numpy().tobytes())


def save_checkpoint(path: str, tree: Any) -> None:
    """`tree` (the port's layout) as an orbax-readable directory at `path`,
    replaced if it exists; a `.pt` path gets one torch.save file instead."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if path.endswith(".pt"):
        torch.save(_map(tree, lambda t: t.detach().cpu()
                        if isinstance(t, torch.Tensor) else t), path)
        return
    from versecrafter_tpu_torch.core.convert import params_to_jax
    tmp = path + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    meta, sharding = {}, {}
    for keys, leaf in _leaves(params_to_jax(tree)):
        if not isinstance(leaf, torch.Tensor):
            raise ValueError(f"{'.'.join(k for k, _ in keys)}: {type(leaf).__name__} is no tensor")
        name = ".".join(k for k, _ in keys)
        _write_leaf(os.path.join(tmp, name), leaf)
        meta[str(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": kt} for k, kt in keys],
            "value_metadata": {"value_type": "jax.Array", "skip_deserialize": False,
                               "write_shape": list(leaf.shape)}}
        sharding[base64.b64encode(name.encode()).decode()] = _SHARDING
    for name, obj in (
            ("_METADATA", {"tree_metadata": meta, "use_ocdbt": False, "use_zarr3": False,
                           "store_array_data_equal_to_fill_value": True,
                           "custom_metadata": None}),
            ("_CHECKPOINT_METADATA", {"item_handlers": _HANDLER, "metrics": {},
                                      "performance_metrics": {}, "init_timestamp_nsecs": 0,
                                      "commit_timestamp_nsecs": 0, "custom_metadata": {}}),
            ("_sharding", sharding)):
        with open(os.path.join(tmp, name), "w") as f:
            json.dump(obj, f)
    shutil.rmtree(path, ignore_errors=True)
    os.rename(tmp, path)


def _read_leaf(directory: str) -> torch.Tensor:
    with open(os.path.join(directory, ".zarray")) as f:
        z = json.load(f)
    if z.get("compressor") is not None:
        raise ValueError(f"{directory}: chunks compressed with {z['compressor'].get('id')} "
                         "(orbax's default) need tensorstore; the port reads uncompressed ones")
    shape = tuple(z["shape"])
    if tuple(z["chunks"]) != shape or z.get("order", "C") != "C":
        raise ValueError(f"{directory}: the port reads one C-order chunk an array")
    dtype = _TORCH_DTYPES.get(z["dtype"])
    if dtype is None:
        raise ValueError(f"{directory}: zarr dtype {z['dtype']!r}")
    with open(os.path.join(directory, ".".join(["0"] * len(shape)) or "0"), "rb") as f:
        buf = bytearray(f.read())
    raw = torch.int16 if dtype == torch.bfloat16 else dtype
    t = torch.frombuffer(buf, dtype=raw) if buf else torch.empty(0, dtype=raw)
    return t.view(dtype).reshape(shape) if raw != dtype else t.reshape(shape)


def _read_tree(path: str):
    """The JAX-layout tree of an orbax directory (dicts and lists of CPU
    tensors)."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_ocdbt", True):
        raise ValueError(f"{path}: an OCDBT checkpoint (orbax's default format) needs "
                         "tensorstore; the port reads the non-OCDBT layout")
    root: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        node = root
        for k in keys[:-1]:
            node = node.setdefault((k["key_type"], k["key"]), {})
        last = keys[-1]
        node[(last["key_type"], last["key"])] = _read_leaf(
            os.path.join(path, ".".join(k["key"] for k in keys)))

    def build(node):
        if not isinstance(node, dict):
            return node
        if node and all(kt == 1 for kt, _ in node):
            return [build(node[k]) for k in sorted(node, key=lambda k: int(k[1]))]
        return {k: build(v) for (_, k), v in node.items()}
    return build(root)


def _check(template, tree, path="tree"):
    if isinstance(template, dict):
        if not isinstance(tree, dict) or sorted(tree) != sorted(template):
            raise ValueError(f"{path}: keys {sorted(tree) if isinstance(tree, dict) else type(tree)} "
                             f"!= template keys {sorted(template)}")
        for k in template:
            _check(template[k], tree[k], f"{path}.{k}")
    elif isinstance(template, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(template):
            raise ValueError(f"{path}: {type(tree).__name__} of "
                             f"{len(tree) if isinstance(tree, (list, tuple)) else '?'} "
                             f"!= template's {len(template)}")
        for i, (a, b) in enumerate(zip(template, tree)):
            _check(a, b, f"{path}[{i}]")
    elif isinstance(template, torch.Tensor):
        if (not isinstance(tree, torch.Tensor) or tree.shape != template.shape
                or tree.dtype != template.dtype):
            got = (f"{tuple(tree.shape)} {tree.dtype}" if isinstance(tree, torch.Tensor)
                   else type(tree).__name__)
            raise ValueError(f"{path}: {got} != template's "
                             f"{tuple(template.shape)} {template.dtype}")


def load_checkpoint(path: str, template: Any = None, device=None) -> Any:
    """The tree saved at `path` (a save_checkpoint directory, or a .pt
    file), its tensors on `device` (default the CPU). A directory's JAX
    layout becomes the port's (core/convert.params_from_jax_layout: with a
    template, its block lists unstacked where the template has lists).
    With `template`, the tree must have its structure and every leaf its
    shape and dtype."""
    if os.path.isdir(path):
        from versecrafter_tpu_torch.core.convert import params_from_jax_layout
        tree = params_from_jax_layout(_read_tree(path), template)
    else:
        tree = torch.load(path, map_location="cpu", weights_only=True)
    if template is not None:
        _check(template, tree)
    if device is not None:
        tree = _map(tree, lambda t: t.to(device) if isinstance(t, torch.Tensor) else t)
    return tree

