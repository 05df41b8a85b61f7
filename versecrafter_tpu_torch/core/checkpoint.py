"""Checkpoint save / load of the port's parameter trees with torch.save.

The JAX package saves its trees with orbax; the port saves nested dicts and
lists of tensors (moved to the CPU) as one torch.save file. With a
template, load_checkpoint checks every leaf's shape and dtype against it
(the counterpart of orbax's abstract restore) and raises on a mismatch.
"""

from __future__ import annotations

import os
from typing import Any

import torch


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def save_checkpoint(path: str, tree: Any) -> None:
    """torch.save of `tree` with every tensor leaf on the CPU."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(_map(tree, lambda t: t.detach().cpu()
                    if isinstance(t, torch.Tensor) else t), path)


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
    """The tree saved at `path`, its tensors on `device` (default: where
    they were saved from, i.e. the CPU). With `template`, the saved tree
    must have its structure and every leaf its shape and dtype."""
    tree = torch.load(path, map_location="cpu", weights_only=True)
    if template is not None:
        _check(template, tree)
    if device is not None:
        tree = _map(tree, lambda t: t.to(device) if isinstance(t, torch.Tensor) else t)
    return tree
