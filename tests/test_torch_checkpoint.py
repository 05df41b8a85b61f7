"""Port parity for checkpoints in the JAX package's orbax layout
(core/checkpoint.py, core/convert.params_to_jax): the port writes a tiny
trained GeoAdapter tree (bf16 kernels, fp32 norms and modulation) and a
LoRA tree (fp32) that the JAX package's load_checkpoint restores against
its own templates bit for bit, and reads them back; params_to_jax inverts
params_from_jax bit for bit; the train CLI's step_NNNNNN directory (and
its LoRA one) restores in the JAX package against the JAX train CLI's
template; an OCDBT checkpoint of the JAX package's is refused with the
reason. CPU."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from versecrafter_tpu.core import checkpoint as jckpt
from versecrafter_tpu.core.config import WanDiTConfig
from versecrafter_tpu.models.wan_dit import init_wan_dit
from versecrafter_tpu.parallel.train_step import split_trainable
from versecrafter_tpu.utils.lora import init_lora
from versecrafter_tpu_torch.cli import train as tcli
from versecrafter_tpu_torch.core import checkpoint as tckpt
from versecrafter_tpu_torch.core.convert import params_from_jax, params_to_jax
from tests.jax_prng import threefry_default  # noqa: F401

CFG = WanDiTConfig(in_dim=4, dim=64, ffn_dim=128, freq_dim=32, text_dim=48, out_dim=4,
                   num_heads=4, num_layers=4, text_len=16, geoada_layers=(),
                   geoada_in_dim=8)


def _np(t):
    """A tensor as numpy, bf16 as ml_dtypes' bfloat16 (same bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _assert_bits(got, want, path=""):
    """Same structure; every leaf the same dtype, shape and bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, sorted(got))
        for k in want:
            _assert_bits(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_bits(a, b, f"{path}[{i}]")
    else:
        g = _np(got) if isinstance(got, torch.Tensor) else np.asarray(got)
        w = _np(want) if isinstance(want, torch.Tensor) else np.asarray(want)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), (path, g.dtype, w.dtype)
        assert g.tobytes() == w.tobytes(), path


def _to_torch(tree):
    """A JAX-layout numpy tree as tensors, no block list unstacked."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a).view(np.int16)).view(
        torch.bfloat16) if a.dtype == jnp.bfloat16 else torch.from_numpy(np.array(a)), tree)


@pytest.fixture(scope="module")
def trees():
    """The trainable GeoAdapter tree of a bf16 init (its norms and
    modulation fp32) and fp32 LoRA factors over both block lists, randomized
    as trained trees are (a LoRA's up starts at zero)."""
    params = init_wan_dit(jax.random.key(0), CFG, jnp.bfloat16)
    train, _ = split_trainable(params)
    lora = init_lora(params, 4, jax.random.key(1), groups=("blocks", "geoada_blocks"),
                     dtype=jnp.float32)
    lora = jax.tree.map(lambda a: a + 0.01 * jax.random.normal(jax.random.key(2), a.shape,
                                                               a.dtype), lora)
    return jax.tree.map(np.asarray, train), jax.tree.map(np.asarray, lora)


def test_port_checkpoints_restore_in_jax(trees, tmp_path):
    train, lora = trees
    dtypes = {np.asarray(a).dtype for a in jax.tree.leaves(train)}
    assert dtypes == {np.dtype(jnp.bfloat16), np.dtype(np.float32)}
    port_train = params_from_jax(train)
    assert isinstance(port_train["geoada_blocks"], list)
    port_lora = _to_torch(lora)  # the port keeps the factors stacked, as JAX
    for name, port, jtree in (("geo", port_train, train), ("lora", port_lora, lora)):
        path = str(tmp_path / name / "step_000001")
        tckpt.save_checkpoint(path, {"params": port})
        assert {"_METADATA", "_CHECKPOINT_METADATA", "_sharding"} <= set(os.listdir(path))
        template = {"params": jax.tree.map(jnp.asarray, jtree)}
        got = jckpt.load_checkpoint(path, template)
        _assert_bits(jax.tree.map(np.asarray, got), {"params": jtree})
        # without a template too (the shardings from the _sharding file)
        _assert_bits(jax.tree.map(np.asarray, jckpt.load_checkpoint(path)), {"params": jtree})
        # and back into the port's layout, against its template
        back = tckpt.load_checkpoint(path, template={"params": port})
        _assert_bits(back, {"params": port})
        with pytest.raises(ValueError):
            bad = {"params": {**port, "extra": torch.zeros(1)}}
            tckpt.load_checkpoint(path, template=bad)


def test_params_to_jax_inverts_params_from_jax(trees):
    train, lora = trees
    full = jax.tree.map(np.asarray, init_wan_dit(jax.random.key(3), CFG, jnp.bfloat16))
    for t in (train, full):
        back = params_to_jax(params_from_jax(t))
        _assert_bits(back, t)
    # the port's LoRA factors are already stacked: unchanged
    _assert_bits(params_to_jax(_to_torch(lora)), lora)


@pytest.mark.parametrize("lora_rank", [0, 4])
def test_train_cli_checkpoint_restores_in_jax(tmp_path, lora_rank):
    """The port's --tiny CLI (3 steps) writes step_000003 that the JAX
    package restores against the JAX train CLI's own template for the
    same flags: split_trainable's GeoAdapter tree, or init_lora's factors
    over both block lists."""
    out = tcli.run(tcli.parse_args([
        "--tiny", "--synthetic", "2", "--steps", "3", "--device", "cpu", "--sample_size",
        "32,32", "--video_length", "5", "--lora_rank", str(lora_rank),
        "--output_dir", str(tmp_path)]))
    path = str(tmp_path / "step_000003")
    assert os.path.isdir(path) and not os.path.exists(path + ".pt")
    assert os.path.exists(path + "_lora.safetensors") == (lora_rank > 0)
    cfg = WanDiTConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in dataclasses.asdict(tcli.tiny_config()).items()})
    params = init_wan_dit(jax.random.key(0), cfg, jnp.float32)
    template = (init_lora(params, lora_rank, jax.random.key(5),
                          groups=("blocks", "geoada_blocks")) if lora_rank
                else split_trainable(params)[0])
    got = jckpt.load_checkpoint(path, {"params": template})
    want = {"params": params_to_jax(out["train"])}
    _assert_bits(jax.tree.map(np.asarray, got), jax.tree.map(_np, want))


def test_ocdbt_checkpoint_is_refused(tmp_path):
    """The JAX package's own save (orbax's default OCDBT format) needs
    tensorstore to read: the port says so."""
    path = str(tmp_path / "jax_step")
    jckpt.save_checkpoint(path, {"params": {"a": jnp.ones((2, 3))}})
    with pytest.raises(ValueError, match="OCDBT"):
        tckpt.load_checkpoint(path)
