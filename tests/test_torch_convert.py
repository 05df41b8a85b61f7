"""Port parity for checkpoint loading: the port's converters of the
reference's torch state dicts (core/convert.py) against the JAX package's
converters followed by params_from_jax, leaf for leaf and exactly; the
port's safetensors reader against the `safetensors` package; and a tiny
reference-layout model directory loaded by each package's
load_versecrafter, serving the same seeded request (CPU)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_convert import CFG, VCFG, _dit_to_torch_layout, _vae_to_torch_layout
from test_torch_extras import _assert_trees_equal
from test_torch_pipeline import DIT_CFG, T5_CFG, VAE_CFG, _rel_err
from versecrafter_tpu.core import config as jconfig
from versecrafter_tpu.core import convert as jconvert
from versecrafter_tpu.kernels.rope import grid_cos_sin, rope_3d_angles
from versecrafter_tpu.models.t5 import t5_encode
from versecrafter_tpu.models.vae import vae_decode, vae_encode
from versecrafter_tpu.models.wan_dit import wan_dit_forward
from versecrafter_tpu_torch.core import config as tconfig
from versecrafter_tpu_torch.core import convert as tconvert
from versecrafter_tpu_torch.models import t5 as tt5
from versecrafter_tpu_torch.models import vae as tvae
from versecrafter_tpu_torch.models import wan_dit as twan

T5_SMALL = jconfig.T5Config(vocab=64, dim=16, dim_attn=16, dim_ffn=32, num_heads=2,
                            num_layers=2, num_buckets=8, text_length=8)


def _port(cfg, cls):
    return cls(**dataclasses.asdict(cfg))


def _numpy_tree(tree, stacked=()):
    """A port parameter tree as the JAX package's: numpy leaves, the
    per-block lists under the keys `stacked` stacked along a leading axis."""
    if isinstance(tree, dict):
        return {k: (jax.tree.map(lambda *xs: np.stack(xs), *map(_numpy_tree, v))
                    if k in stacked else _numpy_tree(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


def _init(init_fn, cfg, seed, port_cls, stacked=()):
    """A seeded init of `cfg` (the port's init, fast on the CPU) as the JAX
    package's numpy tree."""
    return _numpy_tree(init_fn(_port(cfg, port_cls), torch.Generator().manual_seed(seed),
                               torch.float32), stacked)


def _randomized_dit(cfg, seed=0):
    """A DiT init with the zero-init head and GeoAdapter projections made
    random, so that every leaf reaches the output."""
    params = _init(twan.init_wan_dit, cfg, seed, tconfig.WanDiTConfig,
                   ("blocks", "geoada_blocks"))
    rng = np.random.default_rng(seed + 90)
    for path in (("head", "head"), ("geoada_before_proj",), ("geoada_blocks", "after_proj")):
        leaf = params
        for key in path:
            leaf = leaf[key]
        leaf["kernel"] = (rng.standard_normal(leaf["kernel"].shape) * 0.05).astype(np.float32)
    return params


def _t5_to_torch_layout(params, cfg):
    sd = {"token_embedding.weight": np.asarray(params["embed"]),
          "norm.weight": np.asarray(params["final_norm"])}
    for i, bp in enumerate(params["blocks"]):
        pre = f"blocks.{i}"
        for n in "qkvo":
            sd[f"{pre}.attn.{n}.weight"] = np.asarray(bp["attn"][n]).T
        sd[f"{pre}.pos_embedding.embedding.weight"] = np.asarray(bp["attn"]["rel_bias"])
        sd[f"{pre}.norm1.weight"] = np.asarray(bp["norm1"])
        sd[f"{pre}.norm2.weight"] = np.asarray(bp["norm2"])
        sd[f"{pre}.ffn.gate.0.weight"] = np.asarray(bp["ffn"]["wi_0"]).T
        sd[f"{pre}.ffn.fc1.weight"] = np.asarray(bp["ffn"]["wi_1"]).T
        sd[f"{pre}.ffn.fc2.weight"] = np.asarray(bp["ffn"]["wo"]).T
    return sd


def _as_torch(sd, dtype):
    """A numpy state dict as torch tensors of `dtype` (bf16 / f16 / fp32)."""
    return {k: torch.from_numpy(np.array(v, np.float32, order="C")).to(dtype)
            for k, v in sd.items()}


def _assert_same_tree(got, ref, path="params"):
    """Same keys and list lengths, and every leaf the same shape, dtype
    and values (bit for bit)."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), path
        for k in ref:
            _assert_same_tree(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _assert_same_tree(a, b, f"{path}[{i}]")
    else:
        assert got.shape == ref.shape and got.dtype == ref.dtype, (
            path, got.shape, got.dtype, ref.shape, ref.dtype)
        assert got.is_contiguous(), path
        assert torch.equal(got, ref), path


def _jax_tree(tree):
    return tconvert.params_from_jax(jax.tree.map(np.asarray, tree))


# (source dtype of the checkpoint, target dtype of the tree)
DTYPES = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
          (torch.bfloat16, torch.bfloat16), (torch.float16, torch.bfloat16)]
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("src,dst", DTYPES)
def test_dit_converter_matches_jax(src, dst):
    sd = _as_torch(_dit_to_torch_layout(_randomized_dit(CFG), CFG), src)
    ref, ref_report = jconvert.convert_wan_dit(sd, CFG, _JNP[dst])
    got, report = tconvert.convert_wan_dit(sd, _port(CFG, tconfig.WanDiTConfig), dst)
    _assert_same_tree(got, _jax_tree(ref))
    assert report == ref_report == {"skipped": [], "unused": []}


@pytest.mark.parametrize("dst", [torch.float32, torch.bfloat16])
def test_geoada_in_dim_mismatch_reinits_like_jax(dst):
    """A checkpoint whose GeoAdapter patch embedding has other input
    channels: both converters skip it and draw the same fresh init."""
    sd = _as_torch(_dit_to_torch_layout(_randomized_dit(CFG), CFG), torch.float32)
    cfg2 = dataclasses.replace(CFG, geoada_in_dim=10)
    ref, ref_report = jconvert.convert_wan_dit(sd, cfg2, _JNP[dst])
    got, report = tconvert.convert_wan_dit(sd, _port(cfg2, tconfig.WanDiTConfig), dst)
    _assert_same_tree(got, _jax_tree(ref))
    assert got["geoada_patch_embedding"]["kernel"].shape == (10 * 4, CFG.dim)
    assert report == ref_report
    assert report["skipped"] == ["geoada_patch_embedding.weight: (48, 24) != (48, 40)"]
    assert report["unused"] == ["geoada_patch_embedding.bias"]


def test_converted_dit_forward_matches_jax():
    params = _randomized_dit(CFG)
    sd = _as_torch(_dit_to_torch_layout(params, CFG), torch.float32)
    got_params, _ = tconvert.convert_wan_dit(sd, _port(CFG, tconfig.WanDiTConfig),
                                             torch.float32)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 4, 2, 8, 8)).astype(np.float32)
    g = rng.standard_normal((1, 6, 2, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 8, 24)).astype(np.float32)
    t = np.asarray([500.0], np.float32)
    cos, sin = (np.asarray(a) for a in grid_cos_sin(
        tuple(jnp.asarray(a) for a in rope_3d_angles(12, max_pos=32)), 2, 4, 4))
    ref = jax.jit(lambda p, *a: wan_dit_forward(p, CFG, *a[:5], geoada_context=a[5],
                                                attn_impl="pallas"))(
        params, x, t, ctx, cos, sin, g)
    got = twan.wan_dit_forward(got_params, _port(CFG, tconfig.WanDiTConfig),
                               *(torch.from_numpy(a) for a in (x, t, ctx, cos, sin)),
                               geoada_context=torch.from_numpy(g))
    assert _rel_err(got, ref) <= 1e-4


@pytest.mark.parametrize("src", [torch.float32, torch.bfloat16])
def test_vae_converter_matches_jax(src):
    params = _init(tvae.init_vae, VCFG, 3, tconfig.VAEConfig)
    sd = _as_torch(_vae_to_torch_layout(params, VCFG), src)
    ref, ref_report = jconvert.convert_wan_vae(sd, VCFG, jnp.float32)
    got, report = tconvert.convert_wan_vae(sd, _port(VCFG, tconfig.VAEConfig))
    _assert_same_tree(got, _jax_tree(ref))
    assert report == ref_report == {"skipped": [], "unused": []}
    if src == torch.float32:  # encode and decode through the converted trees
        pcfg = _port(VCFG, tconfig.VAEConfig)
        x = np.random.default_rng(0).standard_normal((1, 3, 5, 8, 8)).astype(np.float32)
        z_ref = jax.jit(lambda p, x: vae_encode(p, VCFG, x))(ref, x)
        z = tvae.vae_encode(got, pcfg, torch.from_numpy(x))
        assert _rel_err(z, z_ref) <= 1e-4
        y_ref = jax.jit(lambda p, z: vae_decode(p, VCFG, z))(ref, z_ref)
        y = tvae.vae_decode(got, pcfg, torch.from_numpy(np.asarray(z_ref)))
        assert _rel_err(y, y_ref) <= 1e-4


@pytest.mark.parametrize("src,dst", DTYPES[:3])
def test_t5_converter_matches_jax(src, dst):
    params = _init(tt5.init_t5, T5_SMALL, 4, tconfig.T5Config)
    sd = _as_torch(_t5_to_torch_layout(params, T5_SMALL), src)
    ref, ref_report = jconvert.convert_wan_t5(sd, T5_SMALL, _JNP[dst])
    got, report = tconvert.convert_wan_t5(sd, _port(T5_SMALL, tconfig.T5Config), dst)
    _assert_same_tree(got, _jax_tree(ref))
    assert report == ref_report == {"skipped": [], "unused": []}
    if dst == torch.float32:
        ids = np.random.default_rng(1).integers(0, 64, (2, 8)).astype(np.int32)
        out_ref = jax.jit(lambda p, i: t5_encode(p, T5_SMALL, i))(ref, ids)
        out = tt5.t5_encode(got, _port(T5_SMALL, tconfig.T5Config), torch.from_numpy(ids))
        assert _rel_err(out, out_ref) <= 1e-4


# ---------------------------------------------------------------------------
# the safetensors reader and load_torch_state_dict
# ---------------------------------------------------------------------------

def _tensors(seed):
    g = torch.Generator().manual_seed(seed)
    return {
        "a.bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        "b.f16": torch.randn(7, generator=g).to(torch.float16),
        "c.f32": torch.randn(2, 3, 4, generator=g),
        "d.f64": torch.randn(3, generator=g, dtype=torch.float64),
        "e.i64": torch.randint(-2**40, 2**40, (4,), generator=g),
        "f.i32": torch.randint(-9, 9, (5,), generator=g, dtype=torch.int32),
        "g.u8": torch.randint(0, 255, (3,), generator=g, dtype=torch.uint8),
        "h.bool": torch.rand(5, generator=g) > 0.5,
        "i.scalar": torch.tensor(2.5),
        "j.empty": torch.zeros(0, 4),
    }


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        t = got[k]
        assert t.dtype == want[k].dtype and t.shape == want[k].shape, k
        assert torch.equal(t, want[k]), k


def test_safetensors_reader_matches_the_library(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import save_file

    want = _tensors(0)
    path = str(tmp_path / "one.safetensors")
    save_file(want, path, metadata={"format": "pt", "note": "x"})
    sd = tconvert.load_torch_state_dict(path)
    assert isinstance(sd, tconvert.LazyStateDict)
    assert "__metadata__" not in sd
    _same(dict(sd.items()), want)
    with safe_open(path, framework="pt") as f:
        _same(sd, {k: f.get_tensor(k) for k in f.keys()})


def test_safetensors_shard_directory(tmp_path):
    from safetensors.torch import save_file

    a, b = _tensors(1), {f"z.{k}": v for k, v in _tensors(2).items()}
    save_file(a, str(tmp_path / "model-00001-of-00002.safetensors"))
    save_file(b, str(tmp_path / "model-00002-of-00002.safetensors"))
    (tmp_path / "config.json").write_text("{}")
    _same(dict(tconvert.load_torch_state_dict(str(tmp_path)).items()), {**a, **b})
    with pytest.raises(FileNotFoundError):
        tconvert.load_torch_state_dict(str(tmp_path / "nothing"))


def test_misaligned_safetensors_tensor(tmp_path):
    """A hand-written file whose fp32 tensor starts 2 bytes into the data."""
    one = torch.tensor([1.5], dtype=torch.bfloat16)
    two = torch.tensor([3.25, -1.0], dtype=torch.float32)
    header = {"__metadata__": {"k": "v"},
              "one": {"dtype": "BF16", "shape": [1], "data_offsets": [0, 2]},
              "two": {"dtype": "F32", "shape": [2], "data_offsets": [2, 10]}}
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    path = tmp_path / "odd.safetensors"
    path.write_bytes(len(raw).to_bytes(8, "little") + raw
                     + one.view(torch.uint8).numpy().tobytes()
                     + two.view(torch.uint8).numpy().tobytes())
    _same(dict(tconvert.load_torch_state_dict(str(path)).items()), {"one": one, "two": two})


def test_pth_and_npz_state_dicts(tmp_path):
    want = {k: v for k, v in _tensors(3).items() if k != "j.empty"}
    torch.save(want, str(tmp_path / "m.pth"))
    _same(tconvert.load_torch_state_dict(str(tmp_path / "m.pth")), want)
    torch.save({"state_dict": want}, str(tmp_path / "wrapped.pth"))
    _same(tconvert.load_torch_state_dict(str(tmp_path / "wrapped.pth")), want)
    arrays = {k: v.numpy() for k, v in want.items() if v.dtype != torch.bfloat16}
    np.savez(str(tmp_path / "m.npz"), **arrays)
    _same(dict(tconvert.load_torch_state_dict(str(tmp_path / "m.npz")).items()),
          {k: torch.from_numpy(v) for k, v in arrays.items()})


# ---------------------------------------------------------------------------
# load_versecrafter on a tiny reference-layout directory
# ---------------------------------------------------------------------------

# four control videos of z_dim 4 plus the 2x2 pixel-shuffled mask; config.json
# carries no text_len, so it is the default
DIR_CFG = dataclasses.replace(DIT_CFG, geoada_in_dim=20, text_len=512)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """config.json, the DiT + GeoAdapter in two safetensors shards,
    Wan2.1_VAE.pth and models_t5_umt5-xxl-enc-bf16.pth of the tiny configs,
    from seeded JAX inits."""
    from safetensors.torch import save_file

    d = tmp_path_factory.mktemp("model")
    dit = _as_torch(_dit_to_torch_layout(_randomized_dit(DIR_CFG, seed=5), DIR_CFG),
                    torch.bfloat16)
    base = {k: v for k, v in dit.items() if not k.startswith("geoada")}
    save_file(base, str(d / "diffusion_pytorch_model-00001-of-00002.safetensors"))
    save_file({k: v for k, v in dit.items() if k not in base},
              str(d / "diffusion_pytorch_model-00002-of-00002.safetensors"))
    keys = ("model_type", "patch_size", "in_dim", "dim", "ffn_dim", "freq_dim",
            "text_dim", "out_dim", "num_heads", "num_layers", "geoada_in_dim")
    cfg = dataclasses.asdict(DIR_CFG)
    (d / "config.json").write_text(json.dumps({k: cfg[k] for k in keys}))
    vae = _init(tvae.init_vae, VAE_CFG, 6, tconfig.VAEConfig)
    torch.save(_as_torch(_vae_to_torch_layout(vae, VAE_CFG), torch.float32),
               str(d / "Wan2.1_VAE.pth"))
    t5 = _init(tt5.init_t5, T5_CFG, 7, tconfig.T5Config)
    torch.save(_as_torch(_t5_to_torch_layout(t5, T5_CFG), torch.bfloat16),
               str(d / "models_t5_umt5-xxl-enc-bf16.pth"))
    return str(d)


@pytest.fixture
def tiny_text_and_vae(monkeypatch):
    """Both packages' load_versecrafter build T5Config() and VAEConfig():
    point them at the tiny configs for this test."""
    monkeypatch.setattr(jconfig, "T5Config", lambda: T5_CFG)
    monkeypatch.setattr(jconfig, "VAEConfig", lambda: VAE_CFG)
    monkeypatch.setattr(tconvert, "T5Config", lambda: _port(T5_CFG, tconfig.T5Config))
    monkeypatch.setattr(tconvert, "VAEConfig", lambda: _port(VAE_CFG, tconfig.VAEConfig))


def test_load_versecrafter_serves_the_jax_request(model_dir, tiny_text_and_vae):
    tp = tconvert.load_versecrafter(model_dir, geoada_in_dim=20, dtype=torch.float32,
                                    device="cpu")
    jp = jconvert.load_versecrafter(model_dir, geoada_in_dim=20, dtype=jnp.float32)
    jp.attn_impl = "pallas"
    jp.tokenizer = tp.tokenizer  # the JAX package's hash tokenizer is salted
    assert tp.dit_cfg == _port(jp.dit_cfg, tconfig.WanDiTConfig)
    assert dataclasses.asdict(jp.dit_cfg) == dataclasses.asdict(DIR_CFG)
    for got, ref in ((tp.dit_params, jp.dit_params), (tp.vae_params, jp.vae_params),
                     (tp.t5_params, jp.t5_params)):
        _assert_same_tree(got, _jax_tree(ref))
    rng = np.random.default_rng(0)
    controls = [rng.random((1, 3, 5, 8, 8)).astype(np.float32) for _ in range(4)]
    mask = (rng.random((1, 1, 5, 8, 8)) > 0.5).astype(np.float32)
    kw = dict(negative_prompt="static", control_videos=controls, mask_video=mask,
              height=8, width=8, num_frames=5, num_inference_steps=2,
              guidance_scale=2.0, shift=3.0, seed=11, output_type="numpy")
    ref = jp("a car drives left", dtype=jnp.float32, **kw)
    got = tp("a car drives left", dtype=torch.float32, **kw)
    assert got.shape == ref.shape == (1, 5, 8, 8, 3)
    assert _rel_err(got, ref) <= 1e-4


def _copy_dir(src, dst):
    import shutil
    shutil.copytree(src, dst)
    return str(dst)


# the i2v + SimpleAdapter config of the extra-contents directories: 4 noise +
# 4 conditioning channels, 20-wide CLIP tokens, camera maps of 3 channels (a
# loaded config keeps the adapter's default downscale 8; the widths come
# from the weights)
I2V_DIR_CFG = dataclasses.replace(
    DIR_CFG, model_type="i2v", in_dim=8, add_img_emb=True, img_emb_dim=20,
    add_control_adapter=True, in_dim_control_adapter=3,
    control_adapter_residual_blocks=2)


def _extras_to_torch_layout(params, cfg):
    """The i2v keys (k_img / v_img / norm_k_img of each base block, img_emb)
    and the SimpleAdapter's (OIHW convs) of a numpy JAX-layout tree."""
    sd = {}
    for i in range(cfg.num_layers):
        ca = jax.tree.map(lambda a: a[i], params["blocks"])["cross_attn"]
        for n in ("k_img", "v_img"):
            sd[f"blocks.{i}.cross_attn.{n}.weight"] = np.asarray(ca[n]["kernel"]).T
            sd[f"blocks.{i}.cross_attn.{n}.bias"] = np.asarray(ca[n]["bias"])
        sd[f"blocks.{i}.cross_attn.norm_k_img.weight"] = np.asarray(ca["norm_k_img"]["scale"])
    ie = params["img_emb"]
    for idx, name in ((0, "norm_in"), (4, "norm_out")):
        sd[f"img_emb.proj.{idx}.weight"] = np.asarray(ie[name]["scale"])
        sd[f"img_emb.proj.{idx}.bias"] = np.asarray(ie[name]["bias"])
    for idx, name in ((1, "fc1"), (3, "fc2")):
        sd[f"img_emb.proj.{idx}.weight"] = np.asarray(ie[name]["kernel"]).T
        sd[f"img_emb.proj.{idx}.bias"] = np.asarray(ie[name]["bias"])
    ca = params["control_adapter"]
    ph, pw = cfg.patch_size[1:]
    sd["control_adapter.conv.weight"] = np.asarray(ca["conv"]["kernel"]).T.reshape(
        cfg.dim, -1, ph, pw)
    sd["control_adapter.conv.bias"] = np.asarray(ca["conv"]["bias"])
    for i, blk in enumerate(ca["res"]):
        for j, name in ((1, "conv1"), (3, "conv2")):
            pre = f"control_adapter.residual_blocks.{i}.block.{j}"
            sd[f"{pre}.weight"] = np.asarray(blk[name]["kernel"]).transpose(3, 2, 0, 1)
            sd[f"{pre}.bias"] = np.asarray(blk[name]["bias"])
    return sd


def _write_dit(d, cfg, seed, extra=False):
    """config.json and the DiT (+ the i2v / SimpleAdapter keys) as one
    safetensors shard in directory d."""
    from safetensors.torch import save_file
    os.makedirs(d, exist_ok=True)
    params = _randomized_dit(cfg, seed)
    sd = _dit_to_torch_layout(params, cfg)
    if extra:
        sd.update(_extras_to_torch_layout(params, cfg))
    save_file(_as_torch(sd, torch.bfloat16),
              os.path.join(d, "diffusion_pytorch_model.safetensors"))
    keys = ("model_type", "patch_size", "in_dim", "dim", "ffn_dim", "freq_dim",
            "text_dim", "out_dim", "num_heads", "num_layers", "geoada_in_dim")
    c = dataclasses.asdict(cfg)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({k: c[k] for k in keys}, f)


@pytest.mark.parametrize("case", ["wan22_pair", "control_adapter", "i2v_config",
                                  "img_emb", "clip"])
def test_extra_contents_load_as_jax(model_dir, tiny_text_and_vae, tmp_path, case):
    """A reference-layout directory with the extras loads through both
    packages' load_versecrafter into the same trees, bit for bit: a Wan2.2
    low_noise_model/ + high_noise_model/ pair (a resident pair), SimpleAdapter
    keys, an i2v config with its img_emb / k_img / v_img keys (then a
    request with y, clip_fea and camera maps, held to JAX's), img_emb keys
    under a t2v config (left unused by both), a models_clip_*.pth tower."""
    from test_torch_clip import _state_dict as clip_state_dict

    from safetensors.torch import save_file

    d = tmp_path / "m"
    for name in ("Wan2.1_VAE.pth", "models_t5_umt5-xxl-enc-bf16.pth"):
        os.makedirs(d, exist_ok=True)
        os.link(os.path.join(model_dir, name), d / name)
    cfg = I2V_DIR_CFG if case == "i2v_config" else DIR_CFG
    if case == "wan22_pair":
        _write_dit(str(d / "low_noise_model"), cfg, 5)
        _write_dit(str(d / "high_noise_model"), cfg, 6)
    else:
        _write_dit(str(d), cfg, 5, extra=case == "i2v_config")
    if case in ("control_adapter", "img_emb"):
        extra = _extras_to_torch_layout(_randomized_dit(I2V_DIR_CFG, 7), I2V_DIR_CFG)
        keep = "control_adapter." if case == "control_adapter" else "img_emb."
        save_file(_as_torch({k: v for k, v in extra.items() if k.startswith(keep)},
                            torch.bfloat16), str(d / "extra.safetensors"))
    if case == "clip":
        torch.save(clip_state_dict("open_clip"),
                   str(d / "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"))
    tp = tconvert.load_versecrafter(str(d), geoada_in_dim=20, dtype=torch.float32,
                                    device="cpu", moe_boundary=0.6)
    jp = jconvert.load_versecrafter(str(d), geoada_in_dim=20, dtype=jnp.float32,
                                    moe_boundary=0.6)
    assert tp.dit_cfg == _port(jp.dit_cfg, tconfig.WanDiTConfig)
    assert tp.moe_boundary == jp.moe_boundary == 0.6
    _assert_same_tree(tp.dit_params, _jax_tree(jp.dit_params))
    assert ("control_adapter" in tp.dit_params) == (case in ("control_adapter",
                                                             "i2v_config"))
    assert ("img_emb" in tp.dit_params) == (case == "i2v_config")
    assert (tp.dit_params_high is None) == (jp.dit_params_high is None) == \
        (case != "wan22_pair")
    if case == "wan22_pair":
        _assert_same_tree(tp.dit_params_high, _jax_tree(jp.dit_params_high))
    assert (tp.clip_cfg is None) == (jp.clip_cfg is None) == (case != "clip")
    if case == "clip":
        assert tp.clip_cfg == jp.clip_cfg
        _assert_same_tree(tp.clip_params, _jax_tree(jp.clip_params))
    if case == "i2v_config":
        jp.attn_impl = "pallas"
        jp.tokenizer = tp.tokenizer
        rng = np.random.default_rng(3)
        kw = dict(
            y=rng.standard_normal((1, 4, 2, 4, 4)).astype(np.float32),
            clip_fea=rng.standard_normal((1, 5, 20)).astype(np.float32),
            camera_video=rng.standard_normal((1, 3, 2, 32, 32)).astype(np.float32),
            geoada_context=rng.standard_normal((1, 20, 2, 4, 4)).astype(np.float32),
            height=8, width=8, num_inference_steps=2, guidance_scale=2.0, shift=3.0,
            seed=2, output_type="latent")
        ref = jp("a car", dtype=jnp.float32, **kw)
        assert _rel_err(tp("a car", dtype=torch.float32, **kw), ref) <= 1e-4


@pytest.mark.parametrize("mode", [(8, False), (8, True)], ids=["int8", "w8a8"])
def test_expert_pair_quantizes_as_it_loads(model_dir, tiny_text_and_vae, tmp_path, mode,
                                           monkeypatch):
    """load_versecrafter(quantize=(bits, int8_compute)) on a Wan2.2
    low_noise_model/ + high_noise_model/ directory quantizes each expert as
    it is read: both trees equal the jitted JAX quantize_tree (+
    tag_int8_compute with dynamic scales) of the JAX package's loaded
    experts, bit for bit. The model server's factory loads the directory
    quantized too, and then serves that mode only."""
    from versecrafter_tpu.utils import quantize as jq
    from versecrafter_tpu_torch.serve import model_server as tserver
    from versecrafter_tpu_torch.utils import quantize as tq

    monkeypatch.setattr(jq, "MIN_SIZE", 1 << 10)
    monkeypatch.setattr(tq, "MIN_SIZE", 1 << 10)
    d = tmp_path / "m"
    os.makedirs(d)
    for name in ("Wan2.1_VAE.pth", "models_t5_umt5-xxl-enc-bf16.pth"):
        os.link(os.path.join(model_dir, name), d / name)
    _write_dit(str(d / "low_noise_model"), DIR_CFG, 5)
    _write_dit(str(d / "high_noise_model"), DIR_CFG, 6)
    tp = tconvert.load_versecrafter(str(d), geoada_in_dim=20, dtype=torch.float32,
                                    device="cpu", quantize=mode)
    jp = jconvert.load_versecrafter(str(d), geoada_in_dim=20, dtype=jnp.float32)
    quant = jax.jit(lambda p: jq.tag_int8_compute(jq.quantize_tree(p)) if mode[1]
                    else jq.quantize_tree(p))
    for name in ("dit_params", "dit_params_high"):
        got = getattr(tp, name)
        assert tq.has_quantized(got)
        _assert_trees_equal(got, _jax_tree(quant(getattr(jp, name))), name)
    served = tserver.default_pipeline_factory(str(d), dtype_name="float32", device="cpu",
                                              quantize=mode)()
    assert tq.has_quantized(served.dit_params) and tq.has_quantized(served.dit_params_high)
    with pytest.raises(ValueError, match="already quantized"):
        tserver.run_loaded_request(served, {"quantize_bits": 4, "int8_compute": mode[1]},
                                   None, None)
    assert served._quantized == mode


def test_checkpoint_round_trip_and_template(tmp_path):
    from versecrafter_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint

    tree = {"a": [torch.ones(2, 3), {"b": torch.zeros(4, dtype=torch.bfloat16)}]}
    path = str(tmp_path / "ck" / "step_000001.pt")
    save_checkpoint(path, tree)
    back = load_checkpoint(path, template=tree)
    _assert_same_tree(back, tree)
    for bad in ({"a": [torch.ones(2, 4), tree["a"][1]]},
                {"a": [torch.ones(2, 3), {"b": torch.zeros(4)}]},
                {"a": [torch.ones(2, 3)]}, {"c": tree["a"]}):
        with pytest.raises(ValueError):
            load_checkpoint(path, template=bad)


def test_train_cli_starts_from_model_name(model_dir, tiny_text_and_vae, tmp_path):
    """--model_name trains the GeoAdapter of the directory's DiT (128
    control channels, so its patch embedding is drawn afresh) and saves the
    trainable tree through core/checkpoint.py."""
    from versecrafter_tpu_torch.cli import train as tcli
    from versecrafter_tpu_torch.core.checkpoint import load_checkpoint

    losses = tcli.main(["--model_name", model_dir, "--device", "cpu", "--synthetic", "1",
                        "--steps", "2", "--sample_size", "16,16", "--video_length", "5",
                        "--output_dir", str(tmp_path)])
    assert len(losses) == 2 and all(np.isfinite(losses))
    pipe = tconvert.load_versecrafter(model_dir, geoada_in_dim=128, device="cpu")
    template = {k: v for k, v in pipe.dit_params.items() if k.startswith("geoada")}
    saved = load_checkpoint(str(tmp_path / "step_000002.pt"), template={"params": template})
    assert saved["params"]["geoada_patch_embedding"]["kernel"].shape == (128 * 4, DIR_CFG.dim)
    assert not torch.equal(saved["params"]["geoada_blocks"][0]["ffn_in"]["kernel"],
                           template["geoada_blocks"][0]["ffn_in"]["kernel"])
