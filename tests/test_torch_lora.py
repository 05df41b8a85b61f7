"""Port parity for LoRA (utils/lora.py and its users): merge_lora /
unmerge_lora bit for bit against the JAX functions (eager, as the JAX
pipeline calls them; dotted and
PEFT names; underscore-only names, which the JAX package drops for the
attention modules and the port merges), init_lora within the fp32-normal
gap, apply_lora_tree, lora_to_torch_sd, one keyed LoRA train step against
the jitted JAX make_lora_train_step, the LoRA step's attention launches,
the LoRA train CLI with its export, and the pipeline's merge (CPU)."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_serving import workdir  # noqa: F401 (fixture)
from test_torch_train_step import CFG, LR, TCFG, _flat, _np, _setup
from versecrafter_tpu.core.config import WanDiTConfig
from versecrafter_tpu.models.wan_dit import init_wan_dit
from versecrafter_tpu.parallel import train_step as jts
from versecrafter_tpu.utils import lora as jl
from versecrafter_tpu_torch.cli import train as tcli
from versecrafter_tpu_torch.core.checkpoint import load_checkpoint
from versecrafter_tpu_torch.core.convert import load_torch_state_dict, params_from_jax
from versecrafter_tpu_torch.kernels import flash_attention as tfa
from versecrafter_tpu_torch.kernels import flash_attention_bwd as tfab
from versecrafter_tpu_torch.parallel import train_step as tts
from versecrafter_tpu_torch.serve import model_server as tserve
from versecrafter_tpu_torch.utils import lora as tl
from versecrafter_tpu_torch.utils import prng
from tests.jax_prng import threefry_default  # noqa: F401

SMALL = WanDiTConfig(in_dim=4, dim=48, ffn_dim=80, freq_dim=32, text_dim=24, out_dim=4,
                     num_heads=2, num_layers=4, text_len=8, geoada_layers=(),
                     geoada_in_dim=8)


def _params(dtype, seed=0):
    return jax.tree.map(np.asarray, init_wan_dit(jax.random.key(seed), SMALL, dtype))


def _assert_equal(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_equal(a, b, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and torch.equal(got, want), path


def _lora_sd(names, rank=3, seed=0):
    """{module: (down [r, in], up [out, r])} pairs of SMALL's kernels as a
    state dict with the given naming: name(module, slot) -> key."""
    rng = np.random.default_rng(seed)
    dims = {"self_attn.q": (48, 48), "cross_attn.v": (48, 48), "ffn.0": (48, 80),
            "ffn.2": (80, 48)}
    sd = {}
    for group, layer in (("blocks", 0), ("blocks", 3), ("geoada_blocks", 1)):
        for mod, (k, n) in dims.items():
            full = f"{group}.{layer}.{mod}"
            sd[names(full, "down")] = torch.from_numpy(
                rng.standard_normal((rank, k)).astype(np.float32))
            sd[names(full, "up")] = torch.from_numpy(
                rng.standard_normal((n, rank)).astype(np.float32) * 0.1)
    return sd


NAMINGS = {
    "dotted": lambda m, s: f"{m}.lora_{s}.weight",
    "peft": lambda m, s: f"transformer.{m}.lora_{'A' if s == 'down' else 'B'}.weight",
    "peft_default": lambda m, s: f"diffusion_model.{m}.lora_{'A' if s == 'down' else 'B'}"
                                 ".default.weight",
}


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("naming", list(NAMINGS))
def test_merge_unmerge_match_jax(naming, dtype):
    params = _params(dtype)
    sd = _lora_sd(NAMINGS[naming])
    ref = jl.merge_lora(jax.tree.map(jnp.asarray, params), sd, 0.55)
    got = tl.merge_lora(params_from_jax(params), sd, 0.55)
    _assert_equal(got, params_from_jax(jax.tree.map(np.asarray, ref)))
    # the merge moved the named kernels and nothing else
    base = params_from_jax(params)
    assert not torch.equal(got["geoada_blocks"][1]["cross_attn"]["v"]["kernel"],
                           base["geoada_blocks"][1]["cross_attn"]["v"]["kernel"])
    assert torch.equal(got["blocks"][1]["ffn_in"]["kernel"], base["blocks"][1]["ffn_in"]["kernel"])
    back_ref = jl.unmerge_lora(ref, sd, 0.55)
    back = tl.unmerge_lora(got, sd, 0.55)
    _assert_equal(back, params_from_jax(jax.tree.map(np.asarray, back_ref)))


def test_underscore_names_merge_in_the_port_and_drop_in_jax(caplog):
    """kohya-style names: the JAX package makes `blocks.0.self.attn.q` of
    `lora_unet_blocks_0_self_attn_q` and merges only the FFN pairs; the
    port maps the module names back and merges every pair, the result
    equal to the JAX merge of the same pairs under dotted names. A pair that
    names no kernel is listed in a warning."""
    params = _params(jnp.bfloat16)
    kohya = _lora_sd(lambda m, s: f"lora_unet_{m.replace('.', '_')}.lora_{s}.weight")
    dotted = _lora_sd(NAMINGS["dotted"])
    assert sorted(jl._collect_pairs(kohya))[:2] == ["blocks.0.cross.attn.v", "blocks.0.ffn.0"]
    assert sorted(tl._collect_pairs(kohya)) == sorted(tl._collect_pairs(dotted))
    jparams = jax.tree.map(jnp.asarray, params)
    jax_kohya = jax.tree.map(np.asarray, jl.merge_lora(jparams, kohya, 0.55))
    base = params_from_jax(params)
    dropped = params_from_jax(jax_kohya)
    assert torch.equal(dropped["blocks"][0]["self_attn"]["q"]["kernel"],
                       base["blocks"][0]["self_attn"]["q"]["kernel"])
    assert not torch.equal(dropped["blocks"][0]["ffn_in"]["kernel"],
                           base["blocks"][0]["ffn_in"]["kernel"])
    want = params_from_jax(jax.tree.map(np.asarray, jl.merge_lora(jparams, dotted, 0.55)))
    with caplog.at_level(logging.WARNING, logger="versecrafter_tpu_torch.utils.lora"):
        got = tl.merge_lora(base, {**kohya, "lora_unet_blocks_0_norm3.lora_down.weight":
                                   torch.ones(3, 48),
                                   "lora_unet_blocks_0_norm3.lora_up.weight": torch.ones(48, 3),
                                   "blocks.9.ffn.0.lora_down.weight": torch.ones(3, 48),
                                   "blocks.9.ffn.0.lora_up.weight": torch.ones(80, 3)}, 0.55)
    _assert_equal(got, want)
    assert "blocks.0.norm3" in caplog.text and "blocks.9.ffn.0" in caplog.text
    assert "2 LoRA pair(s)" in caplog.text


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_init_lora_matches_jax(dtype):
    params = _params(dtype)
    ref = jl.init_lora(params, 4, jax.random.key(7), groups=("blocks", "geoada_blocks"))
    got = tl.init_lora(params_from_jax(params), 4, prng.key(7),
                       groups=("blocks", "geoada_blocks"))
    assert sorted(got) == sorted(ref) == ["blocks", "geoada_blocks"]
    for g in ref:
        assert sorted(got[g]) == sorted(ref[g]) == sorted("/".join(t) for t in tl.LORA_TARGETS)
        for t, f in ref[g].items():
            down_r = np.asarray(f["down"], np.float32)
            down = got[g][t]["down"]
            assert down.dtype == getattr(torch, jnp.dtype(dtype).name)
            assert tuple(down.shape) == down_r.shape and down.shape[0] == len(params[g]
                                                                               ["modulation"])
            # fp32: the fp32 normal's gap (ROADMAP 3); bf16: one rounding of it
            tol = 1e-5 if dtype == jnp.float32 else 2.0 ** -8
            assert (np.abs(down.float().numpy() - down_r) <= tol * np.abs(down_r) + 1e-12).all()
            assert not got[g][t]["up"].any() and tuple(got[g][t]["up"].shape) == np.shape(f["up"])


def _random_factors(params, rank=4, seed=3):
    """JAX-layout factors with non-zero up (numpy fp32)."""
    rng = np.random.default_rng(seed)
    out = {}
    for g in ("blocks", "geoada_blocks"):
        out[g] = {}
        for t in tl.LORA_TARGETS:
            node = params[g]
            for k in t:
                node = node[k]
            L, K, N = node["kernel"].shape
            out[g]["/".join(t)] = {
                "down": (rng.standard_normal((L, K, rank)) / np.sqrt(K)).astype(np.float32),
                "up": (rng.standard_normal((L, rank, N)) * 0.05).astype(np.float32)}
    return out


def _factors_to_torch(f):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), f)


def test_apply_lora_tree_and_export_match_jax():
    params = _params(jnp.float32)
    factors = _random_factors(params)
    ref = jax.tree.map(np.asarray, jax.jit(lambda p, f: jl.apply_lora_tree(p, f, 0.5))(
        params, factors))
    got = tl.apply_lora_tree(params_from_jax(params), _factors_to_torch(factors), 0.5)
    want = params_from_jax(ref)
    for k, r in _flat(want).items():
        np.testing.assert_allclose(_np(_flat(got)[k]), _np(r), rtol=1e-6, atol=1e-7, err_msg=k)
    assert not torch.equal(got["blocks"][2]["ffn_out"]["kernel"],
                           params_from_jax(params)["blocks"][2]["ffn_out"]["kernel"])
    sd_ref = jl.lora_to_torch_sd(factors)
    sd = tl.lora_to_torch_sd(_factors_to_torch(factors))
    assert sorted(sd) == sorted(sd_ref)
    for k, v in sd_ref.items():
        assert sd[k].dtype == torch.float32 and np.array_equal(sd[k].numpy(), v), k


def test_lora_train_step_matches_jax():
    """One keyed LoRA step, the same factors (non-zero up) and key in both
    packages: the loss within 1e-5, the factors' gradients within 1e-3 *
    max (test_torch_train_step.py's bars), the base untouched."""
    params, (x0, ctx, cos, sin, geo) = _setup(seed=6)
    factors = _random_factors(params, rank=2)
    key = jax.random.key(11)
    opt = optax.adamw(LR, weight_decay=1e-2)
    step = jax.jit(jts.make_lora_train_step(CFG, opt, 0.5))
    _, _, loss = step(factors, params, opt.init(factors), key, x0, ctx, cos, sin, geo)
    grads = jax.jit(jax.grad(lambda f: jts.flow_matching_loss(
        jl.apply_lora_tree(params, f, 0.5), CFG, key, x0, ctx, cos, sin,
        geoada_context=geo)))(factors)
    k_sig, k_eps = jax.random.split(key)
    sig = np.asarray(jax.random.uniform(k_sig, (1,), jnp.float32))
    noise = np.asarray(jax.random.normal(k_eps, x0.shape, jnp.float32))

    base = params_from_jax(params)
    before = {k: v.clone() for k, v in _flat(base).items()}
    tf = _factors_to_torch(factors)
    tstep = tts.make_lora_train_step(TCFG, tts.make_optimizer(tf, LR, 1e-2), 0.5)
    # keyed: the port draws sig and noise from the same threefry key
    tloss = tstep(tf, base, *(torch.from_numpy(a) for a in (x0, ctx, cos, sin, geo)),
                  key=prng.key(11))
    tsig, tnoise = tts.draw_noise(prng.key(11), torch.from_numpy(x0))
    np.testing.assert_array_equal(tsig.numpy(), sig)
    assert (np.abs(tnoise.numpy() - noise) <= 1e-5 * np.abs(noise)).all()
    assert abs(float(tloss) - float(loss)) <= 1e-5 * abs(float(loss))
    got = {k: v.grad for k, v in _flat(tf).items()}
    for k, r in _flat(jax.tree.map(np.asarray, grads)).items():
        assert got[k] is not None, k
        assert np.abs(_np(got[k]) - r).max() <= 1e-3 * np.abs(r).max() + 1e-12, k
    for k, t in _flat(base).items():
        assert torch.equal(t, before[k]) and t.grad is None, k


def test_lora_attention_launch_count_per_step(monkeypatch):
    """Every block trains under LoRA: 4 stats forwards, 2 dQ and 2 dK/dV a
    block, no fused kernel (counted at the calls that launch on the card)."""
    counts = dict.fromkeys(tts.attention_launches_per_step(TCFG, lora=True), 0)
    real_fused, real_fwd, real_bwd = tfa.fused_attention, tfa._fa_forward, tfab.fa_backward_plain

    def fused(*a, **kw):
        rope = len(a) > 7 and a[7] is not None
        counts["fused_rope_rms_attention" if rope else "fused_rms_cross_attention"] += 1
        return real_fused(*a, **kw)

    def fwd(*a, **kw):
        counts["flash_attention"] += 1
        return real_fwd(*a, **kw)

    def bwd(*a, **kw):
        counts["fa_backward_dq"] += bool(a[-2])
        counts["fa_backward_dkv"] += bool(a[-1])
        return real_bwd(*a, **kw)

    monkeypatch.setattr(tfa, "fused_attention", fused)
    monkeypatch.setattr(tfa, "_fa_forward", fwd)
    monkeypatch.setattr(tfab, "fa_backward_plain", bwd)
    params, (x0, ctx, cos, sin, geo) = _setup(seed=5)
    base = params_from_jax(params)
    lora = tl.init_lora(base, 2, prng.key(0), groups=("blocks", "geoada_blocks"))
    step = tts.make_lora_train_step(TCFG, tts.make_optimizer(lora), 1.0)
    step(lora, base, *(torch.from_numpy(a) for a in (x0, ctx, cos, sin, geo)), key=prng.key(0))
    assert counts == tts.attention_launches_per_step(TCFG, lora=True)
    assert counts == {"fused_rope_rms_attention": 0, "fused_rms_cross_attention": 0,
                      "flash_attention": 24, "fa_backward_dq": 12, "fa_backward_dkv": 12}


def test_lora_cli_trains_and_exports(tmp_path):
    """--lora_rank on the tiny model: finite losses, the factors saved as
    the checkpoint (the JAX layout's directory, read back against the
    trained factors) and exported as safetensors that read back equal and
    merge into the base tree through the generate path's reader."""
    out = tcli.run(tcli.parse_args([
        "--tiny", "--synthetic", "4", "--steps", "3", "--device", "cpu",
        "--sample_size", "64,64", "--video_length", "9", "--lora_rank", "4",
        "--lora_alpha", "8", "--output_dir", str(tmp_path)]))
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    saved = load_checkpoint(os.path.join(tmp_path, "step_000003"),
                            template={"params": out["train"]})["params"]
    assert sorted(saved) == ["blocks", "geoada_blocks"]
    _assert_equal(saved, jax.tree.map(lambda t: t.detach(), out["train"]))
    assert any(f["up"].abs().max() > 0 for g in saved.values() for f in g.values())
    sd = load_torch_state_dict(os.path.join(tmp_path, "step_000003_lora.safetensors"))
    want = tl.lora_to_torch_sd(saved)
    assert sorted(sd) == sorted(want) and len(want) == 2 * 10 * (4 + 2)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    # merged at the trained scale (alpha / rank = 2): the effective kernels
    merged = tl.merge_lora(out["params"], sd, 2.0)
    eff = tl.apply_lora_tree(out["params"], saved, 2.0)
    for g in ("blocks", "geoada_blocks"):
        for i in range(len(eff[g])):
            a, b = merged[g][i]["ffn_out"]["kernel"], eff[g][i]["ffn_out"]["kernel"]
            assert (a - b).abs().max() <= 1e-6 * b.abs().max(), (g, i)


def test_pipeline_merge_and_unmerge():
    pipe = tserve.default_pipeline_factory(scale="tiny", device="cpu", seed=0)()
    base = pipe.dit_params
    gen = torch.Generator().manual_seed(0)
    sd = {"blocks.1.ffn.0.lora_down.weight": torch.randn(2, 128, generator=gen) * 0.05,
          "blocks.1.ffn.0.lora_up.weight": torch.randn(256, 2, generator=gen) * 0.05}
    pipe.merge_lora(sd, 0.55)
    k0 = base["blocks"][1]["ffn_in"]["kernel"]
    k1 = pipe.dit_params["blocks"][1]["ffn_in"]["kernel"]
    up, down = (sd[f"blocks.1.ffn.0.lora_{s}.weight"].numpy() for s in ("up", "down"))
    delta = torch.from_numpy(np.ascontiguousarray(0.55 * (up @ down).T)).to(k0.dtype)
    assert torch.equal(k1, k0 + delta)
    pipe.unmerge_lora(sd, 0.55)
    k2 = pipe.dit_params["blocks"][1]["ffn_in"]["kernel"]
    assert torch.equal(k2, k1 - delta)
    # bf16: back within the two roundings of the merge and the unmerge
    assert (k2.float() - k0.float()).abs().max() <= 2.0 ** -8 * k0.float().abs().max()


def test_generate_cli_merges_lora_then_quantizes(workdir, monkeypatch, tmp_path):
    """--lora_path is merged at --lora_weight first, then the quantize flags
    apply (W4A8 here), then --int8_attention, as in the JAX CLI."""
    from versecrafter_tpu_torch.cli import inference as tinf
    from versecrafter_tpu_torch.core.convert import save_safetensors
    from versecrafter_tpu_torch.models import wan_dit as twan
    from versecrafter_tpu_torch.sampling import pipeline as tpipe

    path = str(tmp_path / "tiny_lora.safetensors")
    gen = torch.Generator().manual_seed(1)
    save_safetensors(path, {"blocks.0.ffn.0.lora_down.weight": torch.randn(2, 128, generator=gen),
                            "blocks.0.ffn.0.lora_up.weight": torch.randn(256, 2, generator=gen)})
    calls = []
    real_merge, real_quant = tpipe.VerseCrafterPipeline.merge_lora, \
        tpipe.VerseCrafterPipeline.quantize_weights
    monkeypatch.setattr(tpipe.VerseCrafterPipeline, "merge_lora", lambda self, sd, w: (
        calls.append(("merge", sorted(sd), w, twan.INT8_QK_SCORE)), real_merge(self, sd, w)))
    monkeypatch.setattr(tpipe.VerseCrafterPipeline, "quantize_weights", lambda self, **kw: (
        calls.append(("quantize", kw, twan.INT8_QK_SCORE)), real_quant(self, **kw)))
    old = twan.INT8_QK_SCORE
    try:
        twan.INT8_QK_SCORE = False
        out = tinf.main(["--offline_smoke", "--smoke_scale", "tiny", "--device", "cpu",
                         "--rendering_maps_path", str(workdir / "maps"), "--prompt", "x",
                         "--input_image_path", "", "--sample_size", "16,16",
                         "--video_length", "5", "--num_inference_steps", "2",
                         "--lora_path", path, "--lora_weight", "0.3", "--quantize_int8",
                         "--int8_compute", "--quantize_bits", "4", "--int8_attention",
                         "--save_path", str(tmp_path / "cli")])
        assert os.path.isfile(out) and twan.INT8_QK_SCORE is True
    finally:
        twan.INT8_QK_SCORE = old
    assert calls == [("merge", ["blocks.0.ffn.0.lora_down.weight",
                                "blocks.0.ffn.0.lora_up.weight"], 0.3, False),
                     ("quantize", {"int8_compute": True, "bits": 4}, False)]
