"""Port parity for the quantized DiT, W8A8 calibration and the TeaCache
record pass under a mesh: gloo worlds of the port (tests/torch_mesh.py, one
launch per MeshSpec) against the jitted JAX package on its virtual mesh,
fp32, within 1e-4 * max, every rank the same numbers.

- fault F4: a W8A8 tree keeps its quantized leaves whole under fsdp, dp
  and sp (shard_dit_params used to split their codes over fsdp), and
  quantizing a sharded pipeline (quantize_weights after set_mesh) gives
  the same shards as quantizing first;
- tensor parallelism at tp = 2 and (sp = 2, tp = 2) in the five modes
  (int8 and grouped int4 weight-only, W8A8 dynamic and calibrated, W4A8),
  the codes and scales cut per tp rank; one dp / sp world with per-tensor
  dynamic scales;
- calibrate=True at (dp = 2, sp = 2) and tp = 2 (the statistics, maxima
  over every rank), its fitted scales driving the calibrated tp = 2 mode;
- record_teacache_stats through the sharded pipeline at (dp = 2, sp = 2)
  and tp = 2, the record state row-subsampled (80 tokens, stride 16: the
  second sp rank's positions start 8 tokens into its slice).

In the W8A8 / W4A8 modes an activation within an fp32 ulp of a rounding
boundary takes the other code when the two packages' activations differ in
their last bit (ROADMAP §3), so the JAX package records its codes on
its mesh and each port product takes them (torch_mesh_worker._match_codes);
at most 1 in 10,000 of the port's own codes may differ from them, each
within 1e-3 of a boundary. The MIN_SIZE of both packages is lowered for the
tiny models, as the JAX package's own tests lower it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from test_torch_mesh import _dit_inputs
from test_torch_parallel import trees  # noqa: F401 (fixture)
from test_torch_pipeline import DIT_CFG, T5_CFG, VAE_CFG
from tests.jax_prng import threefry_default  # noqa: F401
from tests.torch_mesh import flatten, run_world
from versecrafter_tpu.core import mesh as jmesh
from versecrafter_tpu.core.config import WanDiTConfig
from versecrafter_tpu.models.wan_dit import wan_dit_forward
from versecrafter_tpu.parallel import sharding as jshd
from versecrafter_tpu.sampling import pipeline as jpipe
from versecrafter_tpu.sampling import teacache as jtc
from versecrafter_tpu.utils import quantize as jq
from versecrafter_tpu_torch.utils.tokenizer import HashTokenizer
from jax.sharding import NamedSharding, PartitionSpec as P

BAR = 1e-4
SMALL = 1 << 10
# dim 128 (4 heads of 32), ffn 384: ffn_out's K = 384 has three 128-row int4
# groups, and at tp = 2 each shard's 192 rows straddle the middle one
QCFG = WanDiTConfig(in_dim=4, dim=128, ffn_dim=384, freq_dim=32, text_dim=48,
                    out_dim=4, num_heads=4, num_layers=2, text_len=16,
                    geoada_layers=(), geoada_in_dim=8)
MODES = {"int8": (8, False), "int4": (4, False), "w8a8_dynamic": (8, True),
         "w8a8_static": (8, True), "w4a8": (4, True)}
# the record request: 5 x 8 x 8 latents (80 tokens), 3 steps
REC_STEPS, REC_SHIFT = 3, 3.0


def _rel_err(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(ref).max())


def _jax_mesh(spec):
    return jmesh.make_mesh(spec, devices=jax.devices()[:spec.size])


class _JaxQuant:
    """The JAX package's quantize flags for the duration of a block, and its
    W8A8 products' activation codes recorded (in any order: the port
    matches them by content) through an unordered debug callback, which a
    program over the mesh allows."""

    def __init__(self, row_scales=True):
        self.row_scales, self.records = row_scales, []

    def __enter__(self):
        self.saved = (jq.MIN_SIZE, jq.ROW_ACT_SCALES, jq._int8_dot_rows)
        jq.MIN_SIZE, jq.ROW_ACT_SCALES = SMALL, self.row_scales
        real = self.saved[2]

        def rows(leaf, x, a_global):
            a = a_global if a_global is not None else jnp.maximum(
                jnp.max(jnp.abs(x), axis=-1, keepdims=True).astype(jnp.float32), 1e-8) / 127.0
            xq = jnp.clip(jnp.round(x.astype(jnp.float32) / a), -127, 127).astype(jnp.int8)
            jax.debug.callback(lambda c: self.records.append(np.asarray(c)), xq,
                               ordered=False)
            return real(leaf, x, a_global)
        jq._int8_dot_rows = rows
        return self

    def __exit__(self, *exc):
        jax.effects_barrier()
        jq.MIN_SIZE, jq.ROW_ACT_SCALES, jq._int8_dot_rows = self.saved


def _jax_forward(params, a, spec, calibrate=False):
    """The JAX DiT forward (GeoAdapter scale 0.7) on the virtual mesh of
    `spec`, the tree placed by its shard_dit_params."""
    mesh = _jax_mesh(spec)
    sp = jshd.shard_dit_params(jax.tree.map(jnp.asarray, params), mesh)
    with jshd.mesh_context(mesh):
        fwd = jax.jit(lambda q, *args: wan_dit_forward(
            q, QCFG, *args[:5], geoada_context=args[5], geoada_scale=0.7, attn_impl="sp",
            calibrate=calibrate))
        x = jax.device_put(a["x"], NamedSharding(mesh, P("dp", None, None, None, None)))
        res = fwd(sp, x, a["t"], a["ctx"], a["cos"], a["sin"], a["g"])
    return jax.tree.map(np.asarray, res)


def _jax_quantized(params, bits, compute, scales):
    gs = 0 if bits == 4 and compute else None

    def quant(p):
        p = jq.quantize_tree(p, bits, gs)
        return jq.tag_int8_compute(p, scales) if compute else p
    return jax.tree.map(np.asarray, jax.jit(quant)(params))


def _qdit(name, src, mode, spec, params, a, scales=None, row_scales=True, **kw):
    """(case, arrays, JAX output, JAX codes) of one quantized forward."""
    bits, compute = MODES[mode]
    with _JaxQuant(row_scales) as jrec:
        want = _jax_forward(_jax_quantized(params, bits, compute, scales), a, spec)
    arrays = {f"{name}.codes/{i}": c for i, c in enumerate(jrec.records)}
    case = {"kind": "qdit", "name": name, "params": src, "cfg": dataclasses.asdict(QCFG),
            "bits": bits, "compute": compute, "min_size": SMALL,
            "row_act_scales": row_scales, **kw}
    return case, arrays, want, jrec.records


def _inputs(src, seed):
    params, a = _dit_inputs(QCFG, seed=seed)
    arrays = {f"{src}.{k}": v for k, v in a.items()}
    arrays.update(flatten(params, f"{src}.params"))
    return params, a, arrays


def _calib(name, src, spec, params, a):
    with _JaxQuant():
        out, stats = _jax_forward(params, a, spec, calibrate=True)
    case = {"kind": "calib", "name": name, "params": src, "cfg": dataclasses.asdict(QCFG),
            "min_size": SMALL}
    return case, out, stats


def _record(name, spec, jp, rng):
    """(case, arrays, JAX (rel_e0, rel_residual), JAX latents) of a record
    pass through the pipeline of the `trees` fixture on the virtual mesh."""
    controls = [rng.random((1, 3, 9, 16, 16)).astype(np.float32) for _ in range(2)]
    mask = np.zeros((1, 1, 9, 16, 16), np.float32)
    mask[..., 4:12, 4:12] = 1.0
    noise = rng.standard_normal((1, 4, 5, 8, 8)).astype(np.float32)
    jm = jpipe.VerseCrafterPipeline(
        dit_params=jp.dit_params, dit_cfg=DIT_CFG, vae_params=jp.vae_params,
        vae_cfg=VAE_CFG, t5_params=jp.t5_params, t5_cfg=T5_CFG, scheduler_name="unipc",
        tokenizer=HashTokenizer(T5_CFG.vocab), mesh=_jax_mesh(spec))
    saved = jtc.TEA_RECORD_SUBSAMPLE_ROWS
    jtc.TEA_RECORD_SUBSAMPLE_ROWS = 0
    try:
        ref = jm.record_teacache_stats(
            "a car drives left", negative_prompt="static", control_videos=controls,
            mask_video=mask, latents=noise, height=16, width=16, num_frames=9,
            num_inference_steps=REC_STEPS, guidance_scale=2.0, shift=REC_SHIFT,
            dtype=jnp.float32)
    finally:
        jtc.TEA_RECORD_SUBSAMPLE_ROWS = saved
    arrays = {f"{name}.control0": controls[0], f"{name}.control1": controls[1],
              f"{name}.mask": mask, f"{name}.noise": noise}
    case = {"kind": "record", "name": name, "trees": "rec", "subsample_rows": 0,
            "hw": [16, 16], "frames": 9, "steps": REC_STEPS, "shift": REC_SHIFT,
            "dit_cfg": dataclasses.asdict(DIT_CFG), "vae_cfg": dataclasses.asdict(VAE_CFG),
            "t5_cfg": dataclasses.asdict(T5_CFG)}
    return case, arrays, tuple(np.asarray(r) for r in ref), np.asarray(jm.last_record_latents)


def _tree_arrays(jp):
    out = {}
    for name, tree in (("dit", jp.dit_params), ("vae", jp.vae_params), ("t5", jp.t5_params)):
        out.update(flatten(jax.tree.map(np.asarray, tree), f"rec.{name}"))
    return out


def _check_forward(outs, name, want, records=None):
    for out in outs:
        got = out[name + ".out"]
        assert got.shape == want.shape
        assert _rel_err(got, want) <= BAR, (name, _rel_err(got, want))
        np.testing.assert_array_equal(got, outs[0][name + ".out"])
        if records:  # every product took the JAX codes; few of its own differed
            assert int(out[name + ".products"]) == len(records), name
            codes = sum(r.size for r in records)
            assert int(out[name + ".flips"]) <= codes // 10_000, (name, int(out[name + ".flips"]))
            assert float(out[name + ".flip_dist"]) < 1e-3, name


def _check_stats(outs, name, stats):
    for out in outs:
        for grp, sites in stats.items():
            for site, v in sites.items():
                got = out[f"{name}.stats/{grp}/{site}"]
                assert got.shape == np.asarray(v).shape, (grp, site)
                np.testing.assert_allclose(got, v, rtol=1e-5, err_msg=f"{grp}/{site}")
                np.testing.assert_array_equal(got, outs[0][f"{name}.stats/{grp}/{site}"])


def _check_record(outs, name, ref, latents):
    for out in outs:
        for got, want in zip((out[name + ".rel_e0"], out[name + ".rel_res"]), ref):
            assert got.shape == want.shape == (REC_STEPS - 1, 2)
            np.testing.assert_allclose(got, want, rtol=1e-4)
        np.testing.assert_array_equal(out[name + ".rel_res"], outs[0][name + ".rel_res"])
        assert _rel_err(out[name + ".latents"], latents) <= BAR


# ---------------------------------------------------------------------------
# F4: quantized leaves under dp, fsdp and sp
# ---------------------------------------------------------------------------

def test_w8a8_under_fsdp_keeps_quantized_leaves_whole(tmp_path):
    """fsdp = 2: the W8A8 forward equals the JAX package's, the block's
    codes stay whole on both ranks, and quantize_weights on the sharded
    fp32 tree gives the shards of quantize-then-shard. On the parent commit
    shard_dit_params cut the codes over fsdp ([64, 384] of ffn_in's
    [128, 384]) and the forward failed."""
    spec = jmesh.MeshSpec(fsdp=2)
    params, a, arrays = _inputs("q", 0)
    case, codes, want, records = _qdit("w8", "q", "w8a8_dynamic", spec, params, a,
                                       orders=True)
    outs = run_world(2, {"spec": list(spec.shape), "cases": [case]}, {**arrays, **codes},
                     tmp_path)
    _check_forward(outs, "w8", want, records)
    for out in outs:
        assert out["w8.shape/ffn_in"].tolist() == [128, 384]
        assert out["w8.shape/ffn_out"].tolist() == [384, 128]
        assert bool(out["w8.orders_equal"])


def test_quantized_dp_sp_world_matches_jax(trees, tmp_path):  # noqa: F811
    """One (dp = 2, sp = 2) world: W8A8 with per-row and with per-tensor
    dynamic scales (the per-tensor absmax reduced with MAX over the ranks'
    tokens), both orders of quantize and shard; calibrate=True; and the
    TeaCache record pass through the sharded pipeline."""
    spec = jmesh.MeshSpec(dp=2, sp=2)
    params, a, arrays = _inputs("q", 1)
    cases, want = [], {}
    for name, row in (("row", True), ("tensor", False)):
        c, codes, w, rec = _qdit(name, "q", "w8a8_dynamic", spec, params, a,
                                 row_scales=row, orders=row)
        cases.append(c)
        arrays.update(codes)
        want[name] = (w, rec)
    c, cal_out, cal_stats = _calib("cal", "q", spec, params, a)
    cases.append(c)
    c, rec_arrays, ref, latents = _record("rec", spec, trees, np.random.default_rng(7))
    cases.append(c)
    arrays.update(rec_arrays)
    arrays.update(_tree_arrays(trees))
    outs = run_world(4, {"spec": list(spec.shape), "cases": cases}, arrays, tmp_path)
    for name, (w, rec) in want.items():
        _check_forward(outs, name, w, rec)
    assert bool(outs[0]["row.orders_equal"])
    assert _rel_err(outs[0]["row.out"], outs[0]["tensor.out"]) > BAR  # the modes differ
    for out in outs:
        assert out["row.shape/ffn_in"].tolist() == [128, 384]
        assert _rel_err(out["cal.out"], cal_out) <= BAR
    _check_stats(outs, "cal", cal_stats)
    _check_record(outs, "rec", ref, latents)
