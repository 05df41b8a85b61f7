"""Port parity for the mesh: core/mesh.py's specs and parallel/sharding.py's
rule table against the JAX package's, utils/cache.maybe_init_distributed's
gating, and gloo worlds of the port (tests/torch_mesh.py, one launch per
MeshSpec) against the jitted JAX package on its virtual 8-device mesh: the
DiT forward under (sp=4), (sp=2, tp=2), (dp=2, sp=2) and (fsdp=2, tp=2),
once at 2 heads where sp=4 takes the ring, and the umT5 encode from an
FSDP-sharded tree. fp32, within 1e-4 * max; every rank the same output."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from tests.torch_mesh import flatten, run_world
from versecrafter_tpu.core import mesh as jmesh
from versecrafter_tpu.core.config import T5Config, WanDiTConfig
from versecrafter_tpu.kernels.rope import grid_cos_sin, rope_3d_angles
from versecrafter_tpu.models.t5 import init_t5, t5_encode
from versecrafter_tpu.models.wan_dit import init_wan_dit, wan_dit_forward
from versecrafter_tpu.parallel import sharding as jshd
from versecrafter_tpu_torch.core import mesh as tmesh
from versecrafter_tpu_torch.core.convert import params_from_jax
from versecrafter_tpu_torch.parallel import sharding as tshd
from versecrafter_tpu_torch.utils import cache as tcache

BAR = 1e-4
CFG = WanDiTConfig(in_dim=4, dim=64, ffn_dim=128, freq_dim=32, text_dim=48,
                   out_dim=4, num_heads=8, num_layers=4, text_len=16,
                   geoada_layers=(), geoada_in_dim=8)
# 2 heads: at sp=4 the local head count does not divide, so the ring runs
RING_CFG = dataclasses.replace(CFG, num_heads=2)
# the i2v image keys, img_emb and the SimpleAdapter's camera tokens
I2V_CFG = dataclasses.replace(CFG, model_type="i2v", in_dim=8, add_img_emb=True,
                              img_emb_dim=16, add_control_adapter=True,
                              in_dim_control_adapter=3, downscale_factor_control_adapter=2,
                              control_adapter_residual_blocks=1)
T5_CFG = T5Config(vocab=512, dim=256, dim_attn=256, dim_ffn=256, num_heads=4,
                  num_layers=2, num_buckets=8, text_length=16)


def _rel_err(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(ref).max())


# ---------------------------------------------------------------------------
# specs and rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
def test_mesh_specs_match_jax(n):
    for heads in (2, 5, 12, 24, 40):
        assert tmesh.auto_mesh_spec(n, heads).shape == jmesh.auto_mesh_spec(n, heads).shape
    for u, r, tp in ((n, 1, 1), (1, n, 1), (2, n, 2), (n, 2, 1)):
        t = tmesh.spec_from_degrees(u, r, tp, fsdp=2, dp=3)
        j = jmesh.spec_from_degrees(u, r, tp, fsdp=2, dp=3)
        assert (t.shape, t.size) == (j.shape, j.size)
    assert tmesh.AXES == jmesh.AXES


def test_rule_table_matches_jax():
    """The spec of every leaf of a tiny DiT (GeoAdapter, i2v image keys,
    SimpleAdapter) equals the JAX rule's, its layer axis aside."""
    cfg = dataclasses.replace(CFG, model_type="i2v", in_dim=8, add_img_emb=True,
                              img_emb_dim=16, add_control_adapter=True,
                              in_dim_control_adapter=3,
                              downscale_factor_control_adapter=2,
                              control_adapter_residual_blocks=1)
    jp = init_wan_dit(jax.random.key(0), cfg, jnp.float32)
    jspecs = flatten(jax.tree.map(lambda s: np.array(tuple(s), dtype=object),
                                  jshd.dit_param_pspecs(jp),
                                  is_leaf=lambda s: isinstance(s, P)))
    tspecs = tshd.dit_param_pspecs(params_from_jax(jax.tree.map(np.asarray, jp)))
    checked = 0
    for path, spec in jspecs.items():
        parts = path.split("/")
        stacked = parts[0] in ("blocks", "geoada_blocks")
        want = tuple(spec)[1:] if stacked else tuple(spec)
        leaf = tspecs
        for p in parts[:1] + (["0"] if stacked else []) + parts[1:]:
            leaf = leaf[int(p)] if isinstance(leaf, list) else leaf[p]
        assert tuple(leaf) == tuple(want), path
        checked += 1
    assert checked == len(flatten(jp))
    # and the umT5 FSDP threshold
    assert tshd.T5_SHARD_MIN == jshd.T5_SHARD_MIN


def test_maybe_init_distributed_gating(monkeypatch):
    """No torchrun environment: no-op, False, nothing initialised; the
    world's idempotence is checked inside the gloo launch below."""
    import torch.distributed as dist
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tcache.maybe_init_distributed("cpu") is False
    tcache.wait_all()  # nothing to wait for in one process
    monkeypatch.setenv("RANK", "0")  # a partial environment is not a launch
    assert tcache.maybe_init_distributed("cpu") is False
    assert not dist.is_initialized()
    assert tmesh.world_size() == 1
    with pytest.raises(ValueError, match=r"\(1, 1, 2, 1\) needs 2 ranks, the world has 1"):
        tmesh.make_mesh(tmesh.MeshSpec(sp=2), device="cpu")
    with pytest.raises(ValueError, match="initialised process group"):
        tmesh.make_mesh(tmesh.MeshSpec(), device="cpu")


# ---------------------------------------------------------------------------
# gloo worlds against the virtual mesh
# ---------------------------------------------------------------------------

def _dit_inputs(cfg, b=2, f=2, h=4, w=4, seed=0):
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, init_wan_dit(jax.random.key(seed), cfg, jnp.float32))
    for leaf in (p["head"]["head"], p["geoada_before_proj"], p["geoada_blocks"]["after_proj"]):
        leaf["kernel"] = (rng.standard_normal(leaf["kernel"].shape) * 0.05).astype(np.float32)
    ang = tuple(jnp.asarray(a) for a in rope_3d_angles(cfg.head_dim, max_pos=64))
    cos, sin = (np.asarray(a) for a in grid_cos_sin(ang, f, h, w))
    arrays = {
        "x": rng.standard_normal((b, 4, f, h * 2, w * 2)).astype(np.float32),
        "g": rng.standard_normal((b, cfg.geoada_in_dim, f, h * 2, w * 2)).astype(np.float32),
        "t": np.asarray([300.0, 700.0][:b], np.float32),
        "ctx": rng.standard_normal((b, cfg.text_len, cfg.text_dim)).astype(np.float32),
        "cos": cos, "sin": sin}
    if cfg.model_type == "i2v":
        arrays.update(
            y=rng.standard_normal((b, cfg.in_dim - 4, f, h * 2, w * 2)).astype(np.float32),
            clip_fea=rng.standard_normal((b, 5, cfg.img_emb_dim)).astype(np.float32),
            y_camera=rng.standard_normal((b, 3, f, h * 4, w * 4)).astype(np.float32))
    return p, arrays


def _jax_dit(cfg, spec, p, a):
    mesh = jmesh.make_mesh(spec, devices=jax.devices()[:spec.size])
    sp = jshd.shard_dit_params(jax.tree.map(jnp.asarray, p), mesh)
    with jshd.mesh_context(mesh):
        fwd = jax.jit(lambda q, *args, **kw: wan_dit_forward(q, cfg, *args, **kw,
                                                             attn_impl="sp"))
        x = jax.device_put(a["x"], NamedSharding(mesh, P("dp", None, None, None, None)))
        extras = {k: a[k] for k in ("y", "clip_fea", "y_camera") if k in a}
        return np.asarray(fwd(sp, x, a["t"], a["ctx"], a["cos"], a["sin"], a["g"], **extras))


def _dit_case(name, cfg, spec, seed, **kw):
    p, a = _dit_inputs(cfg, seed=seed)
    arrays = {f"{name}.{k}": v for k, v in a.items()}
    arrays.update(flatten(p, f"{name}.params"))
    case = {"kind": "dit", "name": name, "cfg": dataclasses.asdict(cfg), **kw}
    return case, arrays, _jax_dit(cfg, spec, p, a)


def _t5_case(spec):
    rng = np.random.default_rng(5)
    p = jax.tree.map(np.asarray, init_t5(jax.random.key(3), T5_CFG, jnp.float32))
    ids = rng.integers(0, T5_CFG.vocab, (2, T5_CFG.text_length)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 9:] = 0
    mesh = jmesh.make_mesh(spec, devices=jax.devices()[:spec.size])
    jp = jshd.shard_t5_params(jax.tree.map(jnp.asarray, p), mesh)
    want = np.asarray(jax.jit(lambda q, i, m: t5_encode(q, T5_CFG, i, m))(jp, ids, mask))
    arrays = {"t5.ids": ids, "t5.mask": mask, **flatten(p, "t5.params")}
    case = {"kind": "t5", "name": "t5", "cfg": dataclasses.asdict(T5_CFG)}
    return case, arrays, want


SPECS = [
    jmesh.MeshSpec(sp=4), jmesh.MeshSpec(sp=2, tp=2),
    jmesh.MeshSpec(dp=2, sp=2), jmesh.MeshSpec(fsdp=2, tp=2),
]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "x".join(map(str, s.shape)))
def test_sharded_dit_forward_matches_jax(spec, tmp_path):
    """One launch per MeshSpec: the DiT forward (at sp=4 also the ring's
    dispatch at 2 heads and the FSDP-sharded umT5 encode; at (fsdp=2, tp=2)
    also the i2v image keys, img_emb and the camera tokens) on every rank
    equals the JAX package's sharded forward on the virtual mesh. At
    (fsdp=2, tp=2) the base case runs the block FFN in chunks of 4 of its
    64 rows (FFN_CHUNK_ROWS lowered to 32), as a 720p request does."""
    cases, arrays, want = [], {}, {}
    extra = {(1, 1, 4, 1): [("ring", RING_CFG)], (1, 2, 1, 2): [("i2v", I2V_CFG)]}
    chunk = {"ffn_chunk_rows": 32} if spec.shape == (1, 2, 1, 2) else {}
    for name, cfg in [("dit", CFG)] + extra.get(spec.shape, []):
        c, a, w = _dit_case(name, cfg, spec, seed=len(cases), **(chunk if name == "dit" else {}))
        cases.append(c)
        arrays.update(a)
        want[name] = w
    if spec.sp == 4:
        c, a, w = _t5_case(spec)
        cases += [c, {"kind": "init"}]
        arrays.update(a)
        want["t5"] = w
    outs = run_world(spec.size, {"spec": list(spec.shape), "cases": cases}, arrays, tmp_path)
    for r, out in enumerate(outs):
        for name, w in want.items():
            got = out[name + ".out"]
            assert got.shape == w.shape
            assert _rel_err(got, w) <= BAR, (r, name, _rel_err(got, w))
            np.testing.assert_array_equal(got, outs[0][name + ".out"])
        # 4 base + 2 GeoAdapter blocks: one self-attention each
        assert int(out["dit.ulysses"]) == 6 and int(out["dit.ring"]) == 0
        # this rank's [B/dp, S/sp] rows in one FFN call, or a chunk of them
        local_rows = 2 // spec.dp * 32 // spec.sp
        assert int(out["dit.ffn_rows"]) == (4 if chunk else local_rows)
        if "i2v" in want:
            assert int(out["i2v.ulysses"]) == 6
        if spec.sp == 4:
            assert int(out["ring.ring"]) == 6
            assert int(out["t5.sharded"]) > 0
            assert int(out["init.again"]) == 0 and int(out["init.world"]) == 4
            assert out["init.coord"].tolist() == [0, 0, r, 0]


def test_uneven_sequence_raises_like_jax(tmp_path):
    """S % sp != 0: the JAX package's Ulysses shard_map refuses the shards
    (ValueError); the port's token split refuses them too."""
    spec = jmesh.MeshSpec(sp=2)
    p, a = _dit_inputs(CFG, b=1, f=1, h=3, w=3)  # 9 tokens
    with pytest.raises(ValueError, match="evenly divisible"):
        _jax_dit(CFG, spec, p, a)
    mesh = type("M", (), {"shape": {"dp": 1, "fsdp": 1, "sp": 2, "tp": 1}, "size": 2,
                          "coord": {"dp": 0, "fsdp": 0, "sp": 0, "tp": 0}})()
    import torch
    with tshd.mesh_context(mesh), pytest.raises(ValueError, match="does not divide over sp=2"):
        tshd.constrain_tokens(torch.zeros(1, 9, 4))
