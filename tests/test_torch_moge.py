"""Port parity of the depth half of preprocessing (CPU, fp32): the generic
ViT, DINOv2 (HF and facebookresearch layouts), the MoGe head, moge_forward /
infer, the jax.image.resize "bilinear" weights, the host-side focal / shift
recovery and views, checkpoints across packages, mesh export and the MoGe
CLI, each against the JAX package's function (jitted where it is a
network) on the same numpy inputs. Forwards are held within 1e-4 * max|ref|;
converters, params_from_jax, recover_focal_shift and the file writers bit
for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from test_moge_convert import _torch_state_dict
from versecrafter_tpu.perception import dinov2 as jd
from versecrafter_tpu.perception import moge as jm
from versecrafter_tpu.perception import moge_head as jh
from versecrafter_tpu.perception import vit as jv
from versecrafter_tpu.utils import mesh_export as jme
from versecrafter_tpu_torch.core.convert import params_from_jax
from versecrafter_tpu_torch.perception import _ops
from versecrafter_tpu_torch.perception import dinov2 as td
from versecrafter_tpu_torch.perception import moge as tm
from versecrafter_tpu_torch.perception import moge_head as th
from versecrafter_tpu_torch.perception import vit as tv
from versecrafter_tpu_torch.utils import mesh_export as tme

TINY_VIT = dict(patch=14, dim=32, depth=2, heads=2)
BAR = 1e-4


def np_tree(tree):
    """A JAX tree with numpy leaves (python scalars and strings kept)."""
    return jax.tree.map(lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


def assert_tree_equal(got, ref, path=""):
    """Same keys, list lengths, scalars, and every leaf the same dtype,
    shape and bits."""
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            assert_tree_equal(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            assert_tree_equal(a, b, f"{path}/{i}")
    elif isinstance(ref, (int, float, str)):
        assert got == ref, path
    elif isinstance(ref, torch.Tensor):
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        assert torch.equal(got, ref), path
    else:
        ref = np.asarray(ref)
        assert got.dtype == getattr(torch, ref.dtype.name), (path, got.dtype, ref.dtype)
        assert tuple(got.shape) == ref.shape, path
        assert np.array_equal(got.float().numpy(), ref.astype(np.float32)), path


def rel_err(got, ref):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def randomized_head(params, seed):
    """The head's zero-init biases made random, so every leaf reaches the
    output."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
                        if k == "bias" and not isinstance(v, dict) else walk(v))
                    for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t
    return {**params, "head": walk(params["head"])}


def test_constants_match_jax():
    assert (tm.VIT_L, tm.HEAD_L, tm.HEAD_TINY, tm.HEAD_TAPS) == \
        (jm.VIT_L, jm.HEAD_L, jm.HEAD_TINY, jm.HEAD_TAPS)
    assert (td.VIT_L14, td.TEST_TINY) == (jd.VIT_L14, jd.TEST_TINY)


@pytest.mark.parametrize("n_in,n_out", [(35, 280), (60, 480), (37, 20), (16, 5), (7, 9)],
                         ids=["up8", "up8_wide", "down_pos_grid", "down3", "up_odd"])
def test_linear_resize_matches_jax_image_resize(n_in, n_out):
    """jax.image.resize "bilinear": the upsample of moge_forward's head
    output and a position grid shrunk below its size (antialiased), at the
    edges; the weight rows of an upsample are F.interpolate's."""
    x = np.random.default_rng(n_in).standard_normal((1, n_in, n_in + 3, 2)).astype(np.float32)
    ref = jax.jit(lambda a: jax.image.resize(a, (1, n_out, n_out + 2, 2), "bilinear"))(x)
    got = _ops.resize_bilinear(torch.from_numpy(x), n_out, n_out + 2)
    assert rel_err(got, ref) < 1e-5
    eye = jax.image.resize(jnp.eye(n_in, dtype=jnp.float32), (n_out, n_in), "bilinear")
    np.testing.assert_allclose(_ops.linear_resize_weights(n_in, n_out), np.asarray(eye),
                               atol=1e-6)
    if n_out > n_in:
        fi = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                                             (n_out, n_out + 2), mode="bilinear",
                                             align_corners=False).permute(0, 2, 3, 1)
        assert rel_err(got, fi.numpy()) < 1e-5


def test_bicubic_weights_match_jax():
    for n_out, n_in in [(5, 16), (40, 16), (37, 37), (1, 3)]:
        np.testing.assert_array_equal(td._bicubic_weights(n_out, n_in),
                                      jd._bicubic_weights(n_out, n_in))


def test_vit_forward_with_taps():
    jp = jv.init_vit(jax.random.key(1), patch=14, dim=32, depth=3, heads=2)
    x = np.random.default_rng(0).random((2, 42, 56, 3)).astype(np.float32)
    ref, ref_taps = jax.jit(lambda p, a: jv.vit_forward(p, a, patch=14, heads=2,
                                                        out_layers=(0, 2)))(jp, x)
    tp = params_from_jax(np_tree(jp))
    assert isinstance(tp["blocks"], list) and len(tp["blocks"]) == 3
    got, taps = tv.vit_forward(tp, torch.from_numpy(x), patch=14, heads=2, out_layers=(0, 2))
    assert rel_err(got, ref) < BAR
    for a, b in zip(taps, ref_taps):
        assert rel_err(a, b) < BAR


@pytest.fixture(scope="module")
def hf_dinov2():
    cfg = transformers.Dinov2Config(
        hidden_size=32, num_hidden_layers=3, num_attention_heads=2, intermediate_size=64,
        patch_size=14, image_size=70, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, layerscale_value=0.5)
    torch.manual_seed(0)
    return transformers.Dinov2Model(cfg).eval()


def test_dinov2_converter_and_forward(hf_dinov2):
    """convert_hf_dinov2 bit for bit; the forward with taps (normed and not)
    at a grid other than the checkpoint's, so the bicubic resize runs."""
    cfg = dict(jd.TEST_TINY, depth=3)
    jp = jd.convert_hf_dinov2(hf_dinov2.state_dict(), cfg)
    tp = td.convert_hf_dinov2(hf_dinov2.state_dict(), cfg)
    assert_tree_equal(tp, np_tree(jp))
    assert_tree_equal(params_from_jax(np_tree(jp)), np_tree(jp))
    px = np.random.default_rng(1).standard_normal((1, 3, 56, 84)).astype(np.float32)
    for norm_taps in (False, True):
        ref, rt = jax.jit(lambda p, a: jd.dinov2_forward(p, cfg, a, out_layers=(0, 2),
                                                         norm_taps=norm_taps))(jp, px)
        got, gt = td.dinov2_forward(tp, cfg, torch.from_numpy(px), out_layers=(0, 2),
                                    norm_taps=norm_taps)
        assert rel_err(got, ref) < BAR
        assert all(rel_err(a, b) < BAR for a, b in zip(gt, rt))


def test_moge_checkpoint_converters():
    """convert_moge_checkpoint (convert_fb_dinov2 + convert_head) on the
    public MoGe layout bit for bit, with its report."""
    _, _, ckpt = _torch_state_dict()
    jp, jrep = jm.convert_moge_checkpoint(ckpt)
    tp, trep = tm.convert_moge_checkpoint(ckpt)
    assert trep == jrep
    assert_tree_equal(tp, np_tree(jp))
    sd = ckpt["model"]
    assert_tree_equal(td.convert_fb_dinov2(sd, prefix="backbone.", dtype=torch.bfloat16),
                      np_tree(jd.convert_fb_dinov2(sd, prefix="backbone.", dtype=jnp.bfloat16)))
    assert_tree_equal(th.convert_head(sd), np_tree(jh.convert_head(sd)))


def test_head_forward():
    jp = randomized_head({"head": jh.init_head(jax.random.key(2), dim_in=32,
                                               **jm.HEAD_TINY)}, 3)["head"]
    rng = np.random.default_rng(4)
    feats = [rng.standard_normal((2, 3 * 5, 32)).astype(np.float32) for _ in range(4)]
    ref = jax.jit(lambda p, f: jh.head_forward(p, f, 3, 5))(jp, feats)
    got = th.head_forward(params_from_jax(np_tree(jp)), [torch.from_numpy(f) for f in feats], 3, 5)
    assert got.shape == (2, 24, 40, 4) and rel_err(got, ref) < BAR
    np.testing.assert_array_equal(th.normalized_view_plane_uv(7, 11),
                                  jh.normalized_view_plane_uv(7, 11))


@pytest.mark.parametrize("backbone", ["vit", "dinov2"])
def test_moge_forward_and_infer(backbone):
    """moge_forward at 70x98 (5x7 patches, the head's output upsampled by
    14/8), then infer's points, depth and intrinsics, the mask equal."""
    jp = randomized_head(jm.init_moge(jax.random.key(0), vit_kwargs=TINY_VIT, backbone=backbone), 5)
    st = jp["_static"]
    tp = params_from_jax(np_tree(jp))
    assert tp["_static"] == {**st, "taps": list(st["taps"])}
    ref = np_tree(jp)
    assert_tree_equal(tp["head"], ref["head"])
    if backbone == "vit":  # the stacked blocks, one list entry a block
        assert_tree_equal(tp["vit"]["blocks"], [jax.tree.map(lambda a: a[i], ref["vit"]["blocks"])
                                                for i in range(TINY_VIT["depth"])])
    else:
        assert_tree_equal(tp["vit"], ref["vit"])
    img = np.random.default_rng(1).random((70, 98, 3)).astype(np.float32)
    net = {k: v for k, v in jp.items() if k != "_static"}
    pj, mj = jax.jit(lambda p, x: jm.moge_forward({**p, "_static": st}, x))(net, img[None])
    pt, mt = tm.moge_forward(tp, torch.from_numpy(img)[None])
    assert rel_err(pt, pj) < BAR and rel_err(mt, mj) < BAR
    oj, ot = jm.infer(jp, img), tm.infer(tp, img)
    for k in ("points", "depth", "intrinsics"):
        assert rel_err(torch.from_numpy(ot[k]), oj[k]) < BAR, k
    assert (ot["mask"] == oj["mask"]).mean() > 0.999


def test_host_helpers_bit_for_bit():
    """recover_focal_shift (with and without a mask, above the 4,096-point
    subsample), normalized_intrinsics and the views, on the same arrays."""
    rng = np.random.default_rng(7)
    h, w = 80, 120
    yy, xx = np.mgrid[0:h, 0:w]
    z = 2.0 + rng.random((h, w))
    pts = np.stack([(xx + 0.5 - w / 2) / w * z * 1.3, (yy + 0.5 - h / 2) / w * z * 1.3,
                    z - 0.7], -1).astype(np.float32)
    mask = rng.random((h, w)) > 0.2
    for m in (None, mask):
        assert tm.recover_focal_shift(pts, m) == jm.recover_focal_shift(pts, m)
    np.testing.assert_array_equal(tm.normalized_intrinsics(0.83, h, w),
                                  jm.normalized_intrinsics(0.83, h, w))
    depth = z.astype(np.float32)
    depth[3, 4], depth[5, 6] = np.inf, -1.0
    np.testing.assert_array_equal(tm.replace_infs_with_max(depth), jm.replace_infs_with_max(depth))
    np.testing.assert_array_equal(tm.grayscale_depth(depth), jm.grayscale_depth(depth))
    np.testing.assert_array_equal(tm.colorize_depth(depth), jm.colorize_depth(depth))


def test_checkpoints_cross_packages(tmp_path):
    """A JAX-written npz loads in the port over a tiny template (the stacked
    blocks sliced) and the port's npz loads in the JAX package, the same
    names and arrays."""
    jp = randomized_head(jm.init_moge(jax.random.key(3), vit_kwargs=TINY_VIT), 6)
    jm.save_checkpoint(jp, str(tmp_path / "jax.npz"))
    template = tm.init_moge(torch.Generator().manual_seed(9), vit_kwargs=TINY_VIT)
    got = tm.load_checkpoint(str(tmp_path / "jax.npz"), template=template)
    assert_tree_equal({k: v for k, v in got.items() if k != "_static"},
                      params_from_jax(np_tree({k: v for k, v in jp.items() if k != "_static"})))
    assert got["_static"] == {**jp["_static"], "taps": tuple(jp["_static"]["taps"])}
    tm.save_checkpoint(got, str(tmp_path / "port.npz"))
    a, b = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(a.files) == sorted(b.files)
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name])


@pytest.fixture(scope="module")
def mesh_case():
    rng = np.random.default_rng(5)
    h, w = 24, 32
    pts = rng.standard_normal((h, w, 3)).astype(np.float32)
    pts[..., 2] = 2 + np.abs(pts[..., 2])
    depth = pts[..., 2].copy()
    depth[8:12, 10:20] *= 3  # a discontinuity
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    return {"points": pts, "depth": depth, "mask": rng.random((h, w)) > 0.1}, img


def test_mesh_export_files_equal(mesh_case, tmp_path):
    out, img = mesh_case
    np.testing.assert_array_equal(tme.depth_edge_mask(out["depth"], 0.04),
                                  jme.depth_edge_mask(out["depth"], 0.04))
    np.testing.assert_array_equal(tme.depth_edge_mask(out["depth"], 0.01, kernel_size=5),
                                  jme.depth_edge_mask(out["depth"], 0.01, kernel_size=5))
    jpaths = jm.export_mesh(out, img, str(tmp_path / "jax"))
    tpaths = tm.export_mesh(out, img, str(tmp_path / "port"))
    assert sorted(jpaths) == sorted(tpaths) == ["glb", "ply"]
    for k in jpaths:
        with open(jpaths[k], "rb") as a, open(tpaths[k], "rb") as b:
            assert a.read() == b.read(), k


def test_moge_cli_outputs(tmp_path, monkeypatch):
    """The port's CLI on a written 40x50 png (edge-padded to 42x56) with a
    JAX-written tiny checkpoint, --device cpu: every file, the depth and
    intrinsics as JAX's infer gives them on the same padded image."""
    import cv2

    from versecrafter_tpu_torch.cli import moge_infer

    jp = randomized_head(jm.init_moge(jax.random.key(4), vit_kwargs=TINY_VIT), 8)
    ckpt = str(tmp_path / "tiny.npz")
    jm.save_checkpoint(jp, ckpt)
    monkeypatch.setattr(tm, "VIT_L", dict(tm.VIT_L, **TINY_VIT))
    monkeypatch.setattr(tm, "HEAD_L", tm.HEAD_TINY)
    img = (np.random.default_rng(2).random((40, 50, 3)) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "in.png"), img[..., ::-1])
    od = str(tmp_path / "out")
    moge_infer.main(["-i", str(tmp_path / "in.png"), "-o", od, "--pretrained", ckpt,
                     "--device", "cpu"])
    for name in ("depth_intrinsics.npz", "depth_gray.png", "depth_vis.png", "mesh.glb",
                 "pointcloud.ply"):
        assert os.path.exists(os.path.join(od, name)), name
    padded = np.pad(img, ((0, 2), (0, 6), (0, 0)), mode="edge")
    want = jm.infer(jp, padded.astype(np.float32) / 255.0)
    got = np.load(os.path.join(od, "depth_intrinsics.npz"))
    np.testing.assert_allclose(got["depth"].astype(np.float32),
                               jm.replace_infs_with_max(want["depth"][:40, :50]).astype(np.float16),
                               rtol=2e-3)
    np.testing.assert_allclose(got["intrinsic"].astype(np.float32),
                               want["intrinsics"].astype(np.float16), rtol=2e-3)
    assert me_vertex_count(os.path.join(od, "mesh.glb")) > 0


def me_vertex_count(path):
    return tme.load_glb_meta(path)["accessors"][0]["count"]


def test_moge_cli_defaults_to_cuda():
    from versecrafter_tpu_torch.cli import moge_infer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        moge_infer.main(["-i", "nothing.png"])
