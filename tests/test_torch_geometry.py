"""Port parity for the renderer's pieces (versecrafter_tpu_torch.geometry)
on the CPU: seeded numpy scenes through the jitted JAX functions and their
port counterparts.

Bars:
- host numpy (coords, unprojection, the background carve, the Gaussian
  fit) and the morphology against OpenCV: bit for bit;
- projection: u, v, z within 4 fp32 ulps of their magnitude;
- splat: masks agree on >= 99.9 % of pixels; where both are set and no
  two points tie for the front at the port's pixel, depth within 1e-6
  relative and colour equal on >= 99.9 % of them; tied pixels counted;
- ellipsoids: masks >= 99.9 %, depth within 1e-4 relative (eigh and the
  3x3 sums round differently, and the quadratic's root loses digits where
  a ray grazes the surface: 2.5e-5 at most here), colour within 1e-3 of
  255 where both hit;
- densities within 1e-5 (max-normalised), composited rgb / alpha within
  1e-5; depth, valid and the composite predicates exact;
- the depth range within 1e-6 relative of the JAX package's (whose
  quantile position is fp32), and equal to numpy.quantile in float64
  above 2^24 values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cv2
from versecrafter_tpu.geometry import coords as jcoords
from versecrafter_tpu.geometry import gaussians as jgauss
from versecrafter_tpu.geometry import pointcloud as jpc
from versecrafter_tpu.geometry import rasterize as jras
from versecrafter_tpu.geometry import render as jrender
from versecrafter_tpu.geometry import splat as jsplat
from versecrafter_tpu_torch.geometry import coords as tcoords
from versecrafter_tpu_torch.geometry import gaussians as tgauss
from versecrafter_tpu_torch.geometry import morphology
from versecrafter_tpu_torch.geometry import pointcloud as tpc
from versecrafter_tpu_torch.geometry import rasterize as tras
from versecrafter_tpu_torch.geometry import splat as tsplat
from versecrafter_tpu_torch.geometry.synthetic import synthetic_scene

H, W, T = 48, 64, 6
RADIUS = 0.005 * min(H, W) / 2.0
FOOTPRINT = max(1, int(np.ceil(RADIUS)))


@pytest.fixture(scope="module")
def scene():
    """The seeded scene, its carved background and OpenCV world-to-camera
    trajectory; object 1 is absent in frames 2-3, object 2 is behind the
    camera from frame 2, object 3 leaves the image."""
    s = synthetic_scene(H, W, T, seed=0)
    pts, cols = tpc.build_background(s["image"], s["depth"], s["K"],
                                     s["masks"].any(0).astype(np.uint8))
    s.update(points=pts, colors=cols.astype(np.float32),
             w2c=tcoords.blender_c2w_to_opencv_w2c(s["c2w_blender"]),
             obj_colors=tsplat.TAB20[s["color_idx"]])
    return s


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


# -- host numpy: bit for bit --------------------------------------------------

def test_coords_match_jax():
    rng = np.random.default_rng(0)
    assert np.array_equal(tcoords.CV2BLENDER, jcoords.CV2BLENDER)
    assert np.array_equal(tcoords.BLENDER2CV, jcoords.BLENDER2CV)
    for K in (np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32),
              np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)):
        assert np.array_equal(tcoords.denormalize_intrinsics(K, 640, 480),
                              jcoords.denormalize_intrinsics(K, 640, 480))
    c2w = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    c2w[:, :3, :3] = np.linalg.qr(rng.standard_normal((5, 3, 3)))[0]
    c2w[:, :3, 3] = rng.standard_normal((5, 3))
    w2c = tcoords.blender_c2w_to_opencv_w2c(c2w)
    assert np.array_equal(w2c, jcoords.blender_c2w_to_opencv_w2c(c2w))
    assert np.array_equal(tcoords.opencv_w2c_to_blender_c2w(w2c),
                          jcoords.opencv_w2c_to_blender_c2w(w2c))


@pytest.mark.parametrize("k", range(1, 17))
def test_ellipse_kernel_matches_cv2(k):
    assert np.array_equal(morphology.ellipse_kernel(k),
                          cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k)))


@pytest.mark.parametrize("k", [2, 3, 5, 6, 10, 11])
def test_dilate_erode_match_cv2(k):
    """Sparse and dense random masks with set pixels on every border."""
    rng = np.random.default_rng(k)
    kern = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))
    for density in (0.03, 0.5, 0.9):
        m = (rng.random((37, 53)) < density).astype(np.uint8) * 255
        m[0, :7] = m[-1, -5:] = m[5:9, 0] = m[-9:-2, -1] = 255
        assert np.array_equal(morphology.dilate(m, k), cv2.dilate(m, kern, iterations=1) > 127)
        assert np.array_equal(morphology.erode(m, k), cv2.erode(m, kern, iterations=1) > 127)


def test_unproject_and_background_match_jax(scene):
    s = scene
    w2c = s["w2c"][3].astype(np.float64)
    for args in ((s["depth"], s["K"]), (s["depth"], s["K"], w2c)):
        assert np.array_equal(tpc.unproject_depth(*args), jpc.unproject_depth(*args))
    for masks in (None, s["masks"].any(0).astype(np.uint8)):
        got = tpc.build_background(s["image"], s["depth"], s["K"], masks)
        want = jpc.build_background(s["image"], s["depth"], s["K"], masks)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        if masks is not None:
            assert len(got[0]) < H * W - masks.sum()  # the dilated masks carve more


def test_fit_objects_match_jax(scene):
    s = scene
    masks = {i + 1: (f"box_{i}", s["masks"][i]) for i in range(len(s["masks"]))}
    tiny = np.zeros((H, W), bool)
    tiny[0, :3] = True
    masks[9] = ("tiny", tiny)  # below min_points: left out
    got = tgauss.fit_objects_from_depth(s["depth"], s["K"], masks)
    assert got == jgauss.fit_objects_from_depth(s["depth"], s["K"], masks)
    assert sorted(got) == [1, 2, 3, 4]
    pts = np.random.default_rng(1).standard_normal((50, 3)).astype(np.float32)
    for g, w in zip(tgauss.fit_gaussian(pts), jgauss.fit_gaussian(pts)):
        assert np.array_equal(g, w)
    assert tgauss.fit_gaussian(pts[:2]) == (None, None)


# -- rasterizers: held to the jitted JAX functions ---------------------------

def _jax_batches():
    """The JAX renderer's own per-batch programs (splat, ellipsoids,
    Gaussian projection) over all T frames."""
    return jrender._render_fns(H, W, RADIUS, FOOTPRINT, 2.5, 0.003)


def test_project_points_match_jax(scene):
    s = scene
    proj = jax.jit(jax.vmap(jras.project_points, in_axes=(None, None, 0)))
    want = proj(jnp.asarray(s["points"]), jnp.asarray(s["K"]), jnp.asarray(s["w2c"]))
    got = tras.project_points(_t(s["points"]), _t(s["K"]), _t(s["w2c"]))
    for g, w in zip(got, want):
        g, w = _np(g), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=4 * np.spacing(np.abs(w).max()))


def _splat_ties(scene):
    """[T, H, W] bool: pixels where two in-bounds points share the
    front-most depth bits (the JAX order between them is unspecified)."""
    s = scene
    u, v, z = (_np(x) for x in tras.project_points(_t(s["points"]), _t(s["K"]), _t(s["w2c"])))
    ties = np.zeros((T, H, W), bool)
    for f in range(T):
        ok = (z[f] > 1e-6) & np.isfinite(u[f]) & np.isfinite(v[f])
        ui, vi = np.floor(u[f]), np.floor(v[f])
        ok &= (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        pix = (vi[ok] * W + ui[ok]).astype(np.int64)
        zb = np.maximum(z[f][ok], 1e-9).view(np.int32)
        front = np.full(H * W, np.iinfo(np.int32).max)
        np.minimum.at(front, pix, zb)
        count = np.bincount(pix[zb == front[pix]], minlength=H * W)
        ties[f] = (count > 1).reshape(H, W)
    return ties


def test_splat_points_match_jax(scene):
    s = scene
    splat_batch = _jax_batches()[0]
    jrgb, jdepth, jmask = (np.asarray(x) for x in splat_batch(
        jnp.asarray(s["points"]), jnp.asarray(s["colors"]), jnp.asarray(s["K"]),
        jnp.asarray(s["w2c"])))
    trgb, tdepth, tmask = (_np(x) for x in tras.splat_points(
        _t(s["points"]), _t(s["colors"]), _t(s["K"]), _t(s["w2c"]), H, W,
        radius_px=RADIUS, footprint=FOOTPRINT))
    assert (tmask == jmask).mean() >= 0.999
    ties = _splat_ties(scene)
    both = tmask & jmask & ~ties
    print(f"splat: {ties.sum()} tied pixels of {ties.size}, masks agree on "
          f"{(tmask == jmask).mean():.6f}")
    same_c = (trgb == jrgb).all(-1)[both]
    assert same_c.mean() >= 0.999
    np.testing.assert_allclose(tdepth[both][same_c], jdepth[both][same_c], rtol=1e-6)
    assert (tdepth[~tmask] == 0).all() and (trgb[~tmask] == 0).all()


def test_zbuffer_ties_keep_the_lowest_point_index():
    """Points at one pixel and equal depth: the lowest index wins, in every
    frame of the batch; a nearer point beats them all."""
    K = _t([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]])
    w2c = torch.eye(4).repeat(2, 1, 1)
    w2c[1, 0, 3] = 0.1  # frame 1 shifts the points by 5 pixels
    pts = _t([[0.0, 0.0, 4.0], [0.001, 0.001, 4.0], [0.0, 0.0, 4.0], [0.0, 0.0, 6.0]])
    cols = _t([[10.0, 0, 0], [20.0, 0, 0], [30.0, 0, 0], [40.0, 0, 0]])
    rgb, depth, mask = tras.splat_points(pts, cols, K, w2c, 48, 64)
    assert rgb[0, 24, 32, 0] == 10.0 and rgb[1, 24, 34, 0] == 10.0
    assert depth[0, 24, 32] == 4.0
    pts[3, 2] = 3.0
    rgb, _, _ = tras.splat_points(pts, cols, K, w2c, 48, 64)
    assert rgb[0, 24, 32, 0] == 40.0
    pix = torch.tensor([5, 3, 5, 5, 3])
    z = _t([2.0, 1.0, 1.0, 1.0, 1.0])
    win_pix, win = tras.zbuffer_winners(pix, z)
    assert win_pix.tolist() == [3, 5] and win.tolist() == [1, 2]


def test_raster_ellipsoids_match_jax(scene):
    s = scene
    ell_batch = _jax_batches()[1]
    args = (s["means"], s["covs"], s["obj_colors"], s["present"], s["K"], s["w2c"])
    jrgb, jdepth, jmask = (np.asarray(x) for x in ell_batch(*(jnp.asarray(a) for a in args)))
    trgb, tdepth, tmask = (_np(x) for x in tras.raster_ellipsoids(
        _t(s["means"]), _t(s["covs"]), _t(s["obj_colors"]), _t(s["present"], torch.bool),
        _t(s["K"]), _t(s["w2c"]), H, W))
    assert jmask.any(axis=(1, 2)).sum() >= 4  # objects are on screen
    assert (tmask == jmask).mean() >= 0.999
    both = tmask & jmask
    np.testing.assert_allclose(tdepth[both], jdepth[both], rtol=1e-4)
    np.testing.assert_allclose(trgb[both], jrgb[both], rtol=0, atol=1e-3 * 255)
    absent = tras.raster_ellipsoids(
        _t(s["means"][:1]), _t(s["covs"][:1]), _t(s["obj_colors"]),
        torch.zeros(1, 4, dtype=torch.bool), _t(s["K"]), _t(s["w2c"][:1]), H, W)
    assert not absent[2].any()


def test_gaussian_density_and_projection_match_jax(scene):
    s = scene
    jd = jax.jit(jax.vmap(jsplat.gaussian_density_maps, in_axes=(0, 0, 0, None, 0, None, None)),
                 static_argnums=(5, 6))
    jdens, jz, jvalid = (np.asarray(x) for x in jd(
        jnp.asarray(s["means"]), jnp.asarray(s["covs"]), jnp.asarray(s["present"]),
        jnp.asarray(s["K"]), jnp.asarray(s["w2c"]), H, W))
    tdens, tz, tvalid = (_np(x) for x in tsplat.gaussian_density_maps(
        _t(s["means"]), _t(s["covs"]), _t(s["present"], torch.bool), _t(s["K"]),
        _t(s["w2c"]), H, W))
    assert np.array_equal(tvalid, jvalid)
    assert not tvalid[2:4, 1].any() and not tvalid[3:, 2].any()  # absent, behind
    np.testing.assert_allclose(tz, jz, rtol=1e-6)
    np.testing.assert_allclose(tdens, jdens, rtol=0, atol=1e-5)

    proj_batch = _jax_batches()[2]
    args = (s["means"], s["covs"], s["obj_colors"], s["present"], s["K"], s["w2c"])
    jrgb, jalpha = (np.asarray(x) for x in proj_batch(*(jnp.asarray(a) for a in args)))
    trgb, talpha = (_np(x) for x in tsplat.composite_gaussian_projections(
        _t(s["means"]), _t(s["covs"]), _t(s["obj_colors"]), _t(s["present"], torch.bool),
        _t(s["K"]), _t(s["w2c"]), H, W))
    assert jalpha.max() > 0.5
    np.testing.assert_allclose(trgb, jrgb, rtol=0, atol=1e-5)
    np.testing.assert_allclose(talpha, jalpha, rtol=0, atol=1e-5)


def test_composites_and_grayscale_match_jax():
    """On the same inputs the predicates are exact and the grayscale equal."""
    rng = np.random.default_rng(3)
    bgd = np.where(rng.random((3, 8, 9)) < 0.2, 0, rng.uniform(1, 9, (3, 8, 9))).astype(np.float32)
    fgd = np.where(rng.random((3, 8, 9)) < 0.5, 0, rng.uniform(1, 9, (3, 8, 9))).astype(np.float32)
    fgd[0, 0, :3] = bgd[0, 0, :3]  # equal depths: the epsilon test decides
    bgm, fgm = bgd > 0, fgd > 0
    bgr = rng.uniform(0, 255, (3, 8, 9, 3)).astype(np.float32)
    fgr = rng.uniform(0, 255, (3, 8, 9, 3)).astype(np.float32)
    jm = jax.jit(jras.merge_masks)(bgd, fgd, bgm, fgm)
    assert np.array_equal(_np(tras.merge_masks(_t(bgd), _t(fgd), _t(bgm, torch.bool),
                                               _t(fgm, torch.bool))), np.asarray(jm))
    jrgb, jdep = jax.jit(jras.composite_by_depth)(bgr, bgd, fgr, fgd, fgm)
    trgb, tdep = tras.composite_by_depth(_t(bgr), _t(bgd), _t(fgr), _t(fgd), _t(fgm, torch.bool))
    assert np.array_equal(_np(trgb), np.asarray(jrgb)) and np.array_equal(_np(tdep), np.asarray(jdep))
    gray = jax.jit(jras.depth_to_grayscale)
    for lo, hi in ((1.5, 7.0), (0.0, 1.0), (2.0, 2.0)):
        want = np.asarray(gray(bgd, jnp.float32(lo), jnp.float32(hi)))
        got = _np(tras.depth_to_grayscale(_t(bgd), lo, hi))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


# -- the depth range -----------------------------------------------------------

def test_depth_range_matches_jax():
    rng = np.random.default_rng(4)
    parts = [np.where(rng.random(5000) < 0.3, 0, rng.lognormal(1, 0.7, 5000)).astype(np.float32)
             for _ in range(3)]
    flat = np.concatenate(parts)
    want = jrender._device_depth_range([jnp.where(jnp.asarray(p) > 0, jnp.asarray(p), jnp.nan)
                                        for p in parts])
    got = tras.positive_quantiles(_t(flat))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    pos = flat[flat > 0].astype(np.float64)
    assert got == (np.quantile(pos, 0.001), np.quantile(pos, 0.99))
    assert tras.positive_quantiles(torch.zeros(10)) == (0.0, 1.0)
    assert jrender._device_depth_range([jnp.full(10, jnp.nan)]) == (0.0, 1.0)


def test_depth_range_above_2_24_values():
    """torch.quantile refuses more than 2^24 elements; the port's range
    takes one sort of the positive values and equals numpy.quantile
    (linear, float64) exactly."""
    n = (1 << 24) + (1 << 18)
    rng = np.random.default_rng(5)
    vals = rng.uniform(0.5, 30.0, n).astype(np.float32)
    vals[rng.random(n) < 0.005] = 0.0
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(_t(vals), 0.5)
    got = tras.positive_quantiles(_t(vals))
    pos = vals[vals > 0].astype(np.float64)
    assert pos.size > 1 << 24
    assert got == (np.quantile(pos, 0.001), np.quantile(pos, 0.99))
