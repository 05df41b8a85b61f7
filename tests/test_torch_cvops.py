"""utils/cvops.py against OpenCV (CPU), bit for bit: gaussian_blur against
cv2.GaussianBlur on random uint8 images; connected_components_with_stats
against cv2.connectedComponentsWithStats on random masks (labels in
OpenCV's order, stats, centroids) at 8- and 4-connectivity; kmeans against
cv2.kmeans on the saliency segmenter's own features (compactness, labels,
centers), with both generators seeded alike, over consecutive calls, in a
fresh thread, and with duplicate points that force the empty-cluster rule."""

import threading

import cv2
import numpy as np
import pytest

from versecrafter_tpu_torch.utils import cvops

CRITERIA = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 10, 1.0)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# ---------------------------------------------------------------- blur

BLUR_SIZES = [(3, 3), (2, 2), (1, 7), (8, 1), (5, 9), (17, 23), (61, 83)]


@pytest.mark.parametrize("ksize", [3, 5, 9])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("h,w", BLUR_SIZES)
def test_gaussian_blur_matches_opencv(h, w, channels, ksize):
    """Images narrower or shorter than the kernel included."""
    img = _u8((h, w) if channels == 1 else (h, w, channels), h * w + ksize)
    np.testing.assert_array_equal(cvops.gaussian_blur(img, ksize),
                                  cv2.GaussianBlur(img, (ksize, ksize), 0))


def test_gaussian_blur_sigma_and_shapes():
    """sigma given, a non-square kernel, kernels above OpenCV's tables, four
    channels, the segmenter's size."""
    img = _u8((37, 53, 3), 1)
    for ksize, sigma in [((7, 5), 0.8), ((11, 11), 0), ((15, 3), 0), ((5, 5), 2.5),
                         ((9, 9), 1.3)]:
        np.testing.assert_array_equal(cvops.gaussian_blur(img, ksize, sigma),
                                      cv2.GaussianBlur(img, ksize, sigma))
    img = _u8((40, 30, 4), 2)
    np.testing.assert_array_equal(cvops.gaussian_blur(img, 9), cv2.GaussianBlur(img, (9, 9), 0))
    img = _u8((480, 832, 3), 3)
    np.testing.assert_array_equal(cvops.gaussian_blur(img, (9, 9)),
                                  cv2.GaussianBlur(img, (9, 9), 0))
    with pytest.raises(ValueError, match="odd"):
        cvops.gaussian_blur(img, 4)
    with pytest.raises(ValueError, match="uint8"):
        cvops.gaussian_blur(img.astype(np.float32), 3)


# ------------------------------------------------- connected components

def _ccl_equal(mask, connectivity):
    n, labels, stats, cents = cv2.connectedComponentsWithStats(mask, connectivity=connectivity)
    got = cvops.connected_components_with_stats(mask, connectivity)
    assert got[0] == n
    np.testing.assert_array_equal(got[1], labels)
    np.testing.assert_array_equal(got[2], stats)
    np.testing.assert_array_equal(got[3], cents)
    assert got[1].dtype == labels.dtype and got[2].dtype == stats.dtype
    return n


@pytest.mark.parametrize("connectivity", [8, 4])
@pytest.mark.parametrize("density", [0.15, 0.5, 0.8])
@pytest.mark.parametrize("h,w", [(1, 1), (1, 13), (13, 1), (2, 2), (7, 5), (31, 47),
                                 (120, 208)])
def test_connected_components_match_opencv(h, w, density, connectivity):
    rng = np.random.default_rng(h * 1000 + w)
    mask = (rng.random((h, w)) < density).astype(np.uint8)
    _ccl_equal(mask, connectivity)


def test_connected_components_label_order():
    """At 8-connectivity a component whose first 2x2 block comes first
    (pixel (1, 0), block row 0) takes label 1 before one at (0, 10); at
    4-connectivity raster order decides. Masks of one value, a full mask
    (an empty background) and a mask at the segmenter's size."""
    mask = np.zeros((4, 16), np.uint8)
    mask[1, 0] = mask[0, 10] = 1
    assert _ccl_equal(mask, 8) == 3
    assert cvops.connected_components_with_stats(mask)[1][1, 0] == 1
    assert cvops.connected_components_with_stats(mask, 4)[1][1, 0] == 2
    _ccl_equal(mask, 4)
    for m in (np.zeros((5, 6), np.uint8), np.ones((5, 6), np.uint8),
              np.full((3, 3), 7, np.uint8)):
        _ccl_equal(m, 8)
        _ccl_equal(m, 4)
    rng = np.random.default_rng(4)
    blobs = cv2.GaussianBlur(rng.integers(0, 256, (480, 832), dtype=np.uint8), (0, 0), 6)
    _ccl_equal((blobs > 128).astype(np.uint8), 8)


# ---------------------------------------------------------------- kmeans

def _features(h, w, seed, depth):
    """The saliency segmenter's features of a blobby seeded image."""
    rng = np.random.default_rng(seed)
    img = cv2.resize(rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8), (w, h))
    feats = [cvops.gaussian_blur(img, 9).reshape(-1, 3).astype(np.float32) / 255.0,
             (np.mgrid[0:h, 0:w].transpose(1, 2, 0).reshape(-1, 2) / [h, w]).astype(np.float32)
             * 0.5]
    if depth:
        d = rng.random((h, w)).astype(np.float32)
        feats.append(((d - d.min()) / (d.max() - d.min())).reshape(-1, 1))
    return np.concatenate(feats, 1)


def _km_equal(got, want):
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("k", range(3, 9))
@pytest.mark.parametrize("depth", [False, True])
def test_kmeans_matches_opencv(depth, k):
    """5 or 6 dims (with depth); two consecutive calls from one seed: the
    generator advances alike."""
    feats = _features(48, 80, k, depth)
    cv2.setRNGSeed(k)
    cvops.set_rng_seed(k)
    for _ in range(2):
        want = cv2.kmeans(feats, k, None, CRITERIA, 3, cv2.KMEANS_PP_CENTERS)
        got = cvops.kmeans(feats, k, CRITERIA, 3, cvops.KMEANS_PP_CENTERS)
        _km_equal(got, want)
    assert got[1].shape == (48 * 80, 1) and got[2].shape == (k, feats.shape[1])


def test_kmeans_generator_state():
    """A fresh thread's first call equals OpenCV's fresh thread's and a
    call after setRNGSeed(0); setRNGSeed(-1) gives another draw; a tighter
    criterion (more iterations) and 2 attempts match too."""
    feats = _features(40, 64, 1, True)
    out = {}

    def first(key, fn):
        out[key] = fn()
    for key, fn in (("cv", lambda: cv2.kmeans(feats, 5, None, CRITERIA, 3,
                                              cv2.KMEANS_PP_CENTERS)),
                    ("port", lambda: (cvops.rng_state(), cvops.kmeans(feats, 5, CRITERIA, 3)))):
        t = threading.Thread(target=first, args=(key, fn))
        t.start()
        t.join()
    start, got = out["port"]
    assert start == 0xFFFFFFFF
    _km_equal(got, out["cv"])
    cvops.set_rng_seed(0)
    assert cvops.rng_state() == 0xFFFFFFFF
    _km_equal(cvops.kmeans(feats, 5, CRITERIA, 3), out["cv"])
    assert cvops.rng_state() != 0xFFFFFFFF
    cv2.setRNGSeed(-1)
    cvops.set_rng_seed(-1)
    other = cv2.kmeans(feats, 5, None, CRITERIA, 3, cv2.KMEANS_PP_CENTERS)
    _km_equal(cvops.kmeans(feats, 5, CRITERIA, 3), other)
    assert not np.array_equal(other[1], out["cv"][1])
    _km_equal(cvops.kmeans(feats, 4, CRITERIA, 2),
              cv2.kmeans(feats, 4, None, CRITERIA, 2, cv2.KMEANS_PP_CENTERS))
    tight = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-4)
    _km_equal(cvops.kmeans(feats, 6, tight, 3), cv2.kmeans(feats, 6, None, tight, 3,
                                                           cv2.KMEANS_PP_CENTERS))


@pytest.mark.parametrize("k", [5, 8])
def test_kmeans_empty_cluster_rule(k):
    """Four distinct points repeated: more clusters than points empty some
    clusters, and OpenCV's rule moves the farthest point of the largest
    cluster into each; every label then appears."""
    rng = np.random.default_rng(k)
    feats = rng.random((4, 6)).astype(np.float32)[rng.integers(0, 4, 600)]
    cv2.setRNGSeed(3)
    cvops.set_rng_seed(3)
    want = cv2.kmeans(feats, k, None, CRITERIA, 3, cv2.KMEANS_PP_CENTERS)
    got = cvops.kmeans(feats, k, CRITERIA, 3)
    _km_equal(got, want)
    assert sorted(set(got[1].ravel())) == list(range(k))


def test_kmeans_guards():
    with pytest.raises(ValueError, match="clusters"):
        cvops.kmeans(np.zeros((3, 2), np.float32), 4, CRITERIA, 1)
    with pytest.raises(ValueError, match="flags"):
        cvops.kmeans(np.zeros((3, 2), np.float32), 2, CRITERIA, 1, cv2.KMEANS_RANDOM_CENTERS)
