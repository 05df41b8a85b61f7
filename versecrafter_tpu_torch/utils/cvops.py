"""The saliency segmenter's OpenCV operations, in the port's own host code
(csrc/host/cvops.cpp), so the default segmenter needs no OpenCV.

- `gaussian_blur`: cv2.GaussianBlur on uint8 images with 1 to 4 channels.
- `kmeans`: cv2.kmeans on float32 [N, D] with k-means++ seeding.
- `connected_components_with_stats`: cv2.connectedComponentsWithStats.

Each gives OpenCV 5.0.0's result bit for bit (tests/test_torch_cvops.py).
What the port reproduces on purpose, as probed against that version:

- The blur is OpenCV's fixed-point 8-bit path: each 1-D kernel (OpenCV's
  tables at ksize 3, 5, 7 with sigma 0, else the sampled Gaussian with
  sigma = 0.3 * ((k - 1) / 2 - 1) + 0.8 when sigma is 0) is quantised to
  integers summing to 256 with error diffusion; the horizontal pass sums in
  integers, the vertical pass rounds the 16-fraction-bit sum half up.
  Borders reflect without repeating the edge (BORDER_REFLECT_101); a
  single row or column drops that axis of the kernel.
- kmeans draws from cv::RNG, a multiply-with-carry generator whose state
  OpenCV keeps per thread, starting at 0xffffffff in every thread and
  advancing with each call. The port keeps the state in a
  `threading.local` with the same start, so an unseeded call in a fresh
  thread gives what OpenCV's first call in a fresh thread gives, and a
  second call gives what OpenCV's second gives. `set_rng_seed` is
  cv2.setRNGSeed (0 maps to 0xffffffff, a negative seed to its 64-bit
  two's complement).
- Connected components at 8-connectivity are numbered by each component's
  first 2x2 block in (row pair, column pair) order, as OpenCV's block-based
  default (Spaghetti) numbers them: a component at pixel (1, 0) comes
  before one at (0, 10). At 4-connectivity they are numbered in raster
  order of their first pixel. The background is label 0 and has stats too.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from versecrafter_tpu_torch.kernels import _build

_P = ctypes.c_void_p
TERM_CRITERIA_COUNT = TERM_CRITERIA_MAX_ITER = 1
TERM_CRITERIA_EPS = 2
KMEANS_PP_CENTERS = 2
_RNG_START = 0xFFFFFFFF
_rng = threading.local()


def _lib():
    lib = _build.load_host("cvops")
    if not getattr(lib, "_typed", False):
        lib.cv_last_error.restype = ctypes.c_char_p
        lib.cv_gaussian_blur.argtypes = [_P, _P] + [ctypes.c_int] * 5 + [ctypes.c_double]
        lib.cv_kmeans.argtypes = ([_P] + [ctypes.c_int] * 5 + [ctypes.c_double, ctypes.c_int]
                                  + [_P] * 4)
        lib.cv_connected_components.argtypes = [_P] + [ctypes.c_int] * 3 + [_P] * 3 + [
            ctypes.c_int]
        lib._typed = True
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P)


def set_rng_seed(seed: int) -> None:
    """cv2.setRNGSeed: this thread's generator state becomes `seed` as a
    64-bit integer (0 gives the start state)."""
    _rng.state = (int(seed) & 0xFFFFFFFFFFFFFFFF) or _RNG_START


def rng_state() -> int:
    """This thread's generator state (OpenCV's start state in a new thread)."""
    return getattr(_rng, "state", _RNG_START)


def gaussian_blur(img: np.ndarray, ksize, sigma: float = 0.0) -> np.ndarray:
    """cv2.GaussianBlur(img, ksize, sigma) for uint8 [H, W] or [H, W, C]
    (C <= 4); ksize an odd int or (width, height) of odd ints."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3
                                                          and not 1 <= img.shape[2] <= 4):
        raise ValueError(f"gaussian_blur takes uint8 [H, W] or [H, W, C<=4], not "
                         f"{img.dtype} {img.shape}")
    kw, kh = (ksize, ksize) if isinstance(ksize, int) else (int(ksize[0]), int(ksize[1]))
    if kw <= 0 or kh <= 0 or kw % 2 == 0 or kh % 2 == 0:
        raise ValueError(f"gaussian_blur: ksize {ksize} must be odd and positive")
    h, w = img.shape[:2]
    cn = img.shape[2] if img.ndim == 3 else 1
    out = np.empty_like(img)
    if _lib().cv_gaussian_blur(_ptr(img), _ptr(out), h, w, cn, kw, kh, float(sigma)) != 0:
        raise ValueError(_lib().cv_last_error().decode())
    return out


def kmeans(data: np.ndarray, k: int, criteria, attempts: int,
           flags: int = KMEANS_PP_CENTERS):
    """cv2.kmeans(data, k, None, criteria, attempts, flags) ->
    (compactness, labels int32 [N, 1], centers float32 [k, D]); criteria is
    (type, max_iter, epsilon), flags KMEANS_PP_CENTERS. Draws from this
    thread's generator."""
    data = np.ascontiguousarray(data, np.float32)
    if data.ndim == 1:
        data = data[:, None]
    data = data.reshape(data.shape[0], -1)
    n, dims = data.shape
    if flags != KMEANS_PP_CENTERS:
        raise ValueError(f"kmeans: flags {flags} (only KMEANS_PP_CENTERS is supported)")
    if not 0 < k <= n:
        raise ValueError(f"kmeans: {k} clusters for {n} samples")
    ctype, max_iter, eps = criteria
    labels = np.empty((n, 1), np.int32)
    centers = np.empty((k, dims), np.float32)
    state = ctypes.c_uint64(rng_state())
    comp = ctypes.c_double()
    lib = _lib()
    if lib.cv_kmeans(_ptr(data), n, dims, k, int(ctype), int(max_iter), float(eps),
                     int(attempts), ctypes.byref(state), _ptr(labels), _ptr(centers),
                     ctypes.byref(comp)) != 0:
        raise ValueError(lib.cv_last_error().decode())
    _rng.state = state.value
    return comp.value, labels, centers


def connected_components_with_stats(mask: np.ndarray, connectivity: int = 8):
    """cv2.connectedComponentsWithStats(mask, connectivity) for a 2-D mask
    (nonzero is foreground) -> (n, labels int32 [H, W], stats int32 [n, 5],
    centroids float64 [n, 2])."""
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"connected_components_with_stats takes a 2-D mask, not {mask.shape}")
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, not {connectivity}")
    m = np.ascontiguousarray(mask != 0, np.uint8)
    h, w = m.shape
    labels = np.empty((h, w), np.int32)
    lib = _lib()
    cap = 64
    while True:
        stats = np.empty((cap, 5), np.int32)
        cents = np.empty((cap, 2), np.float64)
        n = lib.cv_connected_components(_ptr(m), h, w, connectivity, _ptr(labels), _ptr(stats),
                                        _ptr(cents), cap)
        if n < 0:
            raise ValueError(lib.cv_last_error().decode())
        if n <= cap:
            return n, labels, stats[:n].copy(), cents[:n].copy()
        cap = n
