// The saliency segmenter's three OpenCV operations, bit for bit as OpenCV
// 5.0.0 computes them, behind a plain C interface (loaded with ctypes):
//
// - cv_gaussian_blur: cv::GaussianBlur on 8-bit images, its fixed-point path
//   (smooth.simd.hpp): each 1-D kernel quantised to 8 fraction bits with
//   error diffusion, a horizontal pass into 16-bit sums, a vertical pass into
//   32-bit sums rounded half up by 16 bits; BORDER_REFLECT_101.
// - cv_kmeans: cv::kmeans (kmeans.cpp) with k-means++ seeding, fed by
//   cv::RNG's multiply-with-carry state, which the caller owns.
// - cv_connected_components: cv::connectedComponentsWithStats' result,
//   labels numbered as OpenCV numbers them (see the function).
//
// The arithmetic that decides bits is written out, one operation per
// statement; the pragma keeps the compiler from fusing a multiply and an
// add into one rounding where the target has FMA.

#pragma GCC optimize("fp-contract=off")

#include <algorithm>
#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

// ---------------------------------------------------------------- blur ---

int reflect101(int p, int len) {
  if (len == 1) return 0;
  while (p < 0 || p >= len) p = p < 0 ? -p : 2 * len - 2 - p;
  return p;
}

// getGaussianKernelBitExact, then getGaussianKernelFixedPoint_ED with 8
// fraction bits: the kernel as integers summing to 256.
std::vector<int> fixed_kernel(int n, double sigma) {
  if (n == 1) return {256};
  std::vector<double> k(n);
  if (sigma <= 0 && n == 3) {
    k = {0.25, 0.5, 0.25};
  } else if (sigma <= 0 && n == 5) {
    k = {0.0625, 0.25, 0.375, 0.25, 0.0625};
  } else if (sigma <= 0 && n == 7) {
    k = {0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125};
  } else {
    double s = sigma > 0 ? sigma : std::fma((double)n, 0.15, 0.35);
    double scale2 = -0.125 / (s * s);
    int half = (n - 1) / 2;
    std::vector<double> v(half);
    double sum = 0;
    for (int i = 0, x = 1 - n; i < half; i++, x += 2) {
      v[i] = std::exp((double)(x * x) * scale2);
      sum += v[i];
    }
    sum *= 2;
    sum += 1;
    double mul = 1.0 / sum;
    for (int i = 0; i < half; i++) k[i] = k[n - 1 - i] = v[i] * mul;
    k[half] = mul;
  }
  std::vector<int> out(n);
  int half = n / 2;
  double err = 0;
  int64_t sum = 0;
  for (int i = 0; i < half; i++) {
    double adj = k[i] * 256.0 + err;
    int64_t v = (int64_t)std::nearbyint(adj);  // cvRound: half to even
    err = adj - (double)v;
    out[i] = out[n - 1 - i] = (int)v;
    sum += v;
  }
  out[half] = (int)(256 - 2 * sum);
  return out;
}

// ------------------------------------------------------------- k-means ---

struct Rng {
  uint64_t state;
  unsigned next() {
    state = (uint64_t)(unsigned)state * 4164903690U + (unsigned)(state >> 32);
    return (unsigned)state;
  }
  double uniform01() {  // RNG::operator double
    unsigned t = next();
    uint64_t hi = (uint64_t)t << 32;
    return (double)(hi | next()) * 5.4210108624275221700372640043497e-20;
  }
};

// hal::normL2Sqr_ at the segmenter's widths: a float sum in order.
inline float dist2(const float* a, const float* b, int n) {
  float d = 0.f;
  for (int j = 0; j < n; j++) {
    float t = a[j] - b[j];
    float tt = t * t;
    d = d + tt;
  }
  return d;
}

void centers_pp(const float* data, int N, int dims, float* out, int K, Rng& rng, int trials) {
  std::vector<int> centers(K);
  std::vector<float> buf((size_t)N * 3);
  float *dist = buf.data(), *tdist = dist + N, *tdist2 = tdist + N;
  double sum0 = 0;
  centers[0] = (int)(rng.next() % (unsigned)N);
  for (int i = 0; i < N; i++) {
    dist[i] = dist2(data + (size_t)i * dims, data + (size_t)centers[0] * dims, dims);
    sum0 += dist[i];
  }
  for (int k = 1; k < K; k++) {
    double best_sum = DBL_MAX;
    int best = -1;
    for (int j = 0; j < trials; j++) {
      double p = rng.uniform01() * sum0;
      int ci = 0;
      for (; ci < N - 1; ci++) {
        p -= dist[ci];
        if (p <= 0) break;
      }
      const float* c = data + (size_t)ci * dims;
      for (int i = 0; i < N; i++)
        tdist2[i] = std::min(dist2(data + (size_t)i * dims, c, dims), dist[i]);
      double s = 0;
      for (int i = 0; i < N; i++) s += tdist2[i];
      if (s < best_sum) {
        best_sum = s;
        best = ci;
        std::swap(tdist, tdist2);
      }
    }
    if (best < 0) throw std::string("kmeans: can't update cluster center (huge or NaN values)");
    centers[k] = best;
    sum0 = best_sum;
    std::swap(dist, tdist);
  }
  for (int k = 0; k < K; k++)
    memcpy(out + (size_t)k * dims, data + (size_t)centers[k] * dims, sizeof(float) * dims);
}

// cv::sum of a CV_64F row: four at a time, each four summed before the add.
double sum64(const double* v, int n) {
  double s = 0;
  int i = 0;
  for (; i <= n - 4; i += 4) s += v[i] + v[i + 1] + v[i + 2] + v[i + 3];
  for (; i < n; i++) s += v[i];
  return s;
}

double kmeans(const float* data, int N, int dims, int K, int crit_type, int max_count,
              double epsilon, int attempts, Rng& rng, int32_t* best_labels,
              float* best_centers) {
  const int kCount = 1, kEps = 2;
  attempts = std::max(attempts, 1);
  if (crit_type & kEps)
    epsilon = std::max(epsilon, 0.);
  else
    epsilon = FLT_EPSILON;
  epsilon *= epsilon;
  if (crit_type & kCount)
    max_count = std::min(std::max(max_count, 2), 100);
  else
    max_count = 100;
  if (K == 1) {
    attempts = 1;
    max_count = 2;
  }
  std::vector<float> centers((size_t)K * dims), old_centers((size_t)K * dims), temp(dims);
  std::vector<int> counters(K);
  std::vector<double> dists(N);
  std::vector<int32_t> labels(N);
  double best_compactness = DBL_MAX;
  for (int a = 0; a < attempts; a++) {
    double compactness = 0;
    for (int iter = 0;;) {
      double max_shift = iter == 0 ? DBL_MAX : 0.0;
      std::swap(centers, old_centers);
      if (iter == 0) {
        centers_pp(data, N, dims, centers.data(), K, rng, 3);
      } else {
        std::fill(centers.begin(), centers.end(), 0.f);
        std::fill(counters.begin(), counters.end(), 0);
        for (int i = 0; i < N; i++) {
          const float* sample = data + (size_t)i * dims;
          float* center = centers.data() + (size_t)labels[i] * dims;
          for (int j = 0; j < dims; j++) center[j] += sample[j];
          counters[labels[i]]++;
        }
        for (int k = 0; k < K; k++) {
          if (counters[k] != 0) continue;
          // an empty cluster takes the point of the biggest cluster that is
          // farthest from that cluster's mean (the last such point)
          int max_k = 0;
          for (int k1 = 1; k1 < K; k1++)
            if (counters[max_k] < counters[k1]) max_k = k1;
          double max_dist = 0;
          int farthest = -1;
          float* base = centers.data() + (size_t)max_k * dims;
          float scale = 1.f / counters[max_k];
          for (int j = 0; j < dims; j++) temp[j] = base[j] * scale;
          for (int i = 0; i < N; i++) {
            if (labels[i] != max_k) continue;
            double d = dist2(data + (size_t)i * dims, temp.data(), dims);
            if (max_dist <= d) {
              max_dist = d;
              farthest = i;
            }
          }
          counters[max_k]--;
          counters[k]++;
          labels[farthest] = k;
          const float* sample = data + (size_t)farthest * dims;
          float* cur = centers.data() + (size_t)k * dims;
          for (int j = 0; j < dims; j++) {
            base[j] -= sample[j];
            cur[j] += sample[j];
          }
        }
        for (int k = 0; k < K; k++) {
          float* center = centers.data() + (size_t)k * dims;
          float scale = 1.f / counters[k];
          for (int j = 0; j < dims; j++) center[j] *= scale;
          if (iter > 0) {
            double d = 0;
            const float* old = old_centers.data() + (size_t)k * dims;
            for (int j = 0; j < dims; j++) {
              double t = center[j] - old[j];
              double tt = t * t;
              d += tt;
            }
            max_shift = std::max(max_shift, d);
          }
        }
      }
      bool last = ++iter == std::max(max_count, 2) || max_shift <= epsilon;
      if (last) {
        // the distances only: labels stay, so no cluster empties
        for (int i = 0; i < N; i++)
          dists[i] = dist2(data + (size_t)i * dims,
                           centers.data() + (size_t)labels[i] * dims, dims);
        compactness = sum64(dists.data(), N);
        break;
      }
      for (int i = 0; i < N; i++) {
        const float* sample = data + (size_t)i * dims;
        int k_best = 0;
        double min_dist = DBL_MAX;
        for (int k = 0; k < K; k++) {
          double d = dist2(sample, centers.data() + (size_t)k * dims, dims);
          if (min_dist > d) {
            min_dist = d;
            k_best = k;
          }
        }
        dists[i] = min_dist;
        labels[i] = k_best;
      }
    }
    if (compactness < best_compactness) {
      best_compactness = compactness;
      memcpy(best_centers, centers.data(), sizeof(float) * K * dims);
      memcpy(best_labels, labels.data(), sizeof(int32_t) * N);
    }
  }
  return best_compactness;
}

// ------------------------------------------------- connected components ---

int find(std::vector<int32_t>& p, int32_t i) {
  while (p[i] != i) {
    p[i] = p[p[i]];
    i = p[i];
  }
  return i;
}

void unite(std::vector<int32_t>& p, int32_t a, int32_t b) {
  a = find(p, a);
  b = find(p, b);
  if (a < b)
    p[b] = a;
  else if (b < a)
    p[a] = b;
}

}  // namespace

extern "C" {

const char* cv_last_error() { return g_error.c_str(); }

// cv::GaussianBlur(src, dst, (kw, kh), sigma) with BORDER_DEFAULT on a
// uint8 h x w x cn image (cn 1..4); kw, kh odd and positive.
int cv_gaussian_blur(const uint8_t* src, uint8_t* dst, int h, int w, int cn, int kw, int kh,
                     double sigma) {
  try {
    if (h == 1) kh = 1;  // OpenCV drops the axis of a single row or column
    if (w == 1) kw = 1;
    std::vector<int> kx = fixed_kernel(kw, sigma), ky = fixed_kernel(kh, sigma);
    int rx = kw / 2, ry = kh / 2;
    std::vector<int> xs((size_t)w * kw), ys((size_t)h * kh);
    for (int x = 0; x < w; x++)
      for (int j = 0; j < kw; j++) xs[(size_t)x * kw + j] = reflect101(x + j - rx, w);
    for (int y = 0; y < h; y++)
      for (int j = 0; j < kh; j++) ys[(size_t)y * kh + j] = reflect101(y + j - ry, h);
    size_t row = (size_t)w * cn;
    std::vector<uint32_t> tmp((size_t)h * row);
    for (int y = 0; y < h; y++) {
      const uint8_t* s = src + (size_t)y * row;
      uint32_t* t = tmp.data() + (size_t)y * row;
      for (int x = 0; x < w; x++)
        for (int c = 0; c < cn; c++) {
          uint32_t acc = 0;
          for (int j = 0; j < kw; j++) acc += (uint32_t)kx[j] * s[(size_t)xs[(size_t)x * kw + j] * cn + c];
          t[(size_t)x * cn + c] = acc;
        }
    }
    std::vector<uint32_t> acc(row);
    for (int y = 0; y < h; y++) {
      std::fill(acc.begin(), acc.end(), 0u);
      for (int j = 0; j < kh; j++) {
        const uint32_t* t = tmp.data() + (size_t)ys[(size_t)y * kh + j] * row;
        uint32_t k = (uint32_t)ky[j];
        for (size_t i = 0; i < row; i++) acc[i] += k * t[i];
      }
      uint8_t* d = dst + (size_t)y * row;
      for (size_t i = 0; i < row; i++) {
        uint32_t v = (acc[i] + 32768u) >> 16;
        d[i] = (uint8_t)std::min(v, 255u);
      }
    }
    return 0;
  } catch (const std::exception& e) {
    g_error = e.what();
    return -1;
  }
}

// cv::kmeans with KMEANS_PP_CENTERS on float32 [N, dims]. *rng_state is
// cv::RNG's state, read and advanced.
int cv_kmeans(const float* data, int N, int dims, int K, int crit_type, int max_count,
              double epsilon, int attempts, uint64_t* rng_state, int32_t* labels,
              float* centers, double* compactness) {
  try {
    Rng rng{*rng_state};
    *compactness = kmeans(data, N, dims, K, crit_type, max_count, epsilon, attempts, rng,
                          labels, centers);
    *rng_state = rng.state;
    return 0;
  } catch (const std::string& e) {
    g_error = e;
    return -1;
  } catch (const std::exception& e) {
    g_error = e.what();
    return -1;
  }
}

// cv::connectedComponentsWithStats on a uint8 h x w mask (nonzero is
// foreground), connectivity 8 or 4. Labels are numbered as OpenCV's default
// algorithms number them: at 8-connectivity (Spaghetti, a 2x2-block scan)
// by each component's first 2x2 block in (row pair, column pair) order; at
// 4-connectivity (SAUF, a pixel scan) by its first pixel in raster order.
// stats (n x 5: left, top, width, height, area) and centroids (n x 2) are
// written for at most max_labels labels; returns n, or -1.
int cv_connected_components(const uint8_t* mask, int h, int w, int connectivity,
                            int32_t* labels, int32_t* stats, double* centroids,
                            int max_labels) {
  try {
    size_t np = (size_t)h * w;
    std::vector<int32_t> parent(np);
    for (size_t i = 0; i < np; i++) parent[i] = (int32_t)i;
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) {
        size_t i = (size_t)y * w + x;
        if (!mask[i]) continue;
        if (x > 0 && mask[i - 1]) unite(parent, (int32_t)i, (int32_t)(i - 1));
        if (y > 0) {
          if (mask[i - w]) unite(parent, (int32_t)i, (int32_t)(i - w));
          if (connectivity == 8) {
            if (x > 0 && mask[i - w - 1]) unite(parent, (int32_t)i, (int32_t)(i - w - 1));
            if (x + 1 < w && mask[i - w + 1]) unite(parent, (int32_t)i, (int32_t)(i - w + 1));
          }
        }
      }
    std::vector<int32_t> final_label(np, 0);
    int n = 1;
    auto visit = [&](int y, int x) {
      size_t i = (size_t)y * w + x;
      if (!mask[i]) return;
      int32_t r = find(parent, (int32_t)i);
      if (!final_label[r]) final_label[r] = n++;
    };
    if (connectivity == 8) {
      for (int by = 0; by < h; by += 2)
        for (int bx = 0; bx < w; bx += 2)
          for (int y = by; y < std::min(by + 2, h); y++)
            for (int x = bx; x < std::min(bx + 2, w); x++) visit(y, x);
    } else {
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) visit(y, x);
    }
    for (size_t i = 0; i < np; i++) labels[i] = mask[i] ? final_label[find(parent, (int32_t)i)] : 0;
    if (n > max_labels) return n;
    std::vector<int32_t> lo_x(n, INT_MAX), lo_y(n, INT_MAX), hi_x(n, INT_MIN), hi_y(n, INT_MIN);
    std::vector<uint32_t> area(n, 0);
    std::vector<uint64_t> sx(n, 0), sy(n, 0);
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) {
        int l = labels[(size_t)y * w + x];
        lo_x[l] = std::min(lo_x[l], x);
        lo_y[l] = std::min(lo_y[l], y);
        hi_x[l] = std::max(hi_x[l], x);
        hi_y[l] = std::max(hi_y[l], y);
        area[l]++;
        sx[l] += (uint64_t)x;
        sy[l] += (uint64_t)y;
      }
    for (int l = 0; l < n; l++) {
      int32_t* s = stats + (size_t)l * 5;
      if (area[l]) {
        s[0] = lo_x[l];
        s[1] = lo_y[l];
        s[2] = hi_x[l] - lo_x[l] + 1;
        s[3] = hi_y[l] - lo_y[l] + 1;
      } else {  // an empty background: OpenCV 5.0.0's row for it
        s[0] = -1;
        s[1] = INT_MAX;
        s[2] = s[3] = 0;
      }
      s[4] = (int32_t)area[l];
      double a = (double)area[l];
      centroids[(size_t)l * 2] = (double)sx[l] / a;
      centroids[(size_t)l * 2 + 1] = (double)sy[l] / a;
    }
    return n;
  } catch (const std::exception& e) {
    g_error = e.what();
    return -1;
  }
}

}  // extern "C"
