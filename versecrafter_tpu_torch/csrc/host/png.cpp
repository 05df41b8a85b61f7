// PNG scanline reconstruction behind a plain C interface (loaded with
// ctypes): the five filter types (None, Sub, Up, Average, Paeth) over the
// inflated IDAT stream, Adam7 interlacing, and the unpacking of 1/2/4/8/16
// bit samples into one uint16 per sample. Inflating (zlib) and the colour
// conversions are numpy's and Python's, in utils/png.py.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

inline int paeth(int a, int b, int c) {
  int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Unfilter one (sub)image of w x h pixels starting at raw; returns the bytes
// consumed or -1. Writes its samples to out at (x0 + i * dx, y0 + j * dy).
int64_t pass(const uint8_t* raw, int64_t n, int w, int h, int depth, int chans, uint16_t* out,
             int W, int x0, int y0, int dx, int dy) {
  if (w == 0 || h == 0) return 0;
  int bits = depth * chans;
  int64_t rowbytes = ((int64_t)w * bits + 7) / 8;
  int bpp = bits >= 8 ? bits / 8 : 1;
  if ((rowbytes + 1) * h > n) {
    g_error = "PNG: image data shorter than the image";
    return -1;
  }
  std::vector<uint8_t> prev(rowbytes, 0), cur(rowbytes);
  for (int j = 0; j < h; j++) {
    const uint8_t* src = raw + (rowbytes + 1) * j;
    int f = src[0];
    src++;
    for (int64_t i = 0; i < rowbytes; i++) {
      int a = i >= bpp ? cur[i - bpp] : 0, b = prev[i], c = i >= bpp ? prev[i - bpp] : 0;
      int x = src[i];
      switch (f) {
        case 0: break;
        case 1: x += a; break;
        case 2: x += b; break;
        case 3: x += (a + b) >> 1; break;
        case 4: x += paeth(a, b, c); break;
        default:
          g_error = "PNG: unknown filter type " + std::to_string(f);
          return -1;
      }
      cur[i] = (uint8_t)x;
    }
    uint16_t* row = out + (size_t)(y0 + j * dy) * W * chans;
    for (int i = 0; i < w; i++) {
      uint16_t* px = row + (size_t)(x0 + i * dx) * chans;
      for (int c = 0; c < chans; c++) {
        int64_t s = (int64_t)i * chans + c;
        if (depth == 16) {
          px[c] = (uint16_t)((cur[2 * s] << 8) | cur[2 * s + 1]);
        } else if (depth == 8) {
          px[c] = cur[s];
        } else {
          int64_t bit = s * depth;
          int shift = 8 - depth - (int)(bit & 7);
          px[c] = (uint16_t)((cur[bit >> 3] >> shift) & ((1 << depth) - 1));
        }
      }
    }
    std::swap(prev, cur);
  }
  return (rowbytes + 1) * h;
}

}  // namespace

extern "C" {

const char* png_last_error() { return g_error.c_str(); }

// raw: the inflated IDAT stream; out: height x width x chans uint16 samples.
int png_unfilter(const uint8_t* raw, int64_t n, int width, int height, int depth, int chans,
                 int interlace, uint16_t* out) {
  if (!interlace) return pass(raw, n, width, height, depth, chans, out, width, 0, 0, 1, 1) < 0;
  static const int X0[7] = {0, 4, 0, 2, 0, 1, 0}, Y0[7] = {0, 0, 4, 0, 2, 0, 1};
  static const int DX[7] = {8, 8, 4, 4, 2, 2, 1}, DY[7] = {8, 8, 8, 4, 4, 2, 2};
  int64_t off = 0;
  for (int p = 0; p < 7; p++) {
    int w = width > X0[p] ? (width - X0[p] + DX[p] - 1) / DX[p] : 0;
    int h = height > Y0[p] ? (height - Y0[p] + DY[p] - 1) / DY[p] : 0;
    int64_t used = pass(raw + off, n - off, w, h, depth, chans, out, width, X0[p], Y0[p], DX[p],
                        DY[p]);
    if (used < 0) return 1;
    off += used;
  }
  return 0;
}

}  // extern "C"
