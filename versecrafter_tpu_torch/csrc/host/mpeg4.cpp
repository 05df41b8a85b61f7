// MPEG-4 Part 2 (ISO/IEC 14496-2) Simple Profile video: a decoder and an
// intra-only encoder, behind a plain C interface (loaded with ctypes).
//
// Decoder: the video object layer header; I- and P-VOPs; H.263 and MPEG
// dequantisation; intra DC prediction and AC prediction; the intra / inter
// TCOEF VLCs with their three escape modes; 1MV and 4MV with median
// prediction; half-pel motion compensation with vop_rounding_type over an
// edge-replicated reference; not-coded macroblocks; resync markers (video
// packets). The normative steps are exact by the standard. The two that are
// not -- the inverse DCT and the YUV 4:2:0 -> RGB conversion -- follow what
// FFmpeg's decoder and swscale do on x86-64 for an encoder-written stream:
// the "simple" integer IDCT and swscale's unscaled fixed-point BT.601
// limited-range converter with one chroma sample per 2x2 block. Motion
// vectors reach beyond the macroblock-aligned frame by edge replication.
//
// Encoder: I-VOPs at a fixed quantiser (H.263 quantisation, intra DC VLC,
// no AC prediction), from RGB frames converted to BT.601 limited-range
// YUV 4:2:0 (8-bit integer weights, chroma from each 2x2 block's mean). The headers it emits (VOS, VO, VOL) form the decoder-specific
// information that an mp4 `esds` carries.
//
// B-VOPs, sprites (S-VOPs), interlace, quarter-pel, data partitioning,
// shapes other than rectangular and bit depths other than 8 are refused
// with an error that names them.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------- tables

// Table B-16 (intra TCOEF): {code, length}; entry 102 is the escape.
const uint16_t kIntraVlc[103][2] = {
    {0x2, 2},   {0x6, 3},   {0xf, 4},   {0xd, 5},   {0xc, 5},   {0x15, 6},  {0x13, 6},
    {0x12, 6},  {0x17, 7},  {0x1f, 8},  {0x1e, 8},  {0x1d, 8},  {0x25, 9},  {0x24, 9},
    {0x23, 9},  {0x21, 9},  {0x21, 10}, {0x20, 10}, {0xf, 10},  {0xe, 10},  {0x7, 11},
    {0x6, 11},  {0x20, 11}, {0x21, 11}, {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4},
    {0x14, 6},  {0x16, 7},  {0x1c, 8},  {0x20, 9},  {0x1f, 9},  {0xd, 10},  {0x22, 11},
    {0x53, 12}, {0x55, 12}, {0xb, 5},   {0x15, 7},  {0x1e, 9},  {0xc, 10},  {0x56, 12},
    {0x11, 6},  {0x1b, 8},  {0x1d, 9},  {0xb, 10},  {0x10, 6},  {0x22, 9},  {0xa, 10},
    {0xd, 6},   {0x1c, 9},  {0x8, 10},  {0x12, 7},  {0x1b, 9},  {0x54, 12}, {0x14, 7},
    {0x1a, 9},  {0x57, 12}, {0x19, 8},  {0x9, 10},  {0x18, 8},  {0x23, 11}, {0x17, 8},
    {0x19, 9},  {0x18, 9},  {0x7, 10},  {0x58, 12}, {0x7, 4},   {0xc, 6},   {0x16, 8},
    {0x17, 9},  {0x6, 10},  {0x5, 11},  {0x4, 11},  {0x59, 12}, {0xf, 6},   {0x16, 9},
    {0x5, 10},  {0xe, 6},   {0x4, 10},  {0x11, 7},  {0x24, 11}, {0x10, 7},  {0x25, 11},
    {0x13, 7},  {0x5a, 12}, {0x15, 8},  {0x5b, 12}, {0x14, 8},  {0x13, 8},  {0x1a, 8},
    {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},  {0x26, 11}, {0x27, 11},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7},
};
const int8_t kIntraRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 5,
    6, 6, 6, 7, 7, 7, 8, 8, 9, 9, 10, 11, 12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
    2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
};
const int8_t kIntraLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
    27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3,
    1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3,
    1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
};
const int kIntraLast = 67;  // entries from here on end the block

// Table B-17 (inter TCOEF, the H.263 table).
const uint16_t kInterVlc[103][2] = {
    {0x2, 2},   {0xf, 4},   {0x15, 6},  {0x17, 7},  {0x1f, 8},  {0x25, 9},  {0x24, 9},
    {0x21, 10}, {0x20, 10}, {0x7, 11},  {0x6, 11},  {0x20, 11}, {0x6, 3},   {0x14, 6},
    {0x1e, 8},  {0xf, 10},  {0x21, 11}, {0x50, 12}, {0xe, 4},   {0x1d, 8},  {0xe, 10},
    {0x51, 12}, {0xd, 5},   {0x23, 9},  {0xd, 10},  {0xc, 5},   {0x22, 9},  {0x52, 12},
    {0xb, 5},   {0xc, 10},  {0x53, 12}, {0x13, 6},  {0xb, 10},  {0x54, 12}, {0x12, 6},
    {0xa, 10},  {0x11, 6},  {0x9, 10},  {0x10, 6},  {0x8, 10},  {0x16, 7},  {0x55, 12},
    {0x15, 7},  {0x14, 7},  {0x1c, 8},  {0x1b, 8},  {0x21, 9},  {0x20, 9},  {0x1f, 9},
    {0x1e, 9},  {0x1d, 9},  {0x1c, 9},  {0x1b, 9},  {0x1a, 9},  {0x22, 11}, {0x23, 11},
    {0x56, 12}, {0x57, 12}, {0x7, 4},   {0x19, 9},  {0x5, 11},  {0xf, 6},   {0x4, 11},
    {0xe, 6},   {0xd, 6},   {0xc, 6},   {0x13, 7},  {0x12, 7},  {0x11, 7},  {0x10, 7},
    {0x1a, 8},  {0x19, 8},  {0x18, 8},  {0x17, 8},  {0x16, 8},  {0x15, 8},  {0x14, 8},
    {0x13, 8},  {0x18, 9},  {0x17, 9},  {0x16, 9},  {0x15, 9},  {0x14, 9},  {0x13, 9},
    {0x12, 9},  {0x11, 9},  {0x7, 10},  {0x6, 10},  {0x5, 10},  {0x4, 10},  {0x24, 11},
    {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12}, {0x5a, 12}, {0x5b, 12},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7},
};
const int8_t kInterRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4,
    4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 0, 0, 0, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
};
const int8_t kInterLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 1, 2, 3, 1,
    2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 2, 3, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
};
const int kInterLast = 58;

// Table B-6 (MCBPC, I-VOP): cbpc 0-3 intra, 4-7 intra+q, 8 stuffing.
const uint8_t kIntraMcbpc[9][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                                   {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// Table B-7 (MCBPC, P-VOP), indexed type * 4 + cbpc with the types in the
// order inter, intra, inter+q, intra+q, inter4v; 20 is stuffing.
const uint8_t kInterMcbpc[21][2] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6}, {3, 5}, {4, 8}, {3, 8}, {3, 7}, {3, 3}, {7, 7}, {6, 7},
    {5, 9}, {4, 6}, {4, 9}, {3, 9}, {2, 9}, {2, 3}, {5, 7}, {4, 7}, {5, 8}, {1, 9},
};
// Table B-8 (CBPY, intra meaning).
const uint8_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4}, {2, 6}, {11, 4},
                              {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// Table B-12 (motion vector data), index = |mvd code|.
const uint8_t kMv[33][2] = {
    {1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},   {3, 7},   {11, 9},
    {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10}, {14, 10}, {13, 10}, {12, 10}, {11, 10},
    {10, 10}, {9, 10},  {8, 10},  {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},
    {5, 11},  {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12},
};
// Tables B-13 / B-14 (dct_dc_size, luminance / chrominance).
const uint8_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4}, {1, 5},
                               {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const uint8_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},  {1, 5}, {1, 6},
                                 {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};

const uint8_t kYDcScale[32] = {0,  8,  8,  8,  8,  10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23,
                               24, 25, 26, 27, 28, 29, 30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
const uint8_t kCDcScale[32] = {0,  8,  8,  8,  8,  9,  9,  10, 10, 11, 11, 12, 12, 13, 13, 14,
                               14, 15, 15, 16, 16, 17, 17, 18, 18, 19, 20, 21, 22, 23, 24, 25};
const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
const int kDquant[4] = {-1, -2, 1, 2};

const uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltH[64] = {0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14,
                           13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
                           30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
                           46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltV[64] = {0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
                           41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
                           51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
                           53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
const uint8_t kDefaultIntraMat[64] = {
    8,  17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28, 20, 21, 22, 23, 24, 26,
    28, 30, 21, 22, 23, 24, 26, 28, 30, 32, 22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28,
    30, 32, 35, 38, 25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
const uint8_t kDefaultInterMat[64] = {
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24, 18, 19, 20, 21, 22, 23,
    24, 25, 19, 20, 21, 22, 23, 24, 26, 27, 20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24,
    26, 27, 28, 30, 22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33};

struct Error {
  std::string msg;
};

// ---------------------------------------------------------------- bits

struct BitReader {
  const uint8_t* buf = nullptr;
  size_t size = 0;
  size_t pos = 0;  // in bits

  uint32_t peek(int n) const {
    if (n == 0) return 0;
    size_t byte = pos >> 3;
    uint64_t v = 0;
    if (byte + 8 <= size) {
      memcpy(&v, buf + byte, 8);
      v = __builtin_bswap64(v);
    } else {
      for (int i = 0; i < 8; i++) v = (v << 8) | (byte + i < size ? buf[byte + i] : 0);
    }
    v <<= (pos & 7);
    return (uint32_t)(v >> (64 - n));
  }
  uint32_t get(int n) {
    uint32_t v = peek(n);
    pos += n;
    return v;
  }
  int get1() { return (int)get(1); }
  void skip(int n) { pos += n; }
  int64_t left() const { return (int64_t)size * 8 - (int64_t)pos; }
  void marker(const char* what) {
    if (!get1()) throw Error{std::string("missing marker bit after ") + what};
  }
};

struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int nacc = 0;
  void put(uint32_t v, int n) {  // n <= 32
    if (n == 0) return;
    acc = (acc << n) | (v & ((1ull << n) - 1));
    nacc += n;
    while (nacc >= 8) {
      nacc -= 8;
      out.push_back((uint8_t)(acc >> nacc));
    }
    acc &= (1ull << nacc) - 1;
  }
  // next_start_code(): a zero bit, then ones up to the byte boundary.
  void stuff() {
    put(0, 1);
    while (nacc) put(1, 1);
  }
  void start_code(uint8_t code) {
    out.push_back(0);
    out.push_back(0);
    out.push_back(1);
    out.push_back(code);
  }
};

struct Vlc {
  int maxlen = 0;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;
  template <typename T>
  void init(const T table[][2], int n) {
    maxlen = 0;
    for (int i = 0; i < n; i++) maxlen = std::max(maxlen, (int)table[i][1]);
    sym.assign(1u << maxlen, -1);
    len.assign(1u << maxlen, 0);
    for (int i = 0; i < n; i++) {
      int l = table[i][1];
      if (l == 0) continue;
      uint32_t base = (uint32_t)table[i][0] << (maxlen - l);
      for (uint32_t k = 0; k < (1u << (maxlen - l)); k++) {
        sym[base | k] = (int16_t)i;
        len[base | k] = (uint8_t)l;
      }
    }
  }
  int decode(BitReader& br) const {
    uint32_t v = br.peek(maxlen);
    int s = sym[v];
    if (s >= 0) br.skip(len[v]);
    return s;
  }
};

struct RlTable {
  Vlc vlc;
  const uint16_t (*codes)[2];
  const int8_t* run;
  const int8_t* level;
  int last_start;
  int max_level[2][64];
  int max_run[2][64];
  int index[2][64][64];  // [last][run][level] -> code index, or -1
  void init(const uint16_t (*c)[2], const int8_t* r, const int8_t* l, int ls) {
    codes = c;
    run = r;
    level = l;
    last_start = ls;
    vlc.init(c, 103);
    memset(max_level, 0, sizeof(max_level));
    memset(max_run, 0, sizeof(max_run));
    for (auto& a : index)
      for (auto& b : a)
        for (auto& x : b) x = -1;
    for (int i = 0; i < 102; i++) {
      int last = i >= ls;
      max_level[last][r[i]] = std::max(max_level[last][r[i]], (int)l[i]);
      max_run[last][l[i]] = std::max(max_run[last][l[i]], (int)r[i]);
      index[last][r[i]][l[i]] = i;
    }
  }
};

struct Tables {
  RlTable intra, inter;
  Vlc intra_mcbpc, inter_mcbpc, cbpy, mv, dc_lum, dc_chrom;
  Tables() {
    intra.init(kIntraVlc, kIntraRun, kIntraLevel, kIntraLast);
    inter.init(kInterVlc, kInterRun, kInterLevel, kInterLast);
    intra_mcbpc.init(kIntraMcbpc, 9);
    inter_mcbpc.init(kInterMcbpc, 21);
    cbpy.init(kCbpy, 16);
    mv.init(kMv, 33);
    dc_lum.init(kDcLum, 13);
    dc_chrom.init(kDcChrom, 13);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// ---------------------------------------------------------------- IDCT
// FFmpeg's "simple" integer IDCT, 8-bit: W_k = round(cos(k pi / 16) *
// sqrt(2) * 2^14) (W4 one less), a row pass with rounding shift 11 kept in
// int16, then a column pass with shift 20. Its x86-64 SSE2 form gives the
// same samples (held against OpenCV's FFmpeg on intra and inter frames).

const int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520;

inline void idct_pass1(int16_t* p, int stride) {
  int r0 = p[0], r1 = p[stride], r2 = p[2 * stride], r3 = p[3 * stride];
  int r4 = p[4 * stride], r5 = p[5 * stride], r6 = p[6 * stride], r7 = p[7 * stride];
  int a0 = W4 * r0 + (1 << 10), a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * r2;
  a1 += W6 * r2;
  a2 -= W6 * r2;
  a3 -= W2 * r2;
  int b0 = W1 * r1 + W3 * r3, b1 = W3 * r1 - W7 * r3;
  int b2 = W5 * r1 - W1 * r3, b3 = W7 * r1 - W5 * r3;
  a0 += W4 * r4 + W6 * r6;
  a1 += -W4 * r4 - W2 * r6;
  a2 += -W4 * r4 + W2 * r6;
  a3 += W4 * r4 - W6 * r6;
  b0 += W5 * r5 + W7 * r7;
  b1 += -W1 * r5 - W5 * r7;
  b2 += W7 * r5 + W3 * r7;
  b3 += W3 * r5 - W1 * r7;
  p[0] = (int16_t)((a0 + b0) >> 11);
  p[7 * stride] = (int16_t)((a0 - b0) >> 11);
  p[stride] = (int16_t)((a1 + b1) >> 11);
  p[6 * stride] = (int16_t)((a1 - b1) >> 11);
  p[2 * stride] = (int16_t)((a2 + b2) >> 11);
  p[5 * stride] = (int16_t)((a2 - b2) >> 11);
  p[3 * stride] = (int16_t)((a3 + b3) >> 11);
  p[4 * stride] = (int16_t)((a3 - b3) >> 11);
}

inline void idct_pass2(const int16_t* p, int stride, int* out, int ostride) {
  int c0 = p[0], c1 = p[stride], c2 = p[2 * stride], c3 = p[3 * stride];
  int c4 = p[4 * stride], c5 = p[5 * stride], c6 = p[6 * stride], c7 = p[7 * stride];
  int a0 = W4 * (c0 + ((1 << 19) / W4)), a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * c2;
  a1 += W6 * c2;
  a2 -= W6 * c2;
  a3 -= W2 * c2;
  int b0 = W1 * c1 + W3 * c3, b1 = W3 * c1 - W7 * c3;
  int b2 = W5 * c1 - W1 * c3, b3 = W7 * c1 - W5 * c3;
  a0 += W4 * c4 + W6 * c6;
  a1 += -W4 * c4 - W2 * c6;
  a2 += -W4 * c4 + W2 * c6;
  a3 += W4 * c4 - W6 * c6;
  b0 += W5 * c5 + W7 * c7;
  b1 += -W1 * c5 - W5 * c7;
  b2 += W7 * c5 + W3 * c7;
  b3 += W3 * c5 - W1 * c7;
  out[0] = (a0 + b0) >> 20;
  out[7 * ostride] = (a0 - b0) >> 20;
  out[ostride] = (a1 + b1) >> 20;
  out[6 * ostride] = (a1 - b1) >> 20;
  out[2 * ostride] = (a2 + b2) >> 20;
  out[5 * ostride] = (a2 - b2) >> 20;
  out[3 * ostride] = (a3 + b3) >> 20;
  out[4 * ostride] = (a3 - b3) >> 20;
}

// blk is in natural order (row = vertical frequency); res gets the 8x8
// spatial residual / samples, row-major. A row whose AC terms are all zero
// takes the DC shortcut (row[0] * 8), as FFmpeg's C form does.
void idct(int16_t* blk, int* res) {
  for (int r = 0; r < 8; r++) {
    int16_t* row = blk + 8 * r;
    bool dc_only = true;
    for (int k = 1; k < 8; k++) dc_only &= row[k] == 0;
    if (dc_only) {
      int16_t v = (int16_t)(row[0] * 8);
      for (int k = 0; k < 8; k++) row[k] = v;
    } else {
      idct_pass1(row, 1);
    }
  }
  for (int c = 0; c < 8; c++) idct_pass2(blk + c, 8, res + c, 8);
}

// ---------------------------------------------------------------- frames

struct Plane {
  int w = 0, h = 0;  // allocated (macroblock-aligned)
  std::vector<uint8_t> px;
  void alloc(int W, int H) {
    w = W;
    h = H;
    px.assign((size_t)W * H, 0);
  }
  uint8_t* row(int y) { return px.data() + (size_t)y * w; }
};

struct Frame {
  Plane p[3];
  void alloc(int mbw, int mbh) {
    p[0].alloc(mbw * 16, mbh * 16);
    p[1].alloc(mbw * 8, mbh * 8);
    p[2].alloc(mbw * 8, mbh * 8);
  }
};

// ---------------------------------------------------------------- decoder

struct Decoder {
  // video object layer
  bool have_vol = false;
  int width = 0, height = 0, mbw = 0, mbh = 0;
  int time_bits = 1;
  int quant_type = 0;
  int quant_precision = 5;
  int resync_disable = 1;
  int intra_mat[64], inter_mat[64];
  int edge_w = 0, edge_h = 0;  // the reference is replicated beyond the macroblock grid

  Frame cur, ref;
  bool have_ref = false;

  // per VOP
  int coding_type = 0, rounding = 0, qp = 1, fcode = 1, dc_thr = 99;
  BitReader br;
  int slice = 0, resync_x = 0, resync_y = 0;
  std::vector<int> mb_slice;
  std::vector<uint8_t> mb_intra;
  std::vector<uint8_t> mb_qp;
  // luma 8x8 grid (2mbw x 2mbh) then two chroma grids (mbw x mbh)
  std::vector<int> dc_y, dc_c[2];
  std::vector<int16_t> ac_y, ac_c[2];  // 16 per block: [0..7] left col, [8..15] top row
  std::vector<int16_t> mvs;            // luma 8x8 grid, 2 per block

  void parse_vol(BitReader& b) {
    b.get1();  // random_accessible_vol
    int type = b.get(8);
    (void)type;
    int verid = 1;
    if (b.get1()) {  // is_object_layer_identifier
      verid = b.get(4);
      b.get(3);
    }
    if (b.get(4) == 15) {  // aspect_ratio_info: extended PAR
      b.get(8);
      b.get(8);
    }
    if (b.get1()) {  // vol_control_parameters
      int chroma = b.get(2);
      if (chroma != 1) throw Error{"MPEG-4 video: chroma format other than 4:2:0"};
      b.get1();        // low_delay
      if (b.get1()) {  // vbv_parameters
        b.get(15);
        b.marker("first_half_bit_rate");
        b.get(15);
        b.marker("latter_half_bit_rate");
        b.get(15);
        b.marker("first_half_vbv_buffer_size");
        b.get(3);
        b.get(11);
        b.marker("first_half_vbv_occupancy");
        b.get(15);
        b.marker("latter_half_vbv_occupancy");
      }
    }
    int shape = b.get(2);
    if (shape != 0) throw Error{"MPEG-4 video: non-rectangular shape is not supported"};
    b.marker("video_object_layer_shape");
    int res = b.get(16);
    if (res == 0) throw Error{"MPEG-4 video: vop_time_increment_resolution is 0"};
    b.marker("vop_time_increment_resolution");
    time_bits = 1;
    while ((1 << time_bits) < res) time_bits++;
    if (b.get1()) b.get(time_bits);  // fixed_vop_rate, fixed_vop_time_increment
    b.marker("fixed_vop_rate");
    width = b.get(13);
    b.marker("video_object_layer_width");
    height = b.get(13);
    b.marker("video_object_layer_height");
    if (b.get1()) throw Error{"MPEG-4 video: interlaced video is not supported"};
    b.get1();  // obmc_disable
    int sprite = verid == 1 ? b.get1() : b.get(2);
    if (sprite) throw Error{"MPEG-4 video: sprites (GMC) are not supported"};
    if (b.get1()) throw Error{"MPEG-4 video: bit depths other than 8 are not supported"};
    quant_precision = 5;
    quant_type = b.get1();
    for (int i = 0; i < 64; i++) {
      intra_mat[i] = kDefaultIntraMat[i];
      inter_mat[i] = kDefaultInterMat[i];
    }
    if (quant_type) {
      for (int m = 0; m < 2; m++) {
        int* mat = m == 0 ? intra_mat : inter_mat;
        if (!b.get1()) continue;  // load_*_quant_mat
        int last = 0, i = 0;
        for (; i < 64; i++) {
          int v = b.get(8);
          if (v == 0) break;
          last = v;
          mat[kZigzag[i]] = v;
        }
        for (; i < 64; i++) mat[kZigzag[i]] = last;
      }
    }
    if (verid != 1 && b.get1())
      throw Error{"MPEG-4 video: quarter-pel motion is not supported"};
    if (!b.get1()) throw Error{"MPEG-4 video: complexity estimation headers are not supported"};
    resync_disable = b.get1();
    if (b.get1()) throw Error{"MPEG-4 video: data partitioning is not supported"};
    if (verid != 1) {
      if (b.get1()) throw Error{"MPEG-4 video: newpred is not supported"};
      if (b.get1()) throw Error{"MPEG-4 video: reduced-resolution VOPs are not supported"};
    }
    if (b.get1()) throw Error{"MPEG-4 video: scalability is not supported"};
    if (width <= 0 || height <= 0) throw Error{"MPEG-4 video: zero frame size"};
    mbw = (width + 15) / 16;
    mbh = (height + 15) / 16;
    edge_w = mbw * 16;
    edge_h = mbh * 16;
    cur.alloc(mbw, mbh);
    ref.alloc(mbw, mbh);
    have_ref = false;
    have_vol = true;
    int nmb = mbw * mbh;
    mb_slice.assign(nmb, -1);
    mb_intra.assign(nmb, 0);
    mb_qp.assign(nmb, 1);
    dc_y.assign(nmb * 4, 1024);
    dc_c[0].assign(nmb, 1024);
    dc_c[1].assign(nmb, 1024);
    ac_y.assign(nmb * 4 * 16, 0);
    ac_c[0].assign(nmb * 16, 0);
    ac_c[1].assign(nmb * 16, 0);
    mvs.assign(nmb * 4 * 2, 0);
  }

  // Walk the start codes of a buffer (headers and VOPs). Returns true if a
  // VOP was decoded into `cur` (and `cur` is to be output).
  bool decode_buffer(const uint8_t* data, size_t n) {
    bool got = false;
    size_t i = 0;
    while (true) {
      // find 00 00 01 xx
      while (i + 3 < n && !(data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1)) i++;
      if (i + 3 >= n) break;
      uint8_t code = data[i + 3];
      size_t start = i + 4;
      BitReader b;
      b.buf = data + start;
      b.size = n - start;
      if (code >= 0x20 && code <= 0x2f) {
        parse_vol(b);
      } else if (code == 0xb6) {
        if (!have_vol) throw Error{"MPEG-4 video: a VOP before any video object layer header"};
        br = b;
        got |= decode_vop();
        start += br.pos / 8;
      }
      i = start;
    }
    return got;
  }

  bool decode_vop() {
    BitReader& b = br;
    coding_type = b.get(2);
    if (coding_type == 2) throw Error{"MPEG-4 video: B-VOPs are not supported (Simple Profile only)"};
    if (coding_type == 3) throw Error{"MPEG-4 video: S-VOPs (sprites) are not supported"};
    while (b.get1()) {  // modulo_time_base
      if (b.left() <= 0) throw Error{"MPEG-4 video: truncated VOP header"};
    }
    b.marker("modulo_time_base");
    b.get(time_bits);
    b.marker("vop_time_increment");
    if (!b.get1()) return false;  // vop_coded == 0: nothing is output
    if (coding_type == 1) {
      if (!have_ref) throw Error{"MPEG-4 video: a P-VOP without a reference"};
      rounding = b.get1();
    } else {
      rounding = 0;
    }
    dc_thr = kDcThreshold[b.get(3)];
    qp = b.get(quant_precision);
    if (qp == 0) throw Error{"MPEG-4 video: vop_quant is 0"};
    if (coding_type == 1) {
      fcode = b.get(3);
      if (fcode == 0) throw Error{"MPEG-4 video: vop_fcode_forward is 0"};
    }
    std::fill(mb_slice.begin(), mb_slice.end(), -1);
    std::fill(mb_intra.begin(), mb_intra.end(), 0);
    slice = 0;
    resync_x = resync_y = 0;
    int nmb = mbw * mbh;
    int mbnum_bits = 1;
    while ((1 << mbnum_bits) < nmb) mbnum_bits++;
    int mb = 0;
    while (mb < nmb) {
      if (!resync_disable && mb > 0 && at_resync()) {
        int marker_len = coding_type == 0 ? 17 : 16 + fcode;
        // skip the stuffing to the byte boundary, then the marker
        b.skip(8 - (int)(b.pos & 7));
        b.skip(marker_len);
        int num = b.get(mbnum_bits);
        if (num >= nmb || num < mb) throw Error{"MPEG-4 video: bad video packet number"};
        qp = b.get(quant_precision);
        if (qp == 0) throw Error{"MPEG-4 video: quant_scale is 0"};
        if (b.get1()) {  // header_extension_code
          while (b.get1()) {
            if (b.left() <= 0) throw Error{"MPEG-4 video: truncated packet header"};
          }
          b.marker("modulo_time_base");
          b.get(time_bits);
          b.marker("vop_time_increment");
          b.get(2);
          dc_thr = kDcThreshold[b.get(3)];
          if (coding_type == 1) b.get(3);
        }
        // macroblocks the packet skipped over are lost: conceal as copies
        for (; mb < num; mb++) conceal_mb(mb % mbw, mb / mbw);
        slice++;
        resync_x = mb % mbw;
        resync_y = mb / mbw;
      }
      int mbx = mb % mbw, mby = mb / mbw;
      mb_slice[mb] = slice;
      if (coding_type == 0)
        decode_intra_mb(mbx, mby);
      else
        decode_p_mb(mbx, mby);
      if (b.left() < 0) throw Error{"MPEG-4 video: truncated VOP data"};
      mb++;
    }
    std::swap(cur, ref);
    have_ref = true;
    return true;
  }

  bool at_resync() const {
    int k = 8 - (int)(br.pos & 7);
    uint32_t stuff = br.peek(k);
    if (stuff != (1u << (k - 1)) - 1) return false;
    int marker_len = coding_type == 0 ? 17 : 16 + fcode;
    BitReader t = br;
    t.skip(k);
    return t.peek(marker_len) == 1;
  }

  void conceal_mb(int mbx, int mby) {
    int mb = mby * mbw + mbx;
    mb_slice[mb] = slice;
    mb_intra[mb] = 0;
    clear_pred(mbx, mby);
    if (have_ref && coding_type == 1) {
      int zero[4][2] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};
      set_mvs(mbx, mby, zero);
      motion_compensate(mbx, mby, zero, false);
    }
  }

  // ---- prediction stores

  void clear_pred(int mbx, int mby) {
    int mb = mby * mbw + mbx;
    for (int k = 0; k < 4; k++) {
      int bi = luma_block(mbx, mby, k);
      dc_y[bi] = 1024;
      std::fill(&ac_y[bi * 16], &ac_y[bi * 16] + 16, 0);
    }
    for (int c = 0; c < 2; c++) {
      dc_c[c][mb] = 1024;
      std::fill(&ac_c[c][mb * 16], &ac_c[c][mb * 16] + 16, 0);
    }
  }

  int luma_block(int mbx, int mby, int k) const {
    return (2 * mby + (k >> 1)) * (2 * mbw) + 2 * mbx + (k & 1);
  }

  // Is the block at 8x8 grid position (bx, by) of component `comp` usable
  // as a DC/AC predictor: inside the picture, already decoded in this
  // video packet, and intra.
  bool avail(int comp, int bx, int by) const {
    int gw = comp == 0 ? 2 * mbw : mbw, gh = comp == 0 ? 2 * mbh : mbh;
    if (bx < 0 || by < 0 || bx >= gw || by >= gh) return false;
    int mb = comp == 0 ? (by >> 1) * mbw + (bx >> 1) : by * mbw + bx;
    return mb_slice[mb] == slice && mb_intra[mb];
  }
  int mb_of(int comp, int bx, int by) const {
    return comp == 0 ? (by >> 1) * mbw + (bx >> 1) : by * mbw + bx;
  }
  int& dc_at(int comp, int bx, int by) {
    return comp == 0 ? dc_y[by * 2 * mbw + bx] : dc_c[comp - 1][by * mbw + bx];
  }
  int16_t* ac_at(int comp, int bx, int by) {
    return comp == 0 ? &ac_y[(by * 2 * mbw + bx) * 16] : &ac_c[comp - 1][(by * mbw + bx) * 16];
  }

  // ---- motion vectors

  int16_t* mv_at(int bx, int by) { return &mvs[(by * 2 * mbw + bx) * 2]; }
  void mv_get(int bx, int by, int out[2]) {
    if (bx < 0 || bx >= 2 * mbw || by < 0) {
      out[0] = out[1] = 0;
      return;
    }
    int16_t* m = mv_at(bx, by);
    out[0] = m[0];
    out[1] = m[1];
  }
  void set_mvs(int mbx, int mby, int mv[4][2]) {
    for (int k = 0; k < 4; k++) {
      int16_t* m = mv_at(2 * mbx + (k & 1), 2 * mby + (k >> 1));
      m[0] = (int16_t)mv[k][0];
      m[1] = (int16_t)mv[k][1];
    }
  }

  static int median(int a, int b, int c) {
    return std::max(std::min(a, b), std::min(std::max(a, b), c));
  }

  // The median predictor of block k's vector (FFmpeg's ff_h263_pred_motion
  // semantics for a rectangular VOP with video packets).
  void pred_motion(int mbx, int mby, int k, int* px, int* py) {
    int bx = 2 * mbx + (k & 1), by = 2 * mby + (k >> 1);
    static const int off[4] = {2, 1, 1, -1};
    int A[2], B[2], C[2];
    mv_get(bx - 1, by, A);
    bool first_line = mby == resync_y || (mby == resync_y + 1 && mbx < resync_x);
    if (first_line && k < 3) {
      if (k == 0) {
        if (mbx == resync_x) {
          *px = *py = 0;
        } else if (mbx + 1 == resync_x) {
          mv_get(bx + off[k], by - 1, C);
          if (mbx == 0) {
            *px = C[0];
            *py = C[1];
          } else {
            *px = median(A[0], 0, C[0]);
            *py = median(A[1], 0, C[1]);
          }
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else if (k == 1) {
        if (mbx + 1 == resync_x) {
          mv_get(bx + off[k], by - 1, C);
          *px = median(A[0], 0, C[0]);
          *py = median(A[1], 0, C[1]);
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else {
        mv_get(bx, by - 1, B);
        mv_get(bx + off[k], by - 1, C);
        if (mbx == resync_x) A[0] = A[1] = 0;
        *px = median(A[0], B[0], C[0]);
        *py = median(A[1], B[1], C[1]);
      }
    } else {
      mv_get(bx, by - 1, B);
      mv_get(bx + off[k], by - 1, C);
      *px = median(A[0], B[0], C[0]);
      *py = median(A[1], B[1], C[1]);
    }
  }

  int decode_mv_component(int pred) {
    int code = tables().mv.decode(br);
    if (code < 0) throw Error{"MPEG-4 video: bad motion vector code"};
    if (code == 0) return pred;
    int sign = br.get1();
    int shift = fcode - 1, val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= br.get(shift);
      val++;
    }
    if (sign) val = -val;
    val += pred;
    int bits = 5 + fcode;  // wrap into [-16 << fcode, (16 << fcode) - 1]
    val = (int)((uint32_t)val << (32 - bits)) >> (32 - bits);
    return val;
  }

  // ---- motion compensation

  void mc_block(const Plane& src, int ew, int eh, Plane& dst, int x0, int y0, int bw, int bh,
                int mx, int my) {
    int ix = x0 + (mx >> 1), iy = y0 + (my >> 1);
    int fx = mx & 1, fy = my & 1;
    int r1 = 1 - rounding, r2 = 2 - rounding;
    if (ix >= 0 && iy >= 0 && ix + bw + fx <= ew && iy + bh + fy <= eh) {
      // inside the frame: no edge replication needed
      for (int j = 0; j < bh; j++) {
        const uint8_t* a = src.px.data() + (size_t)(iy + j) * src.w + ix;
        const uint8_t* b = a + src.w;
        uint8_t* d = dst.px.data() + (size_t)(y0 + j) * dst.w + x0;
        if (!fx && !fy) {
          memcpy(d, a, bw);
        } else if (fx && !fy) {
          for (int i = 0; i < bw; i++) d[i] = (uint8_t)((a[i] + a[i + 1] + r1) >> 1);
        } else if (!fx && fy) {
          for (int i = 0; i < bw; i++) d[i] = (uint8_t)((a[i] + b[i] + r1) >> 1);
        } else {
          for (int i = 0; i < bw; i++)
            d[i] = (uint8_t)((a[i] + a[i + 1] + b[i] + b[i + 1] + r2) >> 2);
        }
      }
      return;
    }
    auto at = [&](int x, int y) -> int {
      x = x < 0 ? 0 : (x >= ew ? ew - 1 : x);
      y = y < 0 ? 0 : (y >= eh ? eh - 1 : y);
      return src.px[(size_t)y * src.w + x];
    };
    for (int j = 0; j < bh; j++) {
      uint8_t* d = dst.px.data() + (size_t)(y0 + j) * dst.w + x0;
      for (int i = 0; i < bw; i++) {
        int x = ix + i, y = iy + j, v;
        if (!fx && !fy) {
          v = at(x, y);
        } else if (fx && !fy) {
          v = (at(x, y) + at(x + 1, y) + r1) >> 1;
        } else if (!fx && fy) {
          v = (at(x, y) + at(x, y + 1) + r1) >> 1;
        } else {
          v = (at(x, y) + at(x + 1, y) + at(x, y + 1) + at(x + 1, y + 1) + r2) >> 2;
        }
        d[i] = (uint8_t)v;
      }
    }
  }

  static int round_chroma4(int x) {
    static const uint8_t tab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
    return tab[x & 0xf] + ((x >> 3) & ~1);
  }

  void motion_compensate(int mbx, int mby, int mv[4][2], bool four) {
    int ew = edge_w, eh = edge_h;
    if (!four) {
      mc_block(ref.p[0], ew, eh, cur.p[0], mbx * 16, mby * 16, 16, 16, mv[0][0], mv[0][1]);
    } else {
      for (int k = 0; k < 4; k++)
        mc_block(ref.p[0], ew, eh, cur.p[0], mbx * 16 + 8 * (k & 1), mby * 16 + 8 * (k >> 1), 8,
                 8, mv[k][0], mv[k][1]);
    }
    int cx, cy;
    if (!four) {
      cx = (mv[0][0] >> 1) | (mv[0][0] & 1);
      cy = (mv[0][1] >> 1) | (mv[0][1] & 1);
    } else {
      cx = round_chroma4(mv[0][0] + mv[1][0] + mv[2][0] + mv[3][0]);
      cy = round_chroma4(mv[0][1] + mv[1][1] + mv[2][1] + mv[3][1]);
    }
    for (int c = 1; c < 3; c++)
      mc_block(ref.p[c], ew >> 1, eh >> 1, cur.p[c], mbx * 8, mby * 8, 8, 8, cx, cy);
  }

  // ---- blocks

  // DC predictor of block (comp, bx, by): returns the prediction of the
  // reconstructed DC; *dir = 0 left, 1 top.
  int pred_dc(int comp, int bx, int by, int* dir) {
    int a = avail(comp, bx - 1, by) ? dc_at(comp, bx - 1, by) : 1024;
    int b = avail(comp, bx - 1, by - 1) ? dc_at(comp, bx - 1, by - 1) : 1024;
    int c = avail(comp, bx, by - 1) ? dc_at(comp, bx, by - 1) : 1024;
    if (std::abs(a - b) < std::abs(b - c)) {
      *dir = 1;
      return c;
    }
    *dir = 0;
    return a;
  }

  // Reads one block's TCOEF events into blk (natural order) along `scan`,
  // from scan position i + 1; with qmul, dequantises H.263-style on the way.
  void read_tcoef(const RlTable& rl, int16_t* blk, const uint8_t* scan, int i, int qmul,
                  int qadd) {
    BitReader& b = br;
    while (true) {
      int s = rl.vlc.decode(b);
      if (s < 0) throw Error{"MPEG-4 video: bad TCOEF code"};
      int last, run, level;
      if (s == 102) {  // escape
        if (!b.get1()) {  // type 1: level offset
          s = rl.vlc.decode(b);
          if (s < 0 || s == 102) throw Error{"MPEG-4 video: bad escaped TCOEF code"};
          last = s >= rl.last_start;
          run = rl.run[s];
          level = rl.level[s] + rl.max_level[last][run];
          if (b.get1()) level = -level;
        } else if (!b.get1()) {  // type 2: run offset
          s = rl.vlc.decode(b);
          if (s < 0 || s == 102) throw Error{"MPEG-4 video: bad escaped TCOEF code"};
          last = s >= rl.last_start;
          level = rl.level[s];
          run = rl.run[s] + rl.max_run[last][level] + 1;
          if (b.get1()) level = -level;
        } else {  // type 3: fixed length
          last = b.get1();
          run = b.get(6);
          b.marker("escape run");
          level = (int)(b.get(12) << 20) >> 20;
          b.marker("escape level");
          if (level == 0) throw Error{"MPEG-4 video: escaped level 0"};
        }
      } else {
        last = s >= rl.last_start;
        run = rl.run[s];
        level = rl.level[s];
        if (b.get1()) level = -level;
      }
      i += run + 1;
      if (i > 63) throw Error{"MPEG-4 video: more than 64 coefficients in a block"};
      if (qmul) level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
      blk[scan[i]] = (int16_t)level;
      if (last) break;
    }
  }

  void decode_intra_block(int mbx, int mby, int n, bool coded, bool ac_pred, bool dc_vlc) {
    const Tables& t = tables();
    int comp = n < 4 ? 0 : n - 3;
    int bx = comp == 0 ? 2 * mbx + (n & 1) : mbx, by = comp == 0 ? 2 * mby + (n >> 1) : mby;
    int scale = comp == 0 ? kYDcScale[qp] : kCDcScale[qp];
    int16_t blk[64];
    memset(blk, 0, sizeof(blk));
    int dir;
    int pred = pred_dc(comp, bx, by, &dir);
    const uint8_t* scan = !ac_pred ? kZigzag : (dir == 0 ? kAltV : kAltH);
    int i = -1;
    if (dc_vlc) {
      int size = (comp == 0 ? t.dc_lum : t.dc_chrom).decode(br);
      if (size < 0) throw Error{"MPEG-4 video: bad DC size code"};
      int diff = 0;
      if (size) {
        diff = br.get(size);
        if (!(diff >> (size - 1))) diff = diff - (1 << size) + 1;
        if (size > 8) br.marker("DC differential");
      }
      blk[0] = (int16_t)diff;
      i = 0;
    }
    if (coded) read_tcoef(t.intra, blk, scan, i, 0, 0);
    // DC: add the prediction, keep the reconstructed DC for the neighbours
    int level = blk[0] + (pred + (scale >> 1)) / scale;
    blk[0] = (int16_t)level;
    int rec = level * scale;
    if (rec & ~2047) rec = rec < 0 ? 0 : 2047;
    dc_at(comp, bx, by) = rec;
    // AC prediction
    int16_t* store = ac_at(comp, bx, by);
    int cur_q = qp;
    if (ac_pred) {
      if (dir == 0) {
        if (avail(comp, bx - 1, by)) {
          int16_t* a = ac_at(comp, bx - 1, by);
          int qa = mb_qp[mb_of(comp, bx - 1, by)];
          for (int k = 1; k < 8; k++)
            blk[k * 8] = (int16_t)(blk[k * 8] + rescale(a[k], qa, cur_q));
        }
      } else {
        if (avail(comp, bx, by - 1)) {
          int16_t* c = ac_at(comp, bx, by - 1);
          int qc = mb_qp[mb_of(comp, bx, by - 1)];
          for (int k = 1; k < 8; k++) blk[k] = (int16_t)(blk[k] + rescale(c[8 + k], qc, cur_q));
        }
      }
    }
    for (int k = 1; k < 8; k++) {
      store[k] = blk[k * 8];
      store[8 + k] = blk[k];
    }
    // dequantise
    blk[0] = (int16_t)(blk[0] * scale);
    if (quant_type == 0) {
      int qmul = 2 * qp, qadd = (qp - 1) | 1;
      for (int k = 1; k < 64; k++) {
        int l = blk[k];
        if (l) blk[k] = (int16_t)(l > 0 ? l * qmul + qadd : l * qmul - qadd);
      }
    } else {
      for (int k = 1; k < 64; k++) {
        int l = blk[k];
        if (!l) continue;
        int v = (std::abs(l) * qp * 2 * intra_mat[k]) >> 4;
        blk[k] = (int16_t)(l < 0 ? -v : v);
      }
    }
    int res[64];
    idct(blk, res);
    Plane& p = cur.p[comp];
    int x0 = comp == 0 ? mbx * 16 + 8 * (n & 1) : mbx * 8;
    int y0 = comp == 0 ? mby * 16 + 8 * (n >> 1) : mby * 8;
    for (int r = 0; r < 8; r++) {
      uint8_t* d = p.row(y0 + r) + x0;
      for (int c = 0; c < 8; c++) d[c] = clip8(res[r * 8 + c]);
    }
  }

  static int rescale(int v, int qsrc, int qdst) {
    if (qsrc == qdst || v == 0) return v;
    int a = v * qsrc;
    return a > 0 ? (a + (qdst >> 1)) / qdst : (a - (qdst >> 1)) / qdst;
  }

  void decode_inter_block(int mbx, int mby, int n) {
    int comp = n < 4 ? 0 : n - 3;
    int16_t blk[64];
    memset(blk, 0, sizeof(blk));
    if (quant_type == 0) {
      read_tcoef(tables().inter, blk, kZigzag, -1, 2 * qp, (qp - 1) | 1);
    } else {
      read_tcoef(tables().inter, blk, kZigzag, -1, 0, 0);
      int sum = -1;
      for (int k = 0; k < 64; k++) {
        int l = blk[k];
        if (!l) continue;
        int v = ((2 * std::abs(l) + 1) * qp * inter_mat[k]) >> 4;
        blk[k] = (int16_t)(l < 0 ? -v : v);
        sum += blk[k];
      }
      blk[63] ^= sum & 1;
    }
    int res[64];
    idct(blk, res);
    Plane& p = cur.p[comp];
    int x0 = comp == 0 ? mbx * 16 + 8 * (n & 1) : mbx * 8;
    int y0 = comp == 0 ? mby * 16 + 8 * (n >> 1) : mby * 8;
    for (int r = 0; r < 8; r++) {
      uint8_t* d = p.row(y0 + r) + x0;
      for (int c = 0; c < 8; c++) d[c] = clip8(d[c] + res[r * 8 + c]);
    }
  }

  void set_qp(int d) { qp = std::min(31, std::max(1, qp + d)); }

  void decode_intra_mb(int mbx, int mby) {
    int s;
    do {
      s = tables().intra_mcbpc.decode(br);
      if (s < 0) throw Error{"MPEG-4 video: bad intra MCBPC code"};
    } while (s == 8);
    finish_intra_mb(mbx, mby, mby * mbw + mbx, s & 3, s >= 4);
  }

  void finish_intra_mb(int mbx, int mby, int mb, int cbpc, int quant) {
    bool ac_pred = br.get1();
    int cbpy = tables().cbpy.decode(br);
    if (cbpy < 0) throw Error{"MPEG-4 video: bad CBPY code"};
    bool dc_vlc = qp < dc_thr;
    if (quant) set_qp(kDquant[br.get(2)]);
    mb_intra[mb] = 1;
    mb_qp[mb] = (uint8_t)qp;
    int zero[4][2] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};
    set_mvs(mbx, mby, zero);
    int cbp = (cbpy << 2) | cbpc;
    for (int n = 0; n < 6; n++)
      decode_intra_block(mbx, mby, n, (cbp >> (5 - n)) & 1, ac_pred, dc_vlc);
  }

  void decode_p_mb(int mbx, int mby) {
    int mb = mby * mbw + mbx;
    int s;
    while (true) {
      if (br.get1()) {  // not_coded
        mb_intra[mb] = 0;
        mb_qp[mb] = (uint8_t)qp;
        clear_pred(mbx, mby);
        int zero[4][2] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};
        set_mvs(mbx, mby, zero);
        motion_compensate(mbx, mby, zero, false);
        return;
      }
      s = tables().inter_mcbpc.decode(br);
      if (s < 0) throw Error{"MPEG-4 video: bad inter MCBPC code"};
      if (s != 20) break;
    }
    int row = s >> 2, cbpc = s & 3;
    // rows: inter, intra, inter+q, intra+q, inter4v
    if (row == 1 || row == 3) {
      finish_intra_mb(mbx, mby, mb, cbpc, row == 3);
      return;
    }
    int cbpy = tables().cbpy.decode(br);
    if (cbpy < 0) throw Error{"MPEG-4 video: bad CBPY code"};
    cbpy ^= 0xf;
    if (row == 2) set_qp(kDquant[br.get(2)]);
    mb_intra[mb] = 0;
    mb_qp[mb] = (uint8_t)qp;
    clear_pred(mbx, mby);
    int mv[4][2];
    bool four = row == 4;
    if (!four) {
      int px, py;
      pred_motion(mbx, mby, 0, &px, &py);
      int mx = decode_mv_component(px);
      int my = decode_mv_component(py);
      for (auto& m : mv) {
        m[0] = mx;
        m[1] = my;
      }
      set_mvs(mbx, mby, mv);
    } else {
      for (int k = 0; k < 4; k++) {
        int px, py;
        pred_motion(mbx, mby, k, &px, &py);
        mv[k][0] = decode_mv_component(px);
        mv[k][1] = decode_mv_component(py);
        int16_t* m = mv_at(2 * mbx + (k & 1), 2 * mby + (k >> 1));
        m[0] = (int16_t)mv[k][0];
        m[1] = (int16_t)mv[k][1];
      }
    }
    motion_compensate(mbx, mby, mv, four);
    int cbp = (cbpy << 2) | cbpc;
    for (int n = 0; n < 6; n++)
      if ((cbp >> (5 - n)) & 1) decode_inter_block(mbx, mby, n);
  }
};

// ---------------------------------------------------------------- colour

// swscale's unscaled yuv420p -> packed RGB (x86 SIMD form): every term is
// pmulhw((x << 3) - offset, coefficient), the sum saturates to 0..255.
// Coefficients: BT.601 limited range, ff_yuv2rgb_coeffs scaled by 2^13 / 2^16.
inline int mulhw(int a, int b) { return (a * b) >> 16; }
const int kYCoeff = 9539, kVrCoeff = 13075, kUbCoeff = 16525, kUgCoeff = -3209,
          kVgCoeff = -6660, kYOffset = 128;

void yuv_to_rgb(const Frame& f, int width, int height, uint8_t* rgb) {
  const Plane &Y = f.p[0], &U = f.p[1], &V = f.p[2];
  for (int y = 0; y < height; y++) {
    const uint8_t* py = Y.px.data() + (size_t)y * Y.w;
    const uint8_t* pu = U.px.data() + (size_t)(y >> 1) * U.w;
    const uint8_t* pv = V.px.data() + (size_t)(y >> 1) * V.w;
    uint8_t* d = rgb + (size_t)y * width * 3;
    for (int x = 0; x < width; x++) {
      int u = (pu[x >> 1] << 3) - 1024, v = (pv[x >> 1] << 3) - 1024;
      int yy = mulhw((py[x] << 3) - kYOffset, kYCoeff);
      int r = yy + mulhw(v, kVrCoeff);
      int g = yy + mulhw(u, kUgCoeff) + mulhw(v, kVgCoeff);
      int b = yy + mulhw(u, kUbCoeff);
      d[3 * x] = clip8(r);
      d[3 * x + 1] = clip8(g);
      d[3 * x + 2] = clip8(b);
    }
  }
}

// ---------------------------------------------------------------- encoder

struct Encoder {
  int width, height, mbw, mbh, qp, fps_num, fps_den, time_bits;
  int dc_y_scale, dc_c_scale;
  float inv_step;  // 1 / (2 qp)
  std::vector<int> dc_y, dc_c[2];  // reconstructed DC per block this frame
  Frame src;

  Encoder(int w, int h, int q, int res, int incr)
      : width(w), height(h), qp(q), fps_num(res), fps_den(incr) {
    mbw = (w + 15) / 16;
    mbh = (h + 15) / 16;
    time_bits = 1;
    while ((1 << time_bits) < fps_num) time_bits++;
    inv_step = 1.0f / (2 * qp);
    dc_y_scale = kYDcScale[qp];
    dc_c_scale = kCDcScale[qp];
    src.alloc(mbw, mbh);
  }

  std::vector<uint8_t> headers() const {
    BitWriter w;
    w.start_code(0xb0);  // visual_object_sequence
    w.put(0x01, 8);      // Simple Profile @ Level 1
    w.start_code(0xb5);  // visual_object
    w.put(1, 1);         // is_visual_object_identifier
    w.put(1, 4);         // visual_object_verid
    w.put(1, 3);         // visual_object_priority
    w.put(1, 4);         // visual_object_type: video
    w.put(0, 1);         // video_signal_type
    w.stuff();
    w.start_code(0x00);  // video_object
    w.start_code(0x20);  // video_object_layer
    w.put(0, 1);         // random_accessible_vol
    w.put(1, 8);         // video_object_type_indication: Simple Object
    w.put(1, 1);         // is_object_layer_identifier
    w.put(1, 4);         // video_object_layer_verid
    w.put(1, 3);         // video_object_layer_priority
    w.put(1, 4);         // aspect_ratio_info: square
    w.put(1, 1);         // vol_control_parameters
    w.put(1, 2);         // chroma_format 4:2:0
    w.put(1, 1);         // low_delay
    w.put(0, 1);         // vbv_parameters
    w.put(0, 2);         // shape: rectangular
    w.put(1, 1);
    w.put(fps_num, 16);  // vop_time_increment_resolution
    w.put(1, 1);
    if (fps_den < fps_num) {
      w.put(1, 1);  // fixed_vop_rate
      w.put(fps_den, time_bits);
    } else {
      w.put(0, 1);
    }
    w.put(1, 1);
    w.put(width, 13);
    w.put(1, 1);
    w.put(height, 13);
    w.put(1, 1);
    w.put(0, 1);  // interlaced
    w.put(1, 1);  // obmc_disable
    w.put(0, 1);  // sprite_enable
    w.put(0, 1);  // not_8_bit
    w.put(0, 1);  // quant_type: H.263
    w.put(1, 1);  // complexity_estimation_disable
    w.put(1, 1);  // resync_marker_disable
    w.put(0, 1);  // data_partitioned
    w.put(0, 1);  // scalability
    w.stuff();
    return w.out;
  }

  // BT.601 limited range, chroma the mean of each 2x2 block; the frame is
  // replicated at its right and bottom edges up to the macroblock grid.
  void load_rgb(const uint8_t* rgb) {
    Plane& Y = src.p[0];
    for (int y = 0; y < Y.h; y++) {
      const uint8_t* row = rgb + (size_t)std::min(y, height - 1) * width * 3;
      uint8_t* o = Y.px.data() + (size_t)y * Y.w;
      for (int x = 0; x < Y.w; x++) {
        const uint8_t* p = row + (size_t)std::min(x, width - 1) * 3;
        o[x] = (uint8_t)(((66 * p[0] + 129 * p[1] + 25 * p[2] + 128) >> 8) + 16);
      }
    }
    for (int y = 0; y < src.p[1].h; y++) {
      for (int x = 0; x < src.p[1].w; x++) {
        int r = 0, g = 0, b = 0;
        for (int j = 0; j < 2; j++)
          for (int i = 0; i < 2; i++) {
            int sy = std::min(2 * y + j, height - 1), sx = std::min(2 * x + i, width - 1);
            const uint8_t* p = rgb + ((size_t)sy * width + sx) * 3;
            r += p[0];
            g += p[1];
            b += p[2];
          }
        // the 2x2 sums carry two extra bits: shift by 10 instead of 8
        src.p[1].px[(size_t)y * src.p[1].w + x] =
            clip8(((-38 * r - 74 * g + 112 * b + 512) >> 10) + 128);
        src.p[2].px[(size_t)y * src.p[2].w + x] =
            clip8(((112 * r - 94 * g - 18 * b + 512) >> 10) + 128);
      }
    }
  }

  // the orthonormal 8x8 DCT-II (F[0][0] = 8 x the block mean), separable
  static void fdct(const float in[64], float out[64]) {
    // a magic static: built once, safely, when encoders run in several threads
    struct Basis {
      float c[8][8];
    };
    static const Basis basis = [] {
      Basis b;
      for (int k = 0; k < 8; k++)
        for (int n = 0; n < 8; n++)
          b.c[k][n] = (float)((k == 0 ? std::sqrt(0.125) : 0.5) * std::cos((2 * n + 1) * k * M_PI / 16));
      return b;
    }();
    const auto& c = basis.c;
    // innermost loops over independent outputs, so that they vectorise
    float tmp[64] = {0};
    for (int r = 0; r < 8; r++)
      for (int n = 0; n < 8; n++) {
        float x = in[r * 8 + n];
        for (int k = 0; k < 8; k++) tmp[r * 8 + k] += c[k][n] * x;
      }
    for (int i = 0; i < 64; i++) out[i] = 0;
    for (int k = 0; k < 8; k++)
      for (int n = 0; n < 8; n++) {
        float ck = c[k][n];
        for (int cc = 0; cc < 8; cc++) out[k * 8 + cc] += ck * tmp[n * 8 + cc];
      }
  }

  int quant_ac(float f) const {
    // the level whose H.263 reconstruction 2 qp |l| + ((qp - 1) | 1) is
    // nearest to |f|: 0 below half the first level, else the level whose
    // reconstruction interval (+-qp) holds |f|
    float a = std::fabs(f);
    int qadd = (qp - 1) | 1;
    if (a < 0.5f * (2 * qp + qadd)) return 0;
    int l = std::max(1, (int)((a - qadd + qp) * inv_step));
    l = std::min(l, 2047);
    return f < 0 ? -l : l;
  }

  void put_tcoef(BitWriter& w, int last, int run, int level) const {
    const RlTable& rl = tables().intra;
    int a = std::abs(level), sign = level < 0;
    auto direct = [&](int r, int l) { return (r < 64 && l < 64) ? rl.index[last][r][l] : -1; };
    int i = direct(run, a);
    if (i >= 0) {
      w.put(rl.codes[i][0], rl.codes[i][1]);
      w.put(sign, 1);
      return;
    }
    const uint16_t* esc = rl.codes[102];
    int lmax = run < 64 ? rl.max_level[last][run] : 0;
    if (lmax && a - lmax < 64 && (i = direct(run, a - lmax)) >= 0) {
      w.put(esc[0], esc[1]);
      w.put(0, 1);
      w.put(rl.codes[i][0], rl.codes[i][1]);
      w.put(sign, 1);
      return;
    }
    if (a < 64 && rl.max_level[last][0] >= a) {
      int rmax = rl.max_run[last][a];
      int r2 = run - rmax - 1;
      if (r2 >= 0 && (i = direct(r2, a)) >= 0) {
        w.put(esc[0], esc[1]);
        w.put(2, 2);
        w.put(rl.codes[i][0], rl.codes[i][1]);
        w.put(sign, 1);
        return;
      }
    }
    w.put(esc[0], esc[1]);
    w.put(3, 2);
    w.put(last, 1);
    w.put(run, 6);
    w.put(1, 1);
    w.put((uint32_t)level & 0xfff, 12);
    w.put(1, 1);
  }

  void encode_frame(const uint8_t* rgb, int index, std::vector<uint8_t>& out) {
    load_rgb(rgb);
    BitWriter w;
    w.start_code(0xb6);
    w.put(0, 2);  // I-VOP
    // modulo_time_base: one '1' per second boundary crossed since the last VOP
    long t = (long)index * fps_den, tprev = (long)(index - 1) * fps_den;
    long secs = index == 0 ? 0 : t / fps_num - tprev / fps_num;
    for (long s = 0; s < secs; s++) w.put(1, 1);
    w.put(0, 1);
    w.put(1, 1);
    w.put((uint32_t)(t % fps_num), time_bits);
    w.put(1, 1);
    w.put(1, 1);  // vop_coded
    w.put(0, 3);  // intra_dc_vlc_thr: DC always by its own VLC
    w.put(qp, 5);
    dc_y.assign(mbw * mbh * 4, 1024);
    dc_c[0].assign(mbw * mbh, 1024);
    dc_c[1].assign(mbw * mbh, 1024);
    for (int mby = 0; mby < mbh; mby++)
      for (int mbx = 0; mbx < mbw; mbx++) {
        int levels[6][64];
        int cbp = 0;
        int dcdiff[6];
        for (int n = 0; n < 6; n++) {
          int comp = n < 4 ? 0 : n - 3;
          const Plane& p = src.p[comp];
          int x0 = comp == 0 ? mbx * 16 + 8 * (n & 1) : mbx * 8;
          int y0 = comp == 0 ? mby * 16 + 8 * (n >> 1) : mby * 8;
          float in[64], co[64];
          for (int r = 0; r < 8; r++)
            for (int c = 0; c < 8; c++) in[r * 8 + c] = p.px[(size_t)(y0 + r) * p.w + x0 + c];
          fdct(in, co);
          int scale = comp == 0 ? dc_y_scale : dc_c_scale;
          int qdc = (int)std::lround(co[0] / (float)scale);
          qdc = std::max(0, std::min(qdc, 2047 / scale));
          int bx = comp == 0 ? 2 * mbx + (n & 1) : mbx, by = comp == 0 ? 2 * mby + (n >> 1) : mby;
          int gw = comp == 0 ? 2 * mbw : mbw;
          auto dc = [&](int x, int y) -> int {
            if (x < 0 || y < 0) return 1024;
            return comp == 0 ? dc_y[y * gw + x] : dc_c[comp - 1][y * gw + x];
          };
          int a = dc(bx - 1, by), b = dc(bx - 1, by - 1), c = dc(bx, by - 1);
          int pred = std::abs(a - b) < std::abs(b - c) ? c : a;
          dcdiff[n] = qdc - (pred + (scale >> 1)) / scale;
          (comp == 0 ? dc_y[by * gw + bx] : dc_c[comp - 1][by * gw + bx]) = qdc * scale;
          bool any = false;
          levels[n][0] = 0;
          for (int k = 1; k < 64; k++) {
            levels[n][k] = quant_ac(co[k]);
            any |= levels[n][k] != 0;
          }
          if (any) cbp |= 1 << (5 - n);
        }
        int cbpc = cbp & 3, cbpy = cbp >> 2;
        w.put(kIntraMcbpc[cbpc][0], kIntraMcbpc[cbpc][1]);
        w.put(0, 1);  // ac_pred_flag
        w.put(kCbpy[cbpy][0], kCbpy[cbpy][1]);
        for (int n = 0; n < 6; n++) {
          int d = dcdiff[n], a = std::abs(d), size = 0;
          while ((1 << size) <= a) size++;
          const uint8_t(*tab)[2] = n < 4 ? kDcLum : kDcChrom;
          w.put(tab[size][0], tab[size][1]);
          if (size) {
            w.put(d > 0 ? d : d + (1 << size) - 1, size);
            if (size > 8) w.put(1, 1);
          }
          if (!((cbp >> (5 - n)) & 1)) continue;
          int lastpos = 0;
          for (int k = 1; k < 64; k++)
            if (levels[n][kZigzag[k]]) lastpos = k;
          int run = 0;
          for (int k = 1; k <= lastpos; k++) {
            int l = levels[n][kZigzag[k]];
            if (!l) {
              run++;
              continue;
            }
            put_tcoef(w, k == lastpos, run, l);
            run = 0;
          }
        }
      }
    w.stuff();
    out.insert(out.end(), w.out.begin(), w.out.end());
  }
};

thread_local std::string g_error;

int fail(const std::string& m) {
  g_error = m;
  return -1;
}

}  // namespace

extern "C" {

const char* m4v_last_error() { return g_error.c_str(); }

// The frame size that the headers in `dsi` (and, failing those, in the
// first sample) declare.
int m4v_probe(const uint8_t* dsi, int64_t dsi_len, const uint8_t* first, int64_t first_len,
              int* width, int* height) {
  try {
    Decoder d;
    size_t i = 0;
    for (const uint8_t* buf : {dsi, first}) {
      int64_t n = buf == dsi ? dsi_len : first_len;
      if (!buf || n <= 0) continue;
      for (i = 0; i + 4 <= (size_t)n; i++) {
        if (buf[i] == 0 && buf[i + 1] == 0 && buf[i + 2] == 1 && buf[i + 3] >= 0x20 &&
            buf[i + 3] <= 0x2f) {
          BitReader b;
          b.buf = buf + i + 4;
          b.size = n - i - 4;
          d.parse_vol(b);
          *width = d.width;
          *height = d.height;
          return 0;
        }
      }
    }
    return fail("MPEG-4 video: no video object layer header found");
  } catch (const Error& e) {
    return fail(e.msg);
  }
}

// Decode `n` samples (concatenated in `data`, sample i at offsets[i] with
// sizes[i]) into out: `max_frames` frames of height x width x 3 (RGB) at
// m4v_probe's size; decoding stops after max_frames frames. Returns the
// number of frames output, or -1 (m4v_last_error says why).
int64_t m4v_decode(const uint8_t* dsi, int64_t dsi_len, const uint8_t* data, const int64_t* offsets,
                   const int64_t* sizes, int64_t n, uint8_t* out, int64_t max_frames, int width,
                   int height) {
  try {
    Decoder d;
    if (dsi && dsi_len > 0) d.decode_buffer(dsi, dsi_len);
    int64_t frames = 0;
    for (int64_t s = 0; s < n && frames < max_frames; s++) {
      if (!d.decode_buffer(data + offsets[s], (size_t)sizes[s])) continue;
      if (d.width != width || d.height != height)
        return fail("MPEG-4 video: the frame size changed within the stream");
      yuv_to_rgb(d.ref, width, height, out + (size_t)frames * width * height * 3);
      frames++;
    }
    return frames;
  } catch (const Error& e) {
    return fail(e.msg);
  }
}

// Encode `n` RGB frames (height x width x 3, contiguous) as I-VOPs at the
// fixed quantiser `qp` (1-31) and a frame rate of res / incr. Headers go to
// `dsi` (capacity 64 bytes; *dsi_len gets their size); the samples are
// appended into `out` (capacity `cap`), sample i's size in sizes[i].
// Returns the bytes written, or -1.
int64_t m4v_encode(const uint8_t* rgb, int64_t n, int width, int height, int qp, int res, int incr,
                   uint8_t* dsi, int64_t* dsi_len, uint8_t* out, int64_t cap, int64_t* sizes) {
  try {
    if (width <= 0 || height <= 0 || width >= 8192 || height >= 8192)
      return fail("MPEG-4 video: frame size out of range");
    if (qp < 1 || qp > 31) return fail("MPEG-4 video: quantiser out of 1-31");
    if (res <= 0 || res >= 65536 || incr <= 0 || incr >= 65536)
      return fail("MPEG-4 video: frame rate out of range");
    Encoder e(width, height, qp, res, incr);
    std::vector<uint8_t> h = e.headers();
    if ((int64_t)h.size() > 64) return fail("MPEG-4 video: header buffer too small");
    memcpy(dsi, h.data(), h.size());
    *dsi_len = (int64_t)h.size();
    int64_t total = 0;
    std::vector<uint8_t> buf;
    for (int64_t i = 0; i < n; i++) {
      buf.clear();
      e.encode_frame(rgb + (size_t)i * width * height * 3, (int)i, buf);
      if (total + (int64_t)buf.size() > cap) return fail("MPEG-4 video: output buffer too small");
      memcpy(out + total, buf.data(), buf.size());
      sizes[i] = (int64_t)buf.size();
      total += (int64_t)buf.size();
    }
    return total;
  } catch (const Error& e) {
    return fail(e.msg);
  }
}

}  // extern "C"
