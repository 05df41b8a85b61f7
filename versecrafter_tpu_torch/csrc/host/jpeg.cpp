// Baseline, extended sequential and progressive Huffman JPEG (SOF0 / SOF1 /
// SOF2), 8-bit, one, three or four (Adobe CMYK) components, sampling
// factors up to 2x2, restart markers; behind a plain C interface (loaded
// with ctypes).
//
// The samples are those libjpeg-turbo gives with its defaults, as OpenCV's
// imread uses it: the ISLOW integer IDCT (jidctint.c), fancy (triangle)
// upsampling for h2v1, h1v2 and h2v2 chroma (jdsample.c, box replication
// where the component is 2 samples wide or less, or the ratio is another
// integer), and the fixed-point YCbCr -> RGB tables of jdcolor.c.
// libjpeg-turbo's SIMD forms of all three give the same samples as these.
//
// A progressive file's scans (DC and AC, first and refinement, spectral
// selection, successive approximation, EOB runs, restarts) fill each
// component's coefficient blocks; the same IDCT, upsampling and colour
// tables then make its samples. Non-interleaved scans cover the
// component's own ceil(w/8) x ceil(h/8) blocks, not the MCU-padded grid.
// A CMYK image becomes RGB as OpenCV's IMREAD_COLOR makes it BGR
// (icvCvt_CMYK2BGR_8u_C4C3R), and grey as IMREAD_GRAYSCALE does.
//
// Lossless (SOF3), hierarchical (SOF5-7) and arithmetic-coded (SOF9-15)
// files, 12-bit samples, YCCK images, and progressive files that
// libjpeg-turbo would block-smooth (coefficients left unrefined, as in a
// truncated file) or whose data ends inside a scan raise an error that
// names them.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

const char* const kTruncated = "JPEG: truncated progressive JPEG (its data ends inside a scan)";

const uint8_t kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63,
    // extra entries so that a corrupt run past 63 lands harmlessly
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  // canonical decoding: maxcode / valoffset per length, plus an 9-bit table
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  int16_t fast_sym[512];
  uint8_t fast_len[512];

  void build(const uint8_t bits[17], const uint8_t* huffval, int nvals) {
    memcpy(vals, huffval, nvals);
    int code = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = k - code;
        code += bits[l];
        k += bits[l];
        maxcode[l] = code - 1;
      } else {
        maxcode[l] = -1;
      }
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    for (int i = 0; i < 512; i++) {
      fast_sym[i] = -1;
      fast_len[i] = 0;
    }
    code = 0;
    k = 0;
    for (int l = 1; l <= 9; l++) {
      for (int i = 0; i < bits[l]; i++, k++, code++) {
        int shift = 9 - l;
        for (int j = 0; j < (1 << shift); j++) {
          fast_sym[(code << shift) | j] = vals[k];
          fast_len[(code << shift) | j] = (uint8_t)l;
        }
      }
      code <<= 1;
    }
    defined = true;
  }
};

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int dc_pred = 0;
  int bw = 0, bh = 0;        // blocks per line / column in the plane
  int dw = 0, dh = 0;        // downsampled width / height
  std::vector<uint8_t> px;   // bw*8 x bh*8 samples
  // progressive: the coefficients (bw x bh blocks of 64, natural order) and
  // the successive-approximation bit each zigzag position was last left at
  // (-1 before any scan reached it), as libjpeg's coef_bits
  std::vector<int16_t> coef;
  int coef_bits[64];
};

struct Decoder {
  const uint8_t* data;
  size_t n, pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  bool have_frame = false, progressive = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[4];

  // entropy-coded segment reader; `pad` counts the zero bits fed after the
  // data ended, and ran_out records that a scan read into them
  uint32_t bitbuf = 0;
  int bitcnt = 0, pad = 0;
  bool hit_marker = false, ran_out = false;
  int eobrun = 0;

  uint8_t byte() {
    if (pos >= n) throw Error{"JPEG: unexpected end of file (truncated?)"};
    return data[pos++];
  }
  int u16() {
    int a = byte();
    return (a << 8) | byte();
  }

  void fill() {
    while (bitcnt <= 24) {
      uint32_t b = 0;
      if (!hit_marker && pos < n) {
        b = data[pos];
        if (b == 0xff) {
          uint8_t nx = pos + 1 < n ? data[pos + 1] : 0;
          if (nx == 0x00) {
            pos += 2;
          } else {
            hit_marker = true;  // leave the marker; feed zeros
            b = 0;
          }
        } else {
          pos++;
        }
      } else {
        pad += 8;
      }
      bitbuf |= b << (24 - bitcnt);
      bitcnt += 8;
    }
  }
  void consume(int k) {
    bitbuf <<= k;
    bitcnt -= k;
    if (bitcnt < pad) {
      ran_out = true;
      pad = bitcnt;
    }
  }
  int get_bits(int k) {
    if (k == 0) return 0;
    fill();
    int v = (int)(bitbuf >> (32 - k));
    consume(k);
    return v;
  }
  int decode(const Huffman& h) {
    fill();
    int idx = (int)(bitbuf >> (32 - 9));
    if (h.fast_len[idx]) {
      int l = h.fast_len[idx];
      consume(l);
      return h.fast_sym[idx];
    }
    int code = (int)(bitbuf >> (32 - 10));
    int l = 10;
    while (l <= 16 && code > h.maxcode[l]) {
      l++;
      code = (int)(bitbuf >> (32 - l));
    }
    if (l > 16) throw Error{"JPEG: corrupt Huffman code"};
    consume(l);
    return h.vals[code + h.valoffset[l]];
  }
  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  void reset_bits() {
    bitbuf = 0;
    bitcnt = 0;
    pad = 0;
    hit_marker = false;
  }

  void parse_sof(bool prog) {
    if (have_frame) throw Error{"JPEG: more than one frame header"};
    progressive = prog;
    int len = u16();
    size_t end = pos + len - 2;
    int precision = byte();
    if (precision != 8)
      throw Error{"JPEG: " + std::to_string(precision) + "-bit samples are not supported"};
    height = u16();
    width = u16();
    ncomp = byte();
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      throw Error{"JPEG: " + std::to_string(ncomp) + "-component images are not supported"};
    if (width == 0 || height == 0) throw Error{"JPEG: zero image size (DNL is not supported)"};
    for (int i = 0; i < ncomp; i++) {
      comp[i].id = byte();
      int hv = byte();
      comp[i].h = hv >> 4;
      comp[i].v = hv & 15;
      comp[i].tq = byte();
      if (comp[i].h < 1 || comp[i].h > 2 || comp[i].v < 1 || comp[i].v > 2)
        throw Error{"JPEG: sampling factors above 2 are not supported"};
      if (comp[i].tq > 3) throw Error{"JPEG: bad quantisation table index"};
    }
    pos = end;
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; i++) {
      hmax = std::max(hmax, comp[i].h);
      vmax = std::max(vmax, comp[i].v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.px.assign((size_t)c.bw * 8 * c.bh * 8, 0);
      if (progressive) {
        c.coef.assign((size_t)c.bw * c.bh * 64, 0);
        for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
      }
    }
    have_frame = true;
  }

  void parse_dht() {
    int len = u16();
    size_t end = pos + len - 2;
    while (pos < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw Error{"JPEG: bad Huffman table index"};
      uint8_t bits[17] = {0};
      int total = 0;
      for (int i = 1; i <= 16; i++) {
        bits[i] = byte();
        total += bits[i];
      }
      if (total > 256) throw Error{"JPEG: bad Huffman table"};
      uint8_t vals[256];
      for (int i = 0; i < total; i++) vals[i] = byte();
      (tc == 0 ? dc[th] : ac[th]).build(bits, vals, total);
    }
    pos = end;
  }

  void parse_dqt() {
    int len = u16();
    size_t end = pos + len - 2;
    while (pos < end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) throw Error{"JPEG: bad quantisation table index"};
      for (int i = 0; i < 64; i++) qt[tq][kNatural[i]] = (uint16_t)(pq ? u16() : byte());
      qt_defined[tq] = true;
    }
    pos = end;
  }

  void parse_app(int marker) {
    int len = u16();
    size_t end = pos + len - 2;
    if (marker == 0xe0 && len >= 7 && !memcmp(data + pos, "JFIF\0", 5)) saw_jfif = true;
    if (marker == 0xee && len >= 14 && !memcmp(data + pos, "Adobe", 5)) {
      saw_adobe = true;
      adobe_transform = data[pos + 11];
    }
    pos = end;
  }

  void decode_block(Component& c, int bx, int by) {
    int16_t coef[64];
    memset(coef, 0, sizeof(coef));
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int s = decode(hd);
    if (s > 15) throw Error{"JPEG: bad DC code"};
    int diff = s ? extend(get_bits(s), s) : 0;
    c.dc_pred += diff;
    coef[0] = (int16_t)c.dc_pred;
    for (int k = 1; k < 64;) {
      int rs = decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        int v = extend(get_bits(s), s);
        coef[kNatural[std::min(k, 79)]] = (int16_t)v;
        k++;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
    idct_islow(coef, qt[c.tq], c.px.data() + (size_t)by * 8 * c.bw * 8 + bx * 8, c.bw * 8);
  }

  // jidctint.c's jpeg_idct_islow
  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    const int CONST_BITS = 13, PASS1_BITS = 2;
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;
    int ws[64];
    auto descale = [](int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; };
    for (int c = 0; c < 8; c++) {
      const int16_t* p = in + c;
      const uint16_t* qq = q + c;
      int* w = ws + c;
      if (!p[8] && !p[16] && !p[24] && !p[32] && !p[40] && !p[48] && !p[56]) {
        int dcval = (p[0] * qq[0]) * (1 << PASS1_BITS);
        for (int k = 0; k < 8; k++) w[8 * k] = dcval;
        continue;
      }
      int64_t z2 = p[16] * qq[16], z3 = p[48] * qq[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = p[0] * qq[0];
      z3 = p[32] * qq[32];
      int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
      int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = p[56] * qq[56];
      tmp1 = p[40] * qq[40];
      tmp2 = p[24] * qq[24];
      tmp3 = p[8] * qq[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CONST_BITS - PASS1_BITS;
      w[0] = (int)descale(tmp10 + tmp3, sh);
      w[56] = (int)descale(tmp10 - tmp3, sh);
      w[8] = (int)descale(tmp11 + tmp2, sh);
      w[48] = (int)descale(tmp11 - tmp2, sh);
      w[16] = (int)descale(tmp12 + tmp1, sh);
      w[40] = (int)descale(tmp12 - tmp1, sh);
      w[24] = (int)descale(tmp13 + tmp0, sh);
      w[32] = (int)descale(tmp13 - tmp0, sh);
    }
    auto limit = [](int64_t x) -> uint8_t {
      // range_limit[x & RANGE_MASK] with IDCT_range_limit's layout
      int i = (int)(x & 1023);
      if (i < 128) return (uint8_t)(i + 128);
      if (i < 512) return 255;
      if (i < 896) return 0;
      return (uint8_t)(i - 896);
    };
    for (int r = 0; r < 8; r++) {
      const int* w = ws + 8 * r;
      uint8_t* o = out + (size_t)r * stride;
      const int sh = CONST_BITS + PASS1_BITS + 3;
      if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
        uint8_t v = limit(descale(w[0], PASS1_BITS + 3));
        for (int k = 0; k < 8; k++) o[k] = v;
        continue;
      }
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
      int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      o[0] = limit(descale(tmp10 + tmp3, sh));
      o[7] = limit(descale(tmp10 - tmp3, sh));
      o[1] = limit(descale(tmp11 + tmp2, sh));
      o[6] = limit(descale(tmp11 - tmp2, sh));
      o[2] = limit(descale(tmp12 + tmp1, sh));
      o[5] = limit(descale(tmp12 - tmp1, sh));
      o[3] = limit(descale(tmp13 + tmp0, sh));
      o[4] = limit(descale(tmp13 - tmp0, sh));
    }
  }

  // Expect RSTn at the current position (after the entropy-coded data).
  void restart() {
    reset_bits();
    while (pos + 1 < n && !(data[pos] == 0xff && data[pos + 1] >= 0xd0 && data[pos + 1] <= 0xd7))
      pos++;
    if (pos + 1 >= n)
      throw Error{progressive ? kTruncated : "JPEG: missing restart marker"};
    pos += 2;
    for (int i = 0; i < ncomp; i++) comp[i].dc_pred = 0;
    eobrun = 0;
  }

  void parse_sos() {
    if (!have_frame) throw Error{"JPEG: scan before frame header"};
    int len = u16();
    size_t end = pos + len - 2;
    int ns = byte();
    if (ns < 1 || ns > ncomp) throw Error{"JPEG: bad scan component count"};
    Component* sc[4];
    for (int i = 0; i < ns; i++) {
      int id = byte(), t = byte();
      sc[i] = nullptr;
      for (int k = 0; k < ncomp; k++)
        if (comp[k].id == id) sc[i] = &comp[k];
      if (!sc[i]) throw Error{"JPEG: scan names an unknown component"};
      sc[i]->td = t >> 4;
      sc[i]->ta = t & 15;
      if (sc[i]->td > 3 || sc[i]->ta > 3) throw Error{"JPEG: bad Huffman table index"};
      if (!qt_defined[sc[i]->tq]) throw Error{"JPEG: undefined quantisation table"};
    }
    int ss = byte(), se = byte(), ahal = byte();
    if (progressive) {
      pos = end;
      progressive_scan(sc, ns, ss, se, ahal >> 4, ahal & 15);
      return;
    }
    for (int i = 0; i < ns; i++)
      if (!dc[sc[i]->td].defined || !ac[sc[i]->ta].defined)
        throw Error{"JPEG: scan uses an undefined Huffman table"};
    if (ss != 0 || se != 63 || ahal != 0)
      throw Error{"JPEG: spectral selection or successive approximation in a sequential scan"};
    pos = end;
    reset_bits();
    for (int i = 0; i < ncomp; i++) comp[i].dc_pred = 0;
    int mcus = 0;
    if (ns == 1) {
      Component& c = *sc[0];
      int bx_n = (c.dw + 7) / 8, by_n = (c.dh + 7) / 8;
      for (int by = 0; by < by_n; by++)
        for (int bx = 0; bx < bx_n; bx++) {
          if (restart_interval && mcus && mcus % restart_interval == 0) restart();
          decode_block(c, bx, by);
          mcus++;
        }
    } else {
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          if (restart_interval && mcus && mcus % restart_interval == 0) restart();
          for (int i = 0; i < ns; i++) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++) decode_block(c, mx * c.h + h, my * c.v + v);
          }
          mcus++;
        }
    }
    skip_to_marker();
  }

  void skip_to_marker() {
    reset_bits();
    while (pos + 1 < n && !(data[pos] == 0xff && data[pos + 1] != 0 &&
                            !(data[pos + 1] >= 0xd0 && data[pos + 1] <= 0xd7)))
      pos++;
  }

  // One scan of a progressive frame (jdphuff.c): DC first / refine over
  // the scan's MCUs, AC first / refine over one component's blocks.
  void progressive_scan(Component** sc, int ns, int ss, int se, int ah, int al) {
    bool dc_scan = ss == 0;
    bool bad = dc_scan ? se != 0 : (se < ss || se > 63 || ns != 1);
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13) bad = true;
    if (bad) throw Error{"JPEG: bad progressive scan parameters"};
    for (int i = 0; i < ns; i++) {
      if (dc_scan && ah == 0 && !dc[sc[i]->td].defined)
        throw Error{"JPEG: scan uses an undefined Huffman table"};
      if (!dc_scan && !ac[sc[i]->ta].defined)
        throw Error{"JPEG: scan uses an undefined Huffman table"};
      for (int k = ss; k <= se; k++) sc[i]->coef_bits[k] = al;
    }
    reset_bits();
    for (int i = 0; i < ncomp; i++) comp[i].dc_pred = 0;
    eobrun = 0;
    auto block = [&](Component& c, int bx, int by) {
      int16_t* b = c.coef.data() + ((size_t)by * c.bw + bx) * 64;
      if (dc_scan && ah == 0) {
        int s = decode(dc[c.td]);
        if (s > 15) throw Error{"JPEG: bad DC code"};
        int diff = s ? extend(get_bits(s), s) : 0;
        c.dc_pred += diff;
        b[0] = (int16_t)((unsigned)c.dc_pred << al);
      } else if (dc_scan) {
        if (get_bits(1)) b[0] = (int16_t)(b[0] | (1 << al));
      } else if (ah == 0) {
        ac_first(c, b, ss, se, al);
      } else {
        ac_refine(c, b, ss, se, al);
      }
    };
    int mcus = 0;
    if (ns == 1) {
      Component& c = *sc[0];
      int bx_n = (c.dw + 7) / 8, by_n = (c.dh + 7) / 8;
      for (int by = 0; by < by_n; by++)
        for (int bx = 0; bx < bx_n; bx++) {
          if (restart_interval && mcus && mcus % restart_interval == 0) restart();
          block(c, bx, by);
          mcus++;
        }
    } else {
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          if (restart_interval && mcus && mcus % restart_interval == 0) restart();
          for (int i = 0; i < ns; i++) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++) block(c, mx * c.h + h, my * c.v + v);
          }
          mcus++;
        }
    }
    if (ran_out) throw Error{kTruncated};
    skip_to_marker();
  }

  void ac_first(Component& c, int16_t* b, int ss, int se, int al) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = decode(ac[c.ta]);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int v = extend(get_bits(s), s);
        b[kNatural[std::min(k, 79)]] = (int16_t)((unsigned)v << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += get_bits(r);
        eobrun--;
        break;
      }
    }
  }

  // Correction bits raise the magnitude of coefficients already nonzero;
  // a new coefficient is +-1 at this bit, after r still-zero positions.
  void ac_refine(Component& c, int16_t* b, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    auto correct = [&](int16_t* coef) {
      if (get_bits(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
    };
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = decode(ac[c.ta]);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = get_bits(1) ? p1 : m1;  // a new coefficient's size is always 1
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += get_bits(r);
          break;
        }
        do {
          int16_t* coef = b + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) b[kNatural[std::min(k, 79)]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* coef = b + kNatural[k];
        if (*coef != 0) correct(coef);
      }
      eobrun--;
    }
  }

  // After the last scan: libjpeg-turbo block-smooths a progressive image
  // whose DC is known and one of the first nine AC coefficients is not
  // refined to its last bit (jdcoefct.c's smoothing_ok); that is not ported.
  // Otherwise every block goes through the IDCT.
  void finish_progressive() {
    bool known = true, useful = false;
    for (int i = 0; i < ncomp; i++) {
      const uint16_t* q = qt[comp[i].tq];
      const int pos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
      for (int p : pos)
        if (q[p] == 0) known = false;
      if (comp[i].coef_bits[0] < 0) known = false;
      for (int k = 1; k < 10; k++)
        if (comp[i].coef_bits[k] != 0) useful = true;
    }
    if (known && useful)
      throw Error{"JPEG: progressive JPEG with coefficients left unrefined (a truncated "
                  "file?): libjpeg-turbo's block smoothing is not supported"};
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      for (int by = 0; by < c.bh; by++)
        for (int bx = 0; bx < c.bw; bx++)
          idct_islow(c.coef.data() + ((size_t)by * c.bw + bx) * 64, qt[c.tq],
                     c.px.data() + (size_t)by * 8 * c.bw * 8 + bx * 8, c.bw * 8);
    }
  }

  void parse(bool headers_only) {
    if (n < 4 || data[0] != 0xff || data[1] != 0xd8) throw Error{"JPEG: no SOI marker"};
    pos = 2;
    while (pos < n) {
      if (data[pos] != 0xff) {
        pos++;
        continue;
      }
      while (pos < n && data[pos] == 0xff) pos++;
      if (pos >= n) break;
      int m = data[pos++];
      if (m == 0xd9) return;  // EOI
      if (m >= 0xd0 && m <= 0xd7) continue;
      switch (m) {
        case 0xc0:
        case 0xc1:
        case 0xc2:
          parse_sof(m == 0xc2);
          if (headers_only) return;
          break;
        case 0xc3:
          throw Error{"JPEG: lossless JPEG (SOF3) is not supported"};
        case 0xc5:
        case 0xc6:
        case 0xc7:
          throw Error{"JPEG: hierarchical JPEG (SOF" + std::to_string(m - 0xc0) +
                      ") is not supported"};
        case 0xc9:
        case 0xca:
        case 0xcb:
        case 0xcd:
        case 0xce:
        case 0xcf:
          throw Error{"JPEG: arithmetic-coded JPEG (SOF" + std::to_string(m - 0xc0) +
                      ") is not supported"};
        case 0xcc:
          throw Error{"JPEG: arithmetic coding (DAC) is not supported"};
        case 0xc4:
          parse_dht();
          break;
        case 0xdb:
          parse_dqt();
          break;
        case 0xdd:
          u16();
          restart_interval = u16();
          break;
        case 0xda:
          parse_sos();
          break;
        default:
          if (m >= 0xe0 && m <= 0xef) {
            parse_app(m);
          } else {
            int len = u16();
            pos += len - 2;
          }
      }
    }
    if (!headers_only && !have_frame) throw Error{"JPEG: no frame header"};
  }

  bool is_rgb() const {
    if (ncomp != 3) return false;
    if (saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    if (comp[0].id == 1 && comp[1].id == 2 && comp[2].id == 3) return false;
    if (comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B') return true;
    return false;
  }

  // The component upsampled to the full image size (width x height).
  std::vector<uint8_t> upsample(const Component& c) const {
    std::vector<uint8_t> out((size_t)width * height);
    int sw = c.bw * 8;
    const uint8_t* in = c.px.data();
    auto at = [&](int x, int y) -> int { return in[(size_t)y * sw + x]; };
    int hr = hmax / c.h, vr = vmax / c.v;
    bool fancy_h = hr == 2 && vr == 1 && c.dw > 2;
    bool fancy_v = hr == 1 && vr == 2;
    bool fancy_hv = hr == 2 && vr == 2 && c.dw > 2;
    std::vector<uint8_t> row((size_t)2 * c.dw + 2);
    for (int y = 0; y < height; y++) {
      uint8_t* o = out.data() + (size_t)y * width;
      if (hr == 1 && vr == 1) {
        memcpy(o, in + (size_t)y * sw, width);
      } else if (fancy_h) {
        int iy = y;
        for (int i = 0; i < c.dw; i++) {
          int s = at(i, iy) * 3;
          int left = i == 0 ? at(i, iy) : (s + at(i - 1, iy) + 1) >> 2;
          int right = i == c.dw - 1 ? at(i, iy) : (s + at(i + 1, iy) + 2) >> 2;
          row[2 * i] = (uint8_t)left;
          row[2 * i + 1] = (uint8_t)right;
        }
        memcpy(o, row.data(), width);
      } else if (fancy_v) {
        int iy = y >> 1, v = y & 1;
        int ny = v == 0 ? std::max(iy - 1, 0) : std::min(iy + 1, c.dh - 1);
        int bias = v == 0 ? 1 : 2;
        for (int x = 0; x < width; x++) o[x] = (uint8_t)((at(x, iy) * 3 + at(x, ny) + bias) >> 2);
      } else if (fancy_hv) {
        int iy = y >> 1, v = y & 1;
        int ny = v == 0 ? std::max(iy - 1, 0) : std::min(iy + 1, c.dh - 1);
        auto colsum = [&](int x) { return at(x, iy) * 3 + at(x, ny); };
        int last = 0, cur = colsum(0), next;
        for (int i = 0; i < c.dw; i++) {
          next = i + 1 < c.dw ? colsum(i + 1) : 0;
          int left = i == 0 ? (cur * 4 + 8) >> 4 : (cur * 3 + last + 8) >> 4;
          int right = i == c.dw - 1 ? (cur * 4 + 7) >> 4 : (cur * 3 + next + 7) >> 4;
          row[2 * i] = (uint8_t)left;
          row[2 * i + 1] = (uint8_t)right;
          last = cur;
          cur = next;
        }
        memcpy(o, row.data(), width);
      } else {  // box replication
        int iy = y / vr;
        for (int x = 0; x < width; x++) o[x] = (uint8_t)at(x / hr, iy);
      }
    }
    return out;
  }

  // A four-component image is CMYK unless an Adobe marker's transform says
  // YCCK (libjpeg's default_decompress_parms); YCCK is not supported.
  void check_colour_space() const {
    if (ncomp == 4 && saw_adobe && adobe_transform != 0)
      throw Error{"JPEG: YCCK (Adobe transform " + std::to_string(adobe_transform) +
                  ") images are not supported"};
  }

  // OpenCV's icvCvt_CMYK2BGR_8u_C4C3R (as RGB here) and
  // icvCvt_CMYK2Gray_8u_C4C1R on libjpeg's CMYK samples.
  void cmyk_output(uint8_t* out, bool gray) const {
    std::vector<uint8_t> p0 = upsample(comp[0]), p1 = upsample(comp[1]), p2 = upsample(comp[2]),
                         p3 = upsample(comp[3]);
    for (size_t i = 0; i < (size_t)width * height; i++) {
      int k = p3[i];
      int c = k - (((255 - p0[i]) * k) >> 8);
      int m = k - (((255 - p1[i]) * k) >> 8);
      int y = k - (((255 - p2[i]) * k) >> 8);
      if (gray) {
        out[i] = (uint8_t)((y * 1868 + m * 9617 + c * 4899 + (1 << 13)) >> 14);
      } else {
        out[3 * i] = (uint8_t)c;
        out[3 * i + 1] = (uint8_t)m;
        out[3 * i + 2] = (uint8_t)y;
      }
    }
  }

  void to_output(uint8_t* out, bool gray) const {
    if (ncomp == 4) {
      cmyk_output(out, gray);
      return;
    }
    if (ncomp == 1 || gray) {
      // a grey request of a YCbCr image is its luma; an RGB image is
      // converted with jdcolor.c's rgb_gray weights
      if (ncomp == 3 && gray && is_rgb()) {
        std::vector<uint8_t> r = upsample(comp[0]), g = upsample(comp[1]), b = upsample(comp[2]);
        const int64_t R = 19595, G = 38470, B = 7471;  // FIX(0.29900), FIX(0.58700), FIX(0.11400)
        for (size_t i = 0; i < (size_t)width * height; i++)
          out[i] = (uint8_t)((R * r[i] + G * g[i] + B * b[i] + 32768) >> 16);
        return;
      }
      std::vector<uint8_t> y = upsample(comp[0]);
      if (gray) {
        memcpy(out, y.data(), y.size());
      } else {
        for (size_t i = 0; i < y.size(); i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
      }
      return;
    }
    std::vector<uint8_t> p0 = upsample(comp[0]), p1 = upsample(comp[1]), p2 = upsample(comp[2]);
    size_t np = (size_t)width * height;
    if (is_rgb()) {
      for (size_t i = 0; i < np; i++) {
        out[3 * i] = p0[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p2[i];
      }
      return;
    }
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t ONE_HALF = 1 << 15;
    auto FIX = [](double x) { return (int64_t)(x * 65536 + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> 16);
      cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> 16);
      cr_g[i] = -FIX(0.71414) * x;
      cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
    }
    auto clip = [](int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (size_t i = 0; i < np; i++) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      out[3 * i] = clip(y + cr_r[cr]);
      out[3 * i + 1] = clip(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
      out[3 * i + 2] = clip(y + cb_b[cb]);
    }
  }
};

thread_local std::string g_error;

}  // namespace

extern "C" {

const char* jpg_last_error() { return g_error.c_str(); }

// The image's width, height and component count from its frame header.
int jpg_info(const uint8_t* data, int64_t n, int* width, int* height, int* comps) {
  try {
    Decoder d;
    d.data = data;
    d.n = (size_t)n;
    d.parse(true);
    if (!d.have_frame) throw Error{"JPEG: no frame header"};
    d.check_colour_space();
    *width = d.width;
    *height = d.height;
    *comps = d.ncomp;
    return 0;
  } catch (const Error& e) {
    g_error = e.msg;
    return -1;
  }
}

// Decode into out: height x width x 3 RGB, or height x width with gray;
// width and height are jpg_info's (out's size).
int jpg_decode(const uint8_t* data, int64_t n, uint8_t* out, int width, int height, int gray) {
  try {
    Decoder d;
    d.data = data;
    d.n = (size_t)n;
    d.parse(false);
    if (d.width != width || d.height != height) throw Error{"JPEG: frame size changed"};
    d.check_colour_space();
    if (d.progressive) d.finish_progressive();
    d.to_output(out, gray != 0);
    return 0;
  } catch (const Error& e) {
    g_error = e.msg;
    return -1;
  }
}

}  // extern "C"
