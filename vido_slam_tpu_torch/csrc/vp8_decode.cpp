// Lossy WebP's image, a VP8 key frame (RFC 6386), decoded on the host as
// libwebp 1.x decodes it (vp8_dec.c, tree_dec.c, quant_dec.c, frame_dec.c,
// dsp/dec.c with dec_sse2.c's full inverse DCT, upsampling.c, yuv.h), bound
// with ctypes by io/vp8.py, which hands in the normative tables and keeps a
// Python version (``decode_plain``) bit-equal to this one:
//
// vp8_decode: the frame header (key frame, profile 0-3, shown, partition 0
// inside the data, start code, 14-bit sizes), partition 0's headers
// (segments, filter, token partitions, quantisers, coefficient probability
// updates, skip probability), then macroblock row by row the intra modes,
// the coefficient tokens of the row's token partition, and the
// reconstruction (prediction over the unfiltered neighbours, the inverse
// WHT and DCT); then the loop filter over the frame in macroblock order,
// the fancy upsampling of U and V and the YUV -> BGR conversion into
// ``out`` (B, G, R, 255 at 4 bytes a pixel, rows ``stride`` bytes apart).
// libwebp's boolean decoder reads zeros past a partition's end and is past
// its end once it needed a byte that is not there; the frame fails if
// partition 0 is past its end after a row of modes or a token partition
// after a macroblock. Returns 0; a negative code where libwebp fails.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

enum { DC_PRED = 0, TM_PRED = 1, V_PRED = 2, H_PRED = 3 };

// the work area of one macroblock (frame_dec.c yuv_b_)
const int BPS = 32;
const int Y_OFF = BPS + 8;
const int U_OFF = Y_OFF + BPS * 16 + BPS;
const int V_OFF = U_OFF + 16;
const int YUV_SIZE = BPS * 17 + BPS * 9;

struct Tables {
  const uint8_t* update;   // [4][8][3][11]
  const uint8_t* proba0;   // [4][8][3][11]
  const uint8_t* bmodes;   // [10][10][9]
  const uint8_t* dc;       // [128]
  uint16_t ac[128];
};

struct Bool {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  uint32_t range = 254;  // range - 1
  int bits = -8;
  bool eof = false;

  void init(const uint8_t* start, int64_t size) {
    buf = start;
    end = start + size;
    value = 0;
    range = 254;
    bits = -8;
    eof = false;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (range * (uint32_t)prob) >> 8;
    uint32_t rng;
    int b;
    if ((uint32_t)(value >> pos) > split) {
      rng = range - split;
      value -= (uint64_t)(split + 1) << pos;
      b = 1;
    } else {
      rng = split + 1;
      b = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(rng));
    range = (rng << shift) - 1;
    bits -= shift;
    return b;
  }
  int value_of(int n) {  // VP8GetValue
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int signed_value(int n) {  // VP8GetSignedValue
    const int v = value_of(n);
    return bit(0x80) ? -v : v;
  }
};

inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }
inline uint8_t u8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int s16(int v) { return (int16_t)(uint16_t)(unsigned)v; }

struct MB {
  uint8_t seg, skip, is_i4x4, uvmode;
  uint8_t modes[16];
};

struct Frame {
  int width, height, mb_w, mb_h;
  int use_segment = 0, update_map = 0, absolute = 1;
  int seg_quant[4] = {0, 0, 0, 0}, seg_filter[4] = {0, 0, 0, 0};
  int seg_proba[3] = {255, 255, 255};
  int filter_type;
  Bool br;
  int num_parts;
  Bool parts[8];
  int quant[4][3][2];           // [segment][y1, y2, uv][dc, ac]
  uint8_t proba[4][8][3][11];   // [type][band][context]
  int skip_p = -1;
  int fstrength[4][2][3];       // [segment][i4x4]: limit, ilevel, hev
};

// VP8GetHeaders and VP8EnterCritical's filter strengths; false where
// libwebp fails
bool headers(const uint8_t* data, int64_t n, const Tables& T, Frame& f) {
  if (n < 10) return false;
  const uint32_t bits = data[0] | data[1] << 8 | data[2] << 16;
  if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1)) return false;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return false;
  f.width = (data[7] << 8 | data[6]) & 0x3fff;
  f.height = (data[9] << 8 | data[8]) & 0x3fff;
  f.mb_w = (f.width + 15) >> 4;
  f.mb_h = (f.height + 15) >> 4;
  const int64_t plen = bits >> 5;
  if (plen > n - 10) return false;
  Bool& br = f.br;
  br.init(data + 10, plen);
  br.bit(0x80);  // colour space
  br.bit(0x80);  // clamping type
  f.use_segment = br.bit(0x80);
  if (f.use_segment) {
    f.update_map = br.bit(0x80);
    if (br.bit(0x80)) {
      f.absolute = br.bit(0x80);
      for (int& q : f.seg_quant) q = br.bit(0x80) ? br.signed_value(7) : 0;
      for (int& l : f.seg_filter) l = br.bit(0x80) ? br.signed_value(6) : 0;
    }
    if (f.update_map)
      for (int& p : f.seg_proba) p = br.bit(0x80) ? br.value_of(8) : 255;
  }
  if (br.eof) return false;
  const int simple = br.bit(0x80);
  const int level = br.value_of(6);
  const int sharpness = br.value_of(3);
  const int use_lf_delta = br.bit(0x80);
  int ref_delta[4] = {0, 0, 0, 0}, mode_delta[4] = {0, 0, 0, 0};
  if (use_lf_delta && br.bit(0x80)) {
    for (int& d : ref_delta)
      if (br.bit(0x80)) d = br.signed_value(6);
    for (int& d : mode_delta)
      if (br.bit(0x80)) d = br.signed_value(6);
  }
  f.filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) return false;
  // token partitions
  const uint8_t* sz = data + 10 + plen;
  const int64_t size = n - 10 - plen;
  const int last = (1 << br.value_of(2)) - 1;
  if (size < 3 * last) return false;
  const uint8_t* part = sz + 3 * last;
  int64_t left = size - 3 * last;
  for (int p = 0; p < last; ++p) {
    int64_t psize = sz[3 * p] | sz[3 * p + 1] << 8 | sz[3 * p + 2] << 16;
    if (psize > left) psize = left;
    f.parts[p].init(part, psize);
    part += psize;
    left -= psize;
  }
  f.parts[last].init(part, left);
  f.num_parts = last + 1;
  if (left <= 0) return false;
  // quantisers
  const int base_q = br.value_of(7);
  int dq[5];
  for (int& d : dq) d = br.bit(0x80) ? br.signed_value(4) : 0;
  for (int s = 0; s < 4; ++s) {
    const int q = f.use_segment ? f.seg_quant[s] + (f.absolute ? 0 : base_q)
                                : base_q;
    f.quant[s][0][0] = T.dc[clip(q + dq[0], 127)];
    f.quant[s][0][1] = T.ac[clip(q, 127)];
    f.quant[s][1][0] = T.dc[clip(q + dq[1], 127)] * 2;
    const int y2_ac = (T.ac[clip(q + dq[2], 127)] * 101581) >> 16;
    f.quant[s][1][1] = y2_ac < 8 ? 8 : y2_ac;
    f.quant[s][2][0] = T.dc[clip(q + dq[3], 117)];
    f.quant[s][2][1] = T.ac[clip(q + dq[4], 127)];
  }
  br.bit(0x80);  // update_proba, ignored
  int i = 0;
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p, ++i)
          f.proba[t][b][c][p] = (uint8_t)(br.bit(T.update[i])
                                               ? br.value_of(8)
                                               : T.proba0[i]);
  if (br.bit(0x80)) f.skip_p = br.value_of(8);
  for (int s = 0; s < 4; ++s) {
    const int base = f.use_segment
                         ? f.seg_filter[s] + (f.absolute ? 0 : level)
                         : level;
    for (int i4 = 0; i4 < 2; ++i4) {
      int lv = base;
      if (use_lf_delta) lv += ref_delta[0] + (i4 ? mode_delta[0] : 0);
      lv = clip(lv, 63);
      int* fs = f.fstrength[s][i4];
      if (lv > 0) {
        int ilevel = lv;
        if (sharpness > 0) {
          ilevel >>= sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        fs[0] = 2 * lv + ilevel;
        fs[1] = ilevel;
        fs[2] = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
      } else {
        fs[0] = fs[1] = fs[2] = 0;
      }
    }
  }
  return true;
}

// ParseIntraModeRow
void intra_row(Frame& f, const Tables& T, uint8_t* intra_t, MB* row) {
  Bool& br = f.br;
  uint8_t left[4] = {0, 0, 0, 0};
  for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
    MB& mb = row[mb_x];
    uint8_t* top = intra_t + 4 * mb_x;
    if (f.update_map) {
      mb.seg = !br.bit(f.seg_proba[0]) ? br.bit(f.seg_proba[1])
                                       : br.bit(f.seg_proba[2]) + 2;
    } else {
      mb.seg = 0;
    }
    mb.skip = f.skip_p >= 0 ? br.bit(f.skip_p) : 0;
    mb.is_i4x4 = !br.bit(145);
    if (!mb.is_i4x4) {
      const int ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED)
                                    : (br.bit(163) ? V_PRED : DC_PRED);
      mb.modes[0] = (uint8_t)ymode;
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* p = T.bmodes + (top[x] * 10 + ymode) * 9;
          if (!br.bit(p[0])) {
            ymode = 0;
          } else if (!br.bit(p[1])) {
            ymode = 1;
          } else if (!br.bit(p[2])) {
            ymode = 2;
          } else if (!br.bit(p[3])) {
            ymode = !br.bit(p[4]) ? 3 : br.bit(p[5]) ? 5 : 4;
          } else if (!br.bit(p[6])) {
            ymode = 6;
          } else if (!br.bit(p[7])) {
            ymode = 7;
          } else {
            ymode = br.bit(p[8]) ? 9 : 8;
          }
          top[x] = (uint8_t)ymode;
        }
        std::memcpy(mb.modes + 4 * y, top, 4);
        left[y] = (uint8_t)ymode;
      }
    }
    mb.uvmode = !br.bit(142) ? DC_PRED
                : !br.bit(114) ? V_PRED
                : br.bit(183) ? TM_PRED : H_PRED;
  }
}

int large_value(Bool& br, const uint8_t* p) {  // GetLargeValue
  if (!br.bit(p[3])) {
    if (!br.bit(p[4])) return 2;
    return 3 + br.bit(p[5]);
  }
  if (!br.bit(p[6])) {
    if (!br.bit(p[7])) return 5 + br.bit(159);
    int v = 7 + 2 * br.bit(165);
    return v + br.bit(145);
  }
  const int bit1 = br.bit(p[8]);
  const int cat = 2 * bit1 + br.bit(p[9 + bit1]);
  int v = 0;
  for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
  return v + 3 + (8 << cat);
}

// GetCoeffs: one block's tokens from position n, dequantised into out
// (int16, as libwebp stores them); the position after the last non-zero
int coeffs(Bool& br, const uint8_t (*bands)[3][11], int ctx, const int* dq,
           int n, int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t (*next)[11] = bands[kBands[n + 1]];
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = next[1];
    } else {
      v = large_value(br, p);
      p = next[2];
    }
    if (br.bit(0x80)) v = -v;
    out[kZigzag[n]] = (int16_t)(v * dq[n > 0]);
  }
  return 16;
}

void wht(const int16_t* in, int16_t* out) {  // TransformWHT
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

inline int nz_code(int nz, bool dc_nz) {
  return nz > 3 ? 3 : nz > 1 ? 2 : (int)dc_nz;
}

// ParseResiduals: the macroblock's coefficients and each block's transform
// code; tnz/lnz: 9 flags (4 luma, 2 U, 2 V, the Y2 block)
void residuals(const Frame& f, Bool& br, const MB& mb, uint8_t* tnz,
               uint8_t* lnz, int16_t* c, uint8_t* codes) {
  const int (*q)[2] = f.quant[mb.seg];
  std::memset(c, 0, 384 * sizeof(int16_t));
  int first;
  const uint8_t (*ac)[3][11];
  if (!mb.is_i4x4) {
    int16_t dc[16] = {0};
    const int nz = coeffs(br, f.proba[1], tnz[8] + lnz[8], q[1], 0, dc);
    tnz[8] = lnz[8] = nz > 0;
    if (nz > 1) {
      wht(dc, c);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 256; i += 16) c[i] = (int16_t)dc0;
    }
    first = 1;
    ac = f.proba[0];
  } else {
    first = 0;
    ac = f.proba[3];
  }
  for (int y = 0; y < 4; ++y) {
    int l = lnz[y];
    for (int x = 0; x < 4; ++x) {
      const int b = 4 * y + x;
      const int nz = coeffs(br, ac, l + tnz[x], q[0], first, c + 16 * b);
      l = tnz[x] = nz > first;
      codes[b] = (uint8_t)nz_code(nz, c[16 * b] != 0);
    }
    lnz[y] = (uint8_t)l;
  }
  for (int ch = 4; ch < 8; ch += 2)
    for (int y = 0; y < 2; ++y) {
      int l = lnz[ch + y];
      for (int x = 0; x < 2; ++x) {
        const int b = 16 + (ch - 4) * 2 + 2 * y + x;
        const int nz = coeffs(br, f.proba[2], l + tnz[ch + x], q[2], 0,
                              c + 16 * b);
        l = tnz[ch + x] = nz > 0;
        codes[b] = (uint8_t)nz_code(nz, c[16 * b] != 0);
      }
      lnz[ch + y] = (uint8_t)l;
    }
}

// ---- the inverse transforms, adding into the work area ----

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }
inline int hi(int v, int k) { return (v * k) >> 16; }  // _mm_mulhi_epi16

// Transform_SSE2: the full inverse DCT in 16-bit lanes
void transform(const int16_t* in, uint8_t* dst) {
  int v[4][4];  // [row][column]
  for (int i = 0; i < 4; ++i) {
    const int i0 = in[i], i1 = in[4 + i], i2 = in[8 + i], i3 = in[12 + i];
    const int a = s16(i0 + i2), b = s16(i0 - i2);
    const int c = s16(s16(i1 - i3) + s16(hi(i1, -30068) - hi(i3, 20091)));
    const int d = s16(s16(i1 + i3) + s16(hi(i1, 20091) + hi(i3, -30068)));
    v[0][i] = s16(a + d);
    v[1][i] = s16(b + c);
    v[2][i] = s16(b - c);
    v[3][i] = s16(a - d);
  }
  for (int k = 0; k < 4; ++k) {
    const int t0 = v[k][0], t1 = v[k][1], t2 = v[k][2], t3 = v[k][3];
    const int dc = s16(t0 + 4);
    const int a = s16(dc + t2), b = s16(dc - t2);
    const int c = s16(s16(t1 - t3) + s16(hi(t1, -30068) - hi(t3, 20091)));
    const int d = s16(s16(t1 + t3) + s16(hi(t1, 20091) + hi(t3, -30068)));
    const int out[4] = {s16(a + d), s16(b + c), s16(b - c), s16(a - d)};
    uint8_t* r = dst + k * BPS;
    for (int x = 0; x < 4; ++x) r[x] = u8(s16(r[x] + (out[x] >> 3)));
  }
}

void transform_ac3(const int16_t* in, uint8_t* dst) {  // TransformAC3_C
  const int a = in[0] + 4;
  const int c4 = mul2(in[4]), d4 = mul1(in[4]);
  const int c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int base[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int k = 0; k < 4; ++k) {
    uint8_t* r = dst + k * BPS;
    const int vals[4] = {base[k] + d1, base[k] + c1, base[k] - c1,
                         base[k] - d1};
    for (int x = 0; x < 4; ++x) r[x] = u8(r[x] + (vals[x] >> 3));
  }
}

void transform_dc(const int16_t* in, uint8_t* dst) {  // TransformDC_C
  const int dc = (in[0] + 4) >> 3;
  for (int k = 0; k < 4; ++k)
    for (int x = 0; x < 4; ++x) dst[k * BPS + x] = u8(dst[k * BPS + x] + dc);
}

void luma_transform(int code, const int16_t* in, uint8_t* dst) {
  if (code == 3) {
    transform(in, dst);
  } else if (code == 2) {
    transform_ac3(in, dst);
  } else if (code == 1) {
    transform_dc(in, dst);
  }
}

// DoUVTransform
void chroma_transform(const uint8_t* codes, const int16_t* in, uint8_t* dst) {
  const int offs[4] = {0, 4, 4 * BPS, 4 * BPS + 4};
  if (!(codes[0] | codes[1] | codes[2] | codes[3])) return;
  const bool full = codes[0] >= 2 || codes[1] >= 2 || codes[2] >= 2 ||
                    codes[3] >= 2;
  for (int i = 0; i < 4; ++i) {
    if (full) {
      transform(in + 16 * i, dst + offs[i]);
    } else if (in[16 * i]) {
      transform_dc(in + 16 * i, dst + offs[i]);
    }
  }
}

// ---- the intra predictors ----

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

void fill(uint8_t* d, int size, int v) {
  for (int k = 0; k < size; ++k) std::memset(d + k * BPS, v, size);
}

// the 16x16 and 8x8 predictors: DC (4, 5, 6 without the top, the left or
// both), TM, V, H
void pred_block(uint8_t* d, int size, int mode) {
  const uint8_t* top = d - BPS;
  const int sh = size == 16 ? 4 : 3;
  int st = 0, sl = 0;
  for (int k = 0; k < size; ++k) {
    st += top[k];
    sl += d[k * BPS - 1];
  }
  if (mode == DC_PRED) {
    fill(d, size, (st + sl + size) >> (sh + 1));
  } else if (mode == 4) {
    fill(d, size, (sl + (size >> 1)) >> sh);
  } else if (mode == 5) {
    fill(d, size, (st + (size >> 1)) >> sh);
  } else if (mode == 6) {
    fill(d, size, 0x80);
  } else if (mode == TM_PRED) {
    const int tl = top[-1];
    for (int k = 0; k < size; ++k) {
      const int l = d[k * BPS - 1] - tl;
      for (int x = 0; x < size; ++x) d[k * BPS + x] = u8(top[x] + l);
    }
  } else if (mode == V_PRED) {
    for (int k = 0; k < size; ++k) std::memcpy(d + k * BPS, top, size);
  } else {
    for (int k = 0; k < size; ++k) std::memset(d + k * BPS, d[k * BPS - 1], size);
  }
}

void pred4(uint8_t* d, int mode) {  // VP8PredLuma4
  const uint8_t* t = d - BPS;
  const int A = t[0], B = t[1], C = t[2], D = t[3], E = t[4], F = t[5],
            G = t[6], H = t[7], X = t[-1];
  const int I = d[-1], J = d[BPS - 1], K = d[2 * BPS - 1], L = d[3 * BPS - 1];
  int o[4][4];
  switch (mode) {
    case 0: {
      const int v = (A + B + C + D + I + J + K + L + 4) >> 3;
      for (auto& r : o)
        for (int& e : r) e = v;
      break;
    }
    case 1: {
      const int top[4] = {A, B, C, D}, left[4] = {I, J, K, L};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) o[y][x] = u8(top[x] + left[y] - X);
      break;
    }
    case 2: {
      const int v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                        avg3(C, D, E)};
      for (auto& r : o)
        for (int x = 0; x < 4; ++x) r[x] = v[x];
      break;
    }
    case 3: {
      const int v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L),
                        avg3(K, L, L)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) o[y][x] = v[y];
      break;
    }
    case 4: {  // RD
      const int e[7] = {avg3(J, K, L), avg3(I, J, K), avg3(X, I, J),
                        avg3(A, X, I), avg3(B, A, X), avg3(C, B, A),
                        avg3(D, C, B)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) o[y][x] = e[3 - y + x];
      break;
    }
    case 5: {  // VR
      const int v[4][4] = {
          {avg2(X, A), avg2(A, B), avg2(B, C), avg2(C, D)},
          {avg3(I, X, A), avg3(X, A, B), avg3(A, B, C), avg3(B, C, D)},
          {avg3(J, I, X), avg2(X, A), avg2(A, B), avg2(B, C)},
          {avg3(K, J, I), avg3(I, X, A), avg3(X, A, B), avg3(A, B, C)}};
      std::memcpy(o, v, sizeof(o));
      break;
    }
    case 6: {  // LD
      const int e[7] = {avg3(A, B, C), avg3(B, C, D), avg3(C, D, E),
                        avg3(D, E, F), avg3(E, F, G), avg3(F, G, H),
                        avg3(G, H, H)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) o[y][x] = e[x + y];
      break;
    }
    case 7: {  // VL
      const int v[4][4] = {
          {avg2(A, B), avg2(B, C), avg2(C, D), avg2(D, E)},
          {avg3(A, B, C), avg3(B, C, D), avg3(C, D, E), avg3(D, E, F)},
          {avg2(B, C), avg2(C, D), avg2(D, E), avg3(E, F, G)},
          {avg3(B, C, D), avg3(C, D, E), avg3(D, E, F), avg3(F, G, H)}};
      std::memcpy(o, v, sizeof(o));
      break;
    }
    case 8: {  // HD
      const int v[4][4] = {
          {avg2(I, X), avg3(I, X, A), avg3(X, A, B), avg3(A, B, C)},
          {avg2(J, I), avg3(J, I, X), avg2(I, X), avg3(I, X, A)},
          {avg2(K, J), avg3(K, J, I), avg2(J, I), avg3(J, I, X)},
          {avg2(L, K), avg3(L, K, J), avg2(K, J), avg3(K, J, I)}};
      std::memcpy(o, v, sizeof(o));
      break;
    }
    default: {  // HU
      const int v[4][4] = {
          {avg2(I, J), avg3(I, J, K), avg2(J, K), avg3(J, K, L)},
          {avg2(J, K), avg3(J, K, L), avg2(K, L), avg3(K, L, L)},
          {avg2(K, L), avg3(K, L, L), L, L},
          {L, L, L, L}};
      std::memcpy(o, v, sizeof(o));
      break;
    }
  }
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) d[y * BPS + x] = (uint8_t)o[y][x];
}

inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? 6 : 5;
    return mb_y == 0 ? 4 : DC_PRED;
  }
  return mode;
}

const int kScan[16] = {0,           4,           8,           12,
                       4 * BPS,     4 + 4 * BPS, 8 + 4 * BPS, 12 + 4 * BPS,
                       8 * BPS,     4 + 8 * BPS, 8 + 8 * BPS, 12 + 8 * BPS,
                       12 * BPS,    4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

// ---- the loop filter, on a plane of row stride s ----

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }
inline int abs0(int v) { return v < 0 ? -v : v; }

inline void do_filter2(uint8_t* p, int s) {
  const int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-s] = u8(p0 + a2);
  p[0] = u8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int s) {
  const int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * s] = u8(p1 + a3);
  p[-s] = u8(p0 + a2);
  p[0] = u8(q0 - a1);
  p[s] = u8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int s) {
  const int p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s];
  const int q0 = p[0], q1 = p[s], q2 = p[2 * s];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * s] = u8(p2 + a3);
  p[-2 * s] = u8(p1 + a2);
  p[-s] = u8(p0 + a1);
  p[0] = u8(q0 - a1);
  p[s] = u8(q1 - a2);
  p[2 * s] = u8(q2 - a3);
}

void simple(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (4 * abs0(p[-hstride] - p[0]) + abs0(p[-2 * hstride] - p[hstride]) <= t2)
      do_filter2(p, hstride);
}

void loop(uint8_t* p, int s, int vstride, int size, int thresh, int ithresh,
          int hev, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    const int p3 = p[-4 * s], p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s];
    const int q0 = p[0], q1 = p[s], q2 = p[2 * s], q3 = p[3 * s];
    if (4 * abs0(p0 - q0) + abs0(p1 - q1) > t2) continue;
    if (abs0(p3 - p2) > ithresh || abs0(p2 - p1) > ithresh ||
        abs0(p1 - p0) > ithresh || abs0(q3 - q2) > ithresh ||
        abs0(q2 - q1) > ithresh || abs0(q1 - q0) > ithresh)
      continue;
    if (abs0(p1 - p0) > hev || abs0(q1 - q0) > hev) {
      do_filter2(p, s);
    } else if (mb_edge) {
      do_filter6(p, s);
    } else {
      do_filter4(p, s);
    }
  }
}

// ---- output ----

inline int clip8(int v) {
  return (v & ~0x3fff) == 0 ? v >> 6 : v < 0 ? 0 : 255;
}

inline void bgr(int y, int u, int v, uint8_t* o) {
  const int yy = (y * 19077) >> 8;
  o[0] = (uint8_t)clip8(yy + ((u * 33050) >> 8) - 17685);
  o[1] = (uint8_t)clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708);
  o[2] = (uint8_t)clip8(yy + ((v * 26149) >> 8) - 14234);
  o[3] = 255;
}

// UpsampleRgbLinePair's chroma of one output row: near at weight 3
void upsample_line(const uint8_t* near, const uint8_t* far, int width,
                   int* out) {
  out[0] = (3 * near[0] + far[0] + 2) >> 2;
  const int pairs = (width - 1) >> 1;
  for (int x = 1; x <= pairs; ++x) {
    const int n0 = near[x - 1], n1 = near[x], f0 = far[x - 1], f1 = far[x];
    const int s = n0 + n1 + f0 + f1 + 8;
    out[2 * x - 1] = (((s + 2 * (n1 + f0)) >> 3) + n0) >> 1;
    out[2 * x] = (((s + 2 * (n0 + f1)) >> 3) + n1) >> 1;
  }
  if (!(width & 1))
    out[width - 1] = (3 * near[pairs] + far[pairs] + 2) >> 2;
}

}  // namespace

extern "C" {

int vp8_decode(const uint8_t* data, int64_t n, const uint8_t* tables,
               uint8_t* out, int64_t stride, int width, int height) {
  Tables T;
  T.update = tables;
  T.proba0 = tables + 1056;
  T.bmodes = tables + 2112;
  T.dc = tables + 3012;
  for (int i = 0; i < 128; ++i)
    T.ac[i] = (uint16_t)(tables[3140 + 2 * i] | tables[3141 + 2 * i] << 8);
  Frame f;
  if (!headers(data, n, T, f)) return -1;
  if (f.width != width || f.height != height) return -2;
  const int W = 16 * f.mb_w, H = 16 * f.mb_h;
  const int uvw = W / 2;
  std::vector<uint8_t> Y((size_t)W * H), U((size_t)uvw * (H / 2)),
      V((size_t)uvw * (H / 2));
  std::vector<MB> mbs((size_t)f.mb_w * f.mb_h);
  std::vector<uint8_t> inner((size_t)f.mb_w * f.mb_h);
  std::vector<uint8_t> intra_t(4 * (size_t)f.mb_w, 0);
  std::vector<uint8_t> top_nz(9 * (size_t)f.mb_w, 0);
  std::vector<int16_t> coef(384 * (size_t)f.mb_w);
  std::vector<uint8_t> codes(24 * (size_t)f.mb_w);
  std::vector<uint8_t> top_y(16 * (size_t)f.mb_w), top_u(8 * (size_t)f.mb_w),
      top_v(8 * (size_t)f.mb_w);
  uint8_t ws[YUV_SIZE];
  std::memset(ws, 0, sizeof(ws));
  uint8_t* const yd = ws + Y_OFF;
  uint8_t* const ud = ws + U_OFF;
  uint8_t* const vd = ws + V_OFF;
  for (int mb_y = 0; mb_y < f.mb_h; ++mb_y) {
    MB* row = &mbs[(size_t)mb_y * f.mb_w];
    intra_row(f, T, intra_t.data(), row);
    if (f.br.eof) return -3;
    Bool& tbr = f.parts[mb_y & (f.num_parts - 1)];
    uint8_t left_nz[9] = {0};
    for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
      MB& mb = row[mb_x];
      uint8_t* tnz = &top_nz[9 * (size_t)mb_x];
      uint8_t* cd = &codes[24 * (size_t)mb_x];
      int skip = mb.skip;
      if (!skip) {
        residuals(f, tbr, mb, tnz, left_nz, &coef[384 * (size_t)mb_x], cd);
        skip = 1;
        for (int k = 0; k < 24; ++k)
          if (cd[k]) skip = 0;
      } else {
        for (int k = 0; k < 8; ++k) tnz[k] = left_nz[k] = 0;
        if (!mb.is_i4x4) tnz[8] = left_nz[8] = 0;
        std::memset(cd, 0, 24);
      }
      if (tbr.eof) return -4;
      inner[(size_t)mb_y * f.mb_w + mb_x] = mb.is_i4x4 || !skip;
    }
    // ReconstructRow
    for (int j = 0; j < 16; ++j) yd[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) ud[j * BPS - 1] = vd[j * BPS - 1] = 129;
    if (mb_y > 0) {
      yd[-1 - BPS] = ud[-1 - BPS] = vd[-1 - BPS] = 129;
    } else {
      std::memset(yd - BPS - 1, 127, 16 + 4 + 1);
      std::memset(ud - BPS - 1, 127, 8 + 1);
      std::memset(vd - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
      const MB& mb = row[mb_x];
      const int16_t* c = &coef[384 * (size_t)mb_x];
      const uint8_t* cd = &codes[24 * (size_t)mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j)
          std::memcpy(yd + j * BPS - 4, yd + j * BPS + 12, 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(ud + j * BPS - 4, ud + j * BPS + 4, 4);
          std::memcpy(vd + j * BPS - 4, vd + j * BPS + 4, 4);
        }
      }
      if (mb_y > 0) {
        std::memcpy(yd - BPS, &top_y[16 * (size_t)mb_x], 16);
        std::memcpy(ud - BPS, &top_u[8 * (size_t)mb_x], 8);
        std::memcpy(vd - BPS, &top_v[8 * (size_t)mb_x], 8);
      }
      if (mb.is_i4x4) {
        uint8_t* tr = yd - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= f.mb_w - 1) {
            std::memset(tr, top_y[16 * (size_t)mb_x + 15], 4);
          } else {
            std::memcpy(tr, &top_y[16 * (size_t)(mb_x + 1)], 4);
          }
        }
        for (int k = 1; k < 4; ++k) std::memcpy(tr + 4 * k * BPS, tr, 4);
        for (int b = 0; b < 16; ++b) {
          uint8_t* d = yd + kScan[b];
          pred4(d, mb.modes[b]);
          luma_transform(cd[b], c + 16 * b, d);
        }
      } else {
        pred_block(yd, 16, check_mode(mb_x, mb_y, mb.modes[0]));
        for (int b = 0; b < 16; ++b)
          luma_transform(cd[b], c + 16 * b, yd + kScan[b]);
      }
      const int m = check_mode(mb_x, mb_y, mb.uvmode);
      pred_block(ud, 8, m);
      pred_block(vd, 8, m);
      chroma_transform(cd + 16, c + 256, ud);
      chroma_transform(cd + 20, c + 320, vd);
      if (mb_y < f.mb_h - 1) {
        std::memcpy(&top_y[16 * (size_t)mb_x], yd + 15 * BPS, 16);
        std::memcpy(&top_u[8 * (size_t)mb_x], ud + 7 * BPS, 8);
        std::memcpy(&top_v[8 * (size_t)mb_x], vd + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        std::memcpy(&Y[(size_t)(16 * mb_y + j) * W + 16 * mb_x], yd + j * BPS,
                    16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(&U[(size_t)(8 * mb_y + j) * uvw + 8 * mb_x], ud + j * BPS,
                    8);
        std::memcpy(&V[(size_t)(8 * mb_y + j) * uvw + 8 * mb_x], vd + j * BPS,
                    8);
      }
    }
  }
  // DoFilter, macroblock by macroblock
  if (f.filter_type)
    for (int mb_y = 0; mb_y < f.mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
        const MB& mb = mbs[(size_t)mb_y * f.mb_w + mb_x];
        const int* fs = f.fstrength[mb.seg][mb.is_i4x4];
        const int limit = fs[0], ilevel = fs[1], hev = fs[2];
        if (limit == 0) continue;
        const bool in = inner[(size_t)mb_y * f.mb_w + mb_x];
        uint8_t* y = &Y[(size_t)16 * mb_y * W + 16 * mb_x];
        if (f.filter_type == 1) {
          if (mb_x > 0) simple(y, 1, W, limit + 4);
          if (in)
            for (int k = 4; k < 16; k += 4) simple(y + k, 1, W, limit);
          if (mb_y > 0) simple(y, W, 1, limit + 4);
          if (in)
            for (int k = 4; k < 16; k += 4) simple(y + k * W, W, 1, limit);
          continue;
        }
        uint8_t* u = &U[(size_t)8 * mb_y * uvw + 8 * mb_x];
        uint8_t* v = &V[(size_t)8 * mb_y * uvw + 8 * mb_x];
        if (mb_x > 0) {
          loop(y, 1, W, 16, limit + 4, ilevel, hev, true);
          loop(u, 1, uvw, 8, limit + 4, ilevel, hev, true);
          loop(v, 1, uvw, 8, limit + 4, ilevel, hev, true);
        }
        if (in) {
          for (int k = 4; k < 16; k += 4)
            loop(y + k, 1, W, 16, limit, ilevel, hev, false);
          loop(u + 4, 1, uvw, 8, limit, ilevel, hev, false);
          loop(v + 4, 1, uvw, 8, limit, ilevel, hev, false);
        }
        if (mb_y > 0) {
          loop(y, W, 1, 16, limit + 4, ilevel, hev, true);
          loop(u, uvw, 1, 8, limit + 4, ilevel, hev, true);
          loop(v, uvw, 1, 8, limit + 4, ilevel, hev, true);
        }
        if (in) {
          for (int k = 4; k < 16; k += 4)
            loop(y + k * W, W, 1, 16, limit, ilevel, hev, false);
          loop(u + 4 * uvw, uvw, 1, 8, limit, ilevel, hev, false);
          loop(v + 4 * uvw, uvw, 1, 8, limit, ilevel, hev, false);
        }
      }
  // EmitFancyRGB
  const int last = ((height + 1) >> 1) - 1;
  std::vector<int> cu(width), cv(width);
  for (int y = 0; y < height; ++y) {
    const int k = (y + 1) >> 1;
    int nr, fr;
    if (y == 0) {
      nr = fr = 0;
    } else if (y & 1) {
      nr = k - 1;
      fr = k < last ? k : last;
    } else {
      nr = k;
      fr = k - 1;
    }
    upsample_line(&U[(size_t)nr * uvw], &U[(size_t)fr * uvw], width,
                  cu.data());
    upsample_line(&V[(size_t)nr * uvw], &V[(size_t)fr * uvw], width,
                  cv.data());
    const uint8_t* yr = &Y[(size_t)y * W];
    uint8_t* o = out + (int64_t)y * stride;
    for (int x = 0; x < width; ++x) bgr(yr[x], cu[x], cv[x], o + 4 * x);
  }
  return 0;
}

}  // extern "C"
