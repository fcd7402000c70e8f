// Baseline JPEG decoding on the host, with the arithmetic of libjpeg-turbo
// 3.1's defaults (what cv2.imread runs), so that a frame decodes to the
// same bytes as cv2 gives. Bound with ctypes by io/jpeg.py, which parses
// the markers and calls the three steps here:
//
// 1. jpeg_entropy_decode: the Huffman-coded scan (one interleaved scan of
//    every component, or the one component of a gray file) into each
//    component's quantised coefficients, natural order, as JCOEF (int16).
//    Restart markers (DRI/RSTn) reset the DC predictors; a marker or the
//    end of the data where bits are still needed stuffs zero bits and
//    leaves the rest of the restart segment's MCUs zero, which is what
//    libjpeg's jdhuff.c does (uniform gray where a file is cut short).
//    A misplaced restart marker is resynchronised by jdmarker.c's rules.
// 2. jpeg_idct_plane: dequantisation and the JDCT_ISLOW integer IDCT
//    (jidctint.c, CONST_BITS 13, PASS1_BITS 2) of every block of a
//    component, each sample limited to 0..255 after the +128 level shift.
//    cv2's libjpeg-turbo runs it as jidctint-avx2 on x86-64, in 16-bit
//    lanes: the dequantised coefficients, in0 +- in4 and the odd part's
//    z3 = in7 + in3, z4 = in5 + in1 wrap to 16 bits, a block whose rows
//    1-7 are zero takes a shortcut (row 0 << 2, wrapped), and pass 1's
//    results saturate to 16 bits. On every valid file that is jidctint.c's
//    arithmetic; where a corrupt file's coefficients leave 16 bits it is
//    what cv2 returns, so it is copied.
// 3. jpeg_upsample_plane and jpeg_ycc_to_bgr: jdsample.c's fancy
//    (triangle) upsampling h2v1, h1v2 and h2v2 and its box upsampling
//    otherwise, then jdcolor.c's fixed-point YCbCr -> RGB tables, written
//    out as BGR.
//
// io/jpeg.py keeps a numpy version of steps 2 and 3 beside these.

#include <cstdint>
#include <cstring>

namespace {

// jpeg_natural_order with libjpeg's 16 extra entries, which keep a corrupt
// run length (k > 63) inside the block
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLook = 8;  // jdhuff.c's HUFF_LOOKAHEAD

// jdhuff.c's d_derived_tbl: look[b] holds (length << 8 | symbol) of the
// code of at most kLook bits that the next kLook bits b start with, 0
// where none does (the bit-by-bit search then gives the same symbol)
struct Huff {
  int32_t maxcode[18];
  int32_t valoffset[18];
  const uint8_t* huffval;
  uint16_t look[1 << kLook];
};

// jpeg_make_d_derived_tbl; false for a table libjpeg rejects
bool derive(const uint8_t* bits, const uint8_t* vals, bool dc, Huff& h) {
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    const int n = bits[l - 1];
    if (p + n > 256) return false;
    for (int i = 0; i < n; ++i) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  const int nsym = p;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if ((int64_t)code >= ((int64_t)1 << si)) return false;
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l - 1]) {
      h.valoffset[l] = p - (int32_t)huffcode[p];
      p += bits[l - 1];
      h.maxcode[l] = (int32_t)huffcode[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.valoffset[17] = 0;
  h.maxcode[17] = 0xFFFFF;
  h.huffval = vals;
  for (int i = 0; i < (1 << kLook); ++i) h.look[i] = 0;
  p = 0;
  for (int l = 1; l <= kLook; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++p) {
      // every kLook-bit string that starts with this code
      const int first = (int)huffcode[p] << (kLook - l);
      for (int k = 0; k < (1 << (kLook - l)); ++k)
        h.look[first + k] = (uint16_t)(l << 8 | vals[p]);
    }
  }
  if (dc)
    for (int i = 0; i < nsym; ++i)
      if (vals[i] > 15) return false;
  return true;
}

// The entropy-coded data after the SOS header: jdhuff.c's bit buffer over
// jdmarker.c's byte source. `marker` is libjpeg's unread_marker: once a
// marker (or the end of the data, read as the fake EOI that jdatasrc.c
// inserts) is met, the buffer is filled with zero bits.
struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int nbits = 0;
  int marker = 0;
  bool insufficient = false;

  int byte() {  // the next byte of the source, -1 past its end
    if (p >= end) return -1;
    return *p++;
  }

  // jpeg_fill_bit_buffer: whole bytes until 57 bits are held or a marker
  void fill() {
    while (nbits <= 56 && marker == 0) {
      int c = byte();
      if (c < 0) {
        marker = 0xD9;
        break;
      }
      if (c == 0xFF) {
        do {
          c = byte();
        } while (c == 0xFF);
        if (c < 0) {
          marker = 0xD9;
          break;
        }
        if (c != 0) {
          marker = c;
          break;
        }
        c = 0xFF;
      }
      buf = (buf << 8) | (uint64_t)c;
      nbits += 8;
    }
  }

  int get(int n) {  // n <= 16 bits, zero bits past a marker
    if (nbits < n) {
      fill();
      if (nbits < n) {
        insufficient = true;
        buf <<= (n - nbits);
        nbits = n;
      }
    }
    nbits -= n;
    return (int)((buf >> nbits) & ((1u << n) - 1));
  }

  // HUFF_DECODE: a code of at most kLook bits from the lookahead table;
  // else, or near a marker, jpeg_huff_decode bit by bit (a bad code gives
  // symbol 0 after 17 bits)
  int decode(const Huff& h) {
    if (nbits < kLook) fill();
    if (nbits >= kLook) {
      const int e = h.look[(buf >> (nbits - kLook)) & ((1 << kLook) - 1)];
      if (e) {
        nbits -= e >> 8;
        return e & 0xFF;
      }
    }
    int l = 1;
    int32_t code = get(1);
    while (code > h.maxcode[l]) {
      code = (code << 1) | get(1);
      ++l;
    }
    if (l > 16) return 0;
    return h.huffval[(code + h.valoffset[l]) & 0xFF];
  }

  // jdmarker.c next_marker: skip to an FF, then past fill FFs
  void next_marker() {
    for (;;) {
      int c = byte();
      while (c >= 0 && c != 0xFF) c = byte();
      if (c < 0) {
        marker = 0xD9;
        return;
      }
      do {
        c = byte();
      } while (c == 0xFF);
      if (c < 0) {
        marker = 0xD9;
        return;
      }
      if (c != 0) {
        marker = c;
        return;
      }
    }
  }

  // process_restart: drop the buffered bits, read RSTn (resynchronising by
  // jpeg_resync_to_restart where another marker stands), and clear the
  // out-of-data flag unless a marker is still pending
  void restart(int& next_num) {
    nbits = 0;
    buf = 0;
    if (marker == 0) next_marker();
    if (marker == 0xD0 + next_num) {
      marker = 0;
    } else {
      for (;;) {
        int action;
        if (marker < 0xC0) {
          action = 2;
        } else if (marker < 0xD0 || marker > 0xD7) {
          action = 3;
        } else if (marker == 0xD0 + ((next_num + 1) & 7) ||
                   marker == 0xD0 + ((next_num + 2) & 7)) {
          action = 3;
        } else if (marker == 0xD0 + ((next_num - 1) & 7) ||
                   marker == 0xD0 + ((next_num - 2) & 7)) {
          action = 2;
        } else {
          action = 1;
        }
        if (action == 1) {
          marker = 0;
          break;
        }
        if (action == 3) break;
        marker = 0;
        next_marker();
      }
    }
    next_num = (next_num + 1) & 7;
    if (marker == 0) insufficient = false;
  }
};

inline int extend(int v, int s) {  // HUFF_EXTEND
  return v < (1 << (s - 1)) ? v + (int)((~0u) << s) + 1 : v;
}

// jidctint.c's constants
constexpr int kConst = 13, kPass1 = 2;
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433,
                  F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                  F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                  F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

inline int64_t wrap16(int64_t x) { return (int64_t)(int16_t)(uint16_t)x; }

inline int64_t sat16(int64_t x) {
  return x < -32768 ? -32768 : x > 32767 ? 32767 : x;
}

// One 1-D pass of jpeg_idct_islow over in[0], in[s], ..., in[7 s];
// out[k * os] = DESCALE(..., shift), with the SIMD version's 16-bit sums
inline void idct_1d(const int64_t* in, int s, int64_t* out, int os,
                    int shift) {
  int64_t z2 = in[2 * s], z3 = in[6 * s];
  int64_t z1 = (z2 + z3) * F0_541;
  int64_t tmp2 = z1 + z3 * -F1_847;
  int64_t tmp3 = z1 + z2 * F0_765;
  int64_t tmp0 = wrap16(in[0] + in[4 * s]) * ((int64_t)1 << kConst);
  int64_t tmp1 = wrap16(in[0] - in[4 * s]) * ((int64_t)1 << kConst);
  const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
  const int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
  tmp0 = in[7 * s];
  tmp1 = in[5 * s];
  tmp2 = in[3 * s];
  tmp3 = in[1 * s];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = wrap16(tmp0 + tmp2);
  int64_t z4 = wrap16(tmp1 + tmp3);
  const int64_t z5 = (z3 + z4) * F1_175;
  tmp0 *= F0_298;
  tmp1 *= F2_053;
  tmp2 *= F3_072;
  tmp3 *= F1_501;
  z1 *= -F0_899;
  z2 *= -F2_562;
  z3 *= -F1_961;
  z4 *= -F0_390;
  z3 += z5;
  z4 += z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  out[0 * os] = descale(t10 + tmp3, shift);
  out[7 * os] = descale(t10 - tmp3, shift);
  out[1 * os] = descale(t11 + tmp2, shift);
  out[6 * os] = descale(t11 - tmp2, shift);
  out[2 * os] = descale(t12 + tmp1, shift);
  out[5 * os] = descale(t12 - tmp1, shift);
  out[3 * os] = descale(t13 + tmp0, shift);
  out[4 * os] = descale(t13 - tmp0, shift);
}

inline uint8_t clamp255(int64_t v) {
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

}  // namespace

extern "C" {

// Decodes the scan that starts at `data` (n bytes, to the end of the file)
// into the components' coefficients. ncomp components; for component c:
// h[c], v[c] its sampling factors (1, 1 for a one-component scan), dc[c]
// and ac[c] its table numbers, coef[c] its (bh[c] x bw[c] blocks, 64) int16
// buffer, zeroed by the caller. `bits` holds 8 tables of 16 counts (DC 0-3,
// then AC 0-3), `vals` 8 x 256 symbols. mcux x mcuy MCUs, a restart every
// `restart` MCUs (0: none). Returns 0, or -1 for a Huffman table libjpeg
// rejects. `status` receives 1 where the data ran out (zero bits stuffed).
int jpeg_entropy_decode(const uint8_t* data, int64_t n, int ncomp,
                        const int* h, const int* v, const int* dc,
                        const int* ac, int16_t* const* coef, const int* bw,
                        const uint8_t* bits, const uint8_t* vals, int mcux,
                        int mcuy, int restart, int* status) {
  Huff tables[8];
  for (int c = 0; c < ncomp; ++c) {
    if (!derive(bits + 16 * dc[c], vals + 256 * dc[c], true, tables[dc[c]]))
      return -1;
    if (!derive(bits + 16 * (4 + ac[c]), vals + 256 * (4 + ac[c]), false,
                tables[4 + ac[c]]))
      return -1;
  }
  Reader rd{data, data + n};
  int last_dc[4] = {0, 0, 0, 0};
  int next_restart = 0;
  int to_go = restart;
  bool ran_out = false;
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      if (restart) {
        if (to_go == 0) {
          rd.restart(next_restart);
          for (int c = 0; c < ncomp; ++c) last_dc[c] = 0;
          to_go = restart;
        }
        --to_go;
      }
      if (rd.insufficient) {
        ran_out = true;
        continue;  // the MCU stays zero
      }
      for (int c = 0; c < ncomp; ++c) {
        const Huff& dt = tables[dc[c]];
        const Huff& at = tables[4 + ac[c]];
        for (int by = 0; by < v[c]; ++by) {
          for (int bx = 0; bx < h[c]; ++bx) {
            const int64_t blk =
                (int64_t)(my * v[c] + by) * bw[c] + (mx * h[c] + bx);
            int16_t* b = coef[c] + 64 * blk;
            int s = rd.decode(dt);
            if (s) s = extend(rd.get(s), s);
            last_dc[c] = (int)((unsigned)last_dc[c] + (unsigned)s);
            b[0] = (int16_t)last_dc[c];
            for (int k = 1; k < 64; ++k) {
              int rs = rd.decode(at);
              const int r = rs >> 4;
              s = rs & 15;
              if (s) {
                k += r;
                b[kNatural[k]] = (int16_t)extend(rd.get(s), s);
              } else {
                if (r != 15) break;
                k += 15;
              }
            }
          }
        }
      }
    }
  }
  *status = ran_out || rd.insufficient ? 1 : 0;
  return 0;
}

// Dequantises and inverse-transforms nblocks blocks of coef (natural
// order) by `quant` (64 values, natural order) into a plane of
// (8 bh) x (8 bw) samples, block b at row b / bw, column b % bw.
void jpeg_idct_plane(const int16_t* coef, const uint16_t* quant, int bh,
                     int bw, uint8_t* out) {
  const int64_t stride = 8 * (int64_t)bw;
  for (int64_t b = 0; b < (int64_t)bh * bw; ++b) {
    const int16_t* cb = coef + 64 * b;
    int64_t in[64], ws[64], row[8];
    bool ac_rows = false;  // a coefficient in rows 1-7
    for (int i = 0; i < 64; ++i) {
      in[i] = wrap16((int64_t)cb[i] * quant[i]);
      ac_rows |= i >= 8 && cb[i] != 0;
    }
    for (int col = 0; col < 8; ++col) {  // pass 1: columns into ws
      if (ac_rows) {
        idct_1d(in + col, 8, ws + col, 8, kConst - kPass1);
        for (int r = 0; r < 8; ++r) ws[8 * r + col] = sat16(ws[8 * r + col]);
      } else {
        for (int r = 0; r < 8; ++r) ws[8 * r + col] = wrap16(in[col] * 4);
      }
    }
    uint8_t* o = out + (b / bw) * 8 * stride + (b % bw) * 8;
    for (int r = 0; r < 8; ++r) {  // pass 2: rows, then the level shift
      idct_1d(ws + 8 * r, 1, row, 1, kConst + kPass1 + 3);
      for (int k = 0; k < 8; ++k) o[r * stride + k] = clamp255(row[k] + 128);
    }
  }
}

// Upsamples a component plane `in` (rows of `in_stride` samples, the first
// cw x ch of them real) by hx x vx into `out` (oh rows of ow samples, the
// image's size): jdsample.c's h2v1 and h2v2 fancy upsampling where cw > 2,
// h1v2 fancy upsampling, plain copies and box replication otherwise. Rows
// above the first and below the last repeat the edge row, as jdmainct.c's
// context rows do.
void jpeg_upsample_plane(const uint8_t* in, int in_stride, int cw, int ch,
                         int hx, int vx, uint8_t* out, int ow, int oh) {
  uint8_t* line = new uint8_t[(size_t)hx * cw];  // an upsampled row
  uint8_t* col = new uint8_t[(size_t)cw];        // a row upsampled along y
  auto src = [&](int r) {
    return in + (int64_t)(r < 0 ? 0 : r >= ch ? ch - 1 : r) * in_stride;
  };
  const bool fancy_w = hx == 2 && cw > 2;
  for (int y = 0; y < oh; ++y) {
    const int r = y / vx;
    if (hx == 2 && vx == 2 && fancy_w) {  // h2v2_fancy_upsample
      const uint8_t* p0 = src(r);
      const uint8_t* p1 = src(y % 2 == 0 ? r - 1 : r + 1);
      int last = 0, cur = p0[0] * 3 + p1[0];
      for (int i = 0; i < cw; ++i) {
        const int next = i + 1 < cw ? p0[i + 1] * 3 + p1[i + 1] : 0;
        line[2 * i] = (uint8_t)(i == 0 ? (cur * 4 + 8) >> 4
                                       : (cur * 3 + last + 8) >> 4);
        line[2 * i + 1] = (uint8_t)(i == cw - 1 ? (cur * 4 + 7) >> 4
                                                : (cur * 3 + next + 7) >> 4);
        last = cur;
        cur = next;
      }
    } else {
      // along y: h1v2_fancy_upsample, or the source row repeated
      const uint8_t* p = src(r);
      if (vx == 2 && hx == 1) {
        const uint8_t* p1 = src(y % 2 == 0 ? r - 1 : r + 1);
        const int bias = y % 2 == 0 ? 1 : 2;
        for (int i = 0; i < cw; ++i)
          col[i] = (uint8_t)((p[i] * 3 + p1[i] + bias) >> 2);
        p = col;
      }
      // along x: h2v1_fancy_upsample, or each sample repeated
      if (fancy_w && vx == 1) {
        line[0] = p[0];
        line[1] = (uint8_t)((p[0] * 3 + p[1] + 2) >> 2);
        for (int i = 1; i < cw - 1; ++i) {
          const int x = p[i] * 3;
          line[2 * i] = (uint8_t)((x + p[i - 1] + 1) >> 2);
          line[2 * i + 1] = (uint8_t)((x + p[i + 1] + 2) >> 2);
        }
        line[2 * cw - 2] = (uint8_t)((p[cw - 1] * 3 + p[cw - 2] + 1) >> 2);
        line[2 * cw - 1] = p[cw - 1];
      } else {
        for (int i = 0; i < cw; ++i)
          for (int k = 0; k < hx; ++k) line[i * hx + k] = p[i];
      }
    }
    std::memcpy(out + (int64_t)y * ow, line, ow);
  }
  delete[] line;
  delete[] col;
}

// jdcolor.c ycc_rgb_convert (tables of build_ycc_rgb_table), n samples of
// three planes into interleaved BGR
void jpeg_ycc_to_bgr(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                     int64_t n, uint8_t* out) {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  const int64_t half = (int64_t)1 << 15;
  auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
  for (int i = 0; i < 256; ++i) {
    const int64_t x = i - 128;
    cr_r[i] = (int)((fix(1.40200) * x + half) >> 16);
    cb_b[i] = (int)((fix(1.77200) * x + half) >> 16);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + half;
  }
  for (int64_t i = 0; i < n; ++i) {
    const int Y = y[i], B = cb[i], R = cr[i];
    out[3 * i + 2] = clamp255(Y + cr_r[R]);
    out[3 * i + 1] = clamp255(Y + (int)((cb_g[B] + cr_g[R]) >> 16));
    out[3 * i + 0] = clamp255(Y + cb_b[B]);
  }
}

}  // extern "C"
