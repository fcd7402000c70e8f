// JPEG decoding on the host, with the arithmetic of libjpeg-turbo 3.1's
// defaults (what cv2.imread runs), so that a frame decodes to the same bytes
// as cv2 gives. Bound with ctypes by io/jpeg.py, which parses the markers
// and calls the steps here:
//
// 1. jpeg_decode_scan: one Huffman-coded scan into the components'
//    quantised coefficients, natural order, as JCOEF (int16), in the
//    whole-image buffers that every scan of a file adds to. A sequential
//    scan (jdhuff.c) decodes whole blocks; a progressive one (jdphuff.c)
//    decodes a band of them: a DC first or refining scan of one or more
//    components, or an AC first or refining scan of one (EOB runs,
//    correction bits). Restart markers (DRI/RSTn) reset the DC predictors
//    and the EOB run; a marker or the end of the data where bits are
//    still needed stuffs zero bits and leaves the rest of the restart
//    segment's MCUs as they were, which is what libjpeg does (uniform gray
//    where a baseline file is cut short). A misplaced restart marker is
//    resynchronised by jdmarker.c's rules. The scan's end is reported:
//    the marker that ends it and whether the data ran out first.
// 1b. jpeg_smooth_plane: jdcoefct.c's block smoothing of a progressive
//    file whose low coefficients are incomplete at output (a file cut
//    between or inside its scans, or a script that never sends them):
//    the DC and the first nine AC coefficients predicted from the 5 x 5
//    neighbourhood of DC values (libjpeg-turbo 2.1 and later).
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

#include <climits>
#include <cstdint>
#include <cstring>
#include <utility>

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

// jpeg_make_d_derived_tbl; false for a table libjpeg rejects (a DC table's
// symbols above max_sym: 15, or 16 in a lossless file; -1: an AC table)
bool derive(const uint8_t* bits, const uint8_t* vals, int max_sym, Huff& h) {
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
  if (max_sym >= 0)
    for (int i = 0; i < nsym; ++i)
      if (vals[i] > max_sym) return false;
  return true;
}

// jdmarker.c's byte source over the file: its bytes, then (jdatasrc.c) fake
// EOI markers. `marker` is libjpeg's unread_marker.
struct Source {
  const uint8_t* p;
  const uint8_t* end;
  int marker = 0;
  bool eof = false;  // a byte past the end was asked for (jdatasrc.c's
                     // fake EOI; a suspending source stops there)

  int byte() {  // the next byte of the source, -1 past its end
    if (p >= end) {
      eof = true;
      return -1;
    }
    return *p++;
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

  // read_restart_marker: read RSTn, resynchronising by
  // jpeg_resync_to_restart where another marker stands
  void restart_marker(int& next_num) {
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
  }
};

// The Huffman-coded data after the SOS header: jdhuff.c's bit buffer over
// the source. Once a marker (or the end of the data, read as the fake EOI
// that jdatasrc.c inserts) is met, the buffer is filled with zero bits.
struct Reader : Source {
  uint64_t buf = 0;
  int nbits = 0;
  bool insufficient = false;

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

  // process_restart: drop the buffered bits, read RSTn, and clear the
  // out-of-data flag unless a marker is still pending
  void restart(int& next_num) {
    nbits = 0;
    buf = 0;
    restart_marker(next_num);
    if (marker == 0) insufficient = false;
  }
};

// jaricom.c's jpeg_aritab (T.81 Table D.2): Qe << 16 | the next state after
// an MPS << 8 | the MPS switch << 7 | the next state after an LPS; state 113
// is the fixed estimate of one half
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

// The arithmetic-coded data after the SOS header: jdarith.c's QM decoder
// (sections D.2.4-D.2.6) over the source; past a marker (legal inside the
// data) it reads zero bytes. ct = -1 is jdarith.c's error state: the rest
// of the restart interval is left as it was.
struct ArithReader : Source {
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: two bytes to read before the first decision

  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (marker == 0) {
          data = byte();
          if (data < 0) {
            marker = 0xD9;  // the fake EOI
            data = 0;
          } else if (data == 0xFF) {
            do {
              data = byte();
            } while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              marker = data < 0 ? 0xD9 : data;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t qe = kAritab[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - (int64_t)qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < (int64_t)qe) {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < (int64_t)qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // process_restart's reader part: RSTn, then two bytes to read again
  void restart(int& next_num) {
    restart_marker(next_num);
    c = a = 0;
    ct = -16;
  }
};

// Figures F.21-F.24 after the sign: a nonzero value's magnitude category
// from bin st (continuing at `large` above the first category for a DC
// value, above the second for an AC one), then its bits. Returns |v| - 1
// (m: its category's magnitude), or -1 where the category overflows
// (jdarith.c's JWRN_ARITH_BAD_CODE).
inline int arith_magnitude(ArithReader& rd, uint8_t* stats, uint8_t* st,
                           int large, bool dc, int& mag) {
  int m = rd.decode(st);
  if (m != 0) {
    if (dc || rd.decode(st)) {
      if (!dc) m <<= 1;
      st = stats + large;
      while (rd.decode(st)) {
        if ((m <<= 1) == 0x8000) return -1;
        st += 1;
      }
    }
  }
  mag = m;
  int v = m;
  st += 14;
  while (m >>= 1)
    if (rd.decode(st)) v |= m;
  return v;
}

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

// One block of a sequential scan (jdhuff.c decode_mcu): the DC difference
// added to the predictor, then the AC run/size symbols
inline void sequential_block(Reader& rd, const Huff& dt, const Huff& at,
                             int& last_dc, int16_t* b) {
  int s = rd.decode(dt);
  if (s) s = extend(rd.get(s), s);
  last_dc = (int)((unsigned)last_dc + (unsigned)s);
  b[0] = (int16_t)last_dc;
  for (int k = 1; k < 64; ++k) {
    const int rs = rd.decode(at);
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

// jdphuff.c decode_mcu_AC_refine for one block: correction bits for the
// coefficients already nonzero, newly nonzero ones of magnitude 1 << al
inline void ac_refine_block(Reader& rd, const Huff& at, int ss, int se,
                            int al, unsigned& eobrun, int16_t* b) {
  const int p1 = 1 << al;
  const int m1 = -p1;
  auto correct = [&](int16_t* t) {
    if (rd.get(1) && (*t & p1) == 0)
      *t = (int16_t)(*t >= 0 ? *t + p1 : *t + m1);
  };
  int k = ss;
  if (eobrun == 0) {
    for (; k <= se; ++k) {
      const int rs = rd.decode(at);
      int r = rs >> 4;
      int s = rs & 15;
      if (s) {
        s = rd.get(1) ? p1 : m1;  // a size other than 1 is only warned of
      } else if (r != 15) {
        eobrun = 1u << r;
        if (r) eobrun += (unsigned)rd.get(r);
        break;  // the rest of the band goes by the EOB run below
      }
      do {  // past the nonzero coefficients and r zero ones
        int16_t* t = b + kNatural[k];
        if (*t != 0) {
          correct(t);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= se);
      if (s) b[kNatural[k]] = (int16_t)s;
    }
  }
  if (eobrun > 0) {
    for (; k <= se; ++k) {
      int16_t* t = b + kNatural[k];
      if (*t != 0) correct(t);
    }
    --eobrun;
  }
}

}  // namespace

extern "C" {

// Decodes the scan whose entropy-coded data starts at data[start] (the
// file is n bytes) into the components' coefficients. ncomp components in
// the scan; for component c: h[c], v[c] its blocks in an MCU (1, 1 in a
// scan of one component, whose MCUs are its real blocks), dc[c] and ac[c]
// its table numbers, coef[c] its whole-image buffer of rows of bw[c]
// blocks (64 int16 each). `bits` holds 8 tables of 16 counts (DC 0-3, then
// AC 0-3), `vals` 8 x 256 symbols. mcux x mcuy MCUs, a restart every
// `restart` MCUs (0: none). progressive = 0: a sequential scan (ss, se, ah,
// al unused); else the spectral band ss..se (zigzag) and the successive
// approximation bits ah, al, checked by the caller. Returns 0; -1 for a
// Huffman table libjpeg rejects; -2 for a DC value past 32 bits (libjpeg's
// JERR_BAD_DCT_COEF). stop[0] receives the offset after the marker that
// ends the scan (n where the data ran out), stop[1] that marker (0xD9 where
// the data ran out), stop[2] the first MCU in which the data ran out (-1:
// none; zero bits were stuffed from there), stop[3] 1 where a byte past
// the end of the data was asked for while decoding the MCUs, stop[4] 1
// where that happened by the scan's end marker.
int jpeg_decode_scan(const uint8_t* data, int64_t n, int64_t start,
                     int ncomp, const int* h, const int* v, const int* dc,
                     const int* ac, int16_t* const* coef, const int* bw,
                     const uint8_t* bits, const uint8_t* vals, int mcux,
                     int mcuy, int restart, int progressive, int ss, int se,
                     int ah, int al, int64_t* stop) {
  const bool dc_band = progressive && ss == 0;
  const bool need_dc = !progressive || (dc_band && ah == 0);
  const bool need_ac = !progressive || !dc_band;
  Huff tables[8];
  for (int c = 0; c < ncomp; ++c) {
    if (need_dc && !derive(bits + 16 * dc[c], vals + 256 * dc[c], 15,
                           tables[dc[c]]))
      return -1;
    if (need_ac && !derive(bits + 16 * (4 + ac[c]), vals + 256 * (4 + ac[c]),
                           -1, tables[4 + ac[c]]))
      return -1;
  }
  Reader rd{data + start, data + n};
  int last_dc[4] = {0, 0, 0, 0};
  unsigned eobrun = 0;
  int next_restart = 0;
  int to_go = restart;
  int64_t first_short = -1;  // the first MCU in which the data ran out
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      if (rd.insufficient && first_short < 0)
        first_short = (int64_t)my * mcux + mx - 1;
      if (restart) {
        if (to_go == 0) {
          rd.restart(next_restart);
          for (int c = 0; c < ncomp; ++c) last_dc[c] = 0;
          eobrun = 0;
          to_go = restart;
        }
        --to_go;
      }
      if (rd.insufficient) continue;  // the MCU stays as it was
      if (need_ac && progressive && eobrun > 0 && ah == 0) {
        --eobrun;  // a band of zeroes in an AC first scan
        continue;
      }
      for (int c = 0; c < ncomp; ++c) {
        const Huff& dt = tables[dc[c]];
        const Huff& at = tables[4 + ac[c]];
        for (int by = 0; by < v[c]; ++by) {
          for (int bx = 0; bx < h[c]; ++bx) {
            const int64_t blk =
                (int64_t)(my * v[c] + by) * bw[c] + (mx * h[c] + bx);
            int16_t* b = coef[c] + 64 * blk;
            if (!progressive) {
              sequential_block(rd, dt, at, last_dc[c], b);
            } else if (dc_band && ah == 0) {  // DC first
              int s = rd.decode(dt);
              if (s) s = extend(rd.get(s), s);
              const int last = last_dc[c];
              if ((last >= 0 && s > INT_MAX - last) ||
                  (last < 0 && s < INT_MIN - last))
                return -2;
              last_dc[c] = last + s;
              b[0] = (int16_t)((unsigned)last_dc[c] << al);
            } else if (dc_band) {  // DC refine: the next bit of the value
              if (rd.get(1)) b[0] = (int16_t)(b[0] | (1 << al));
            } else if (ah == 0) {  // AC first
              for (int k = ss; k <= se; ++k) {
                const int rs = rd.decode(at);
                const int r = rs >> 4;
                const int s = rs & 15;
                if (s) {
                  k += r;
                  b[kNatural[k]] =
                      (int16_t)((unsigned)extend(rd.get(s), s) << al);
                } else if (r == 15) {
                  k += 15;
                } else {
                  eobrun = 1u << r;
                  if (r) eobrun += (unsigned)rd.get(r);
                  --eobrun;  // this block is the run's first
                  break;
                }
              }
            } else {
              ac_refine_block(rd, at, ss, se, al, eobrun, b);
            }
          }
        }
      }
    }
  }
  if (rd.insufficient && first_short < 0)
    first_short = (int64_t)mcuy * mcux - 1;
  stop[2] = first_short;
  stop[3] = rd.eof ? 1 : 0;
  if (rd.marker == 0) rd.next_marker();  // jdmarker.c read_markers
  stop[0] = rd.p - data;
  stop[1] = rd.marker;
  stop[4] = rd.eof ? 1 : 0;
  return 0;
}

// Decodes the arithmetic-coded scan whose data starts at data[start]
// (jdarith.c) into the components' coefficients: the arguments of
// jpeg_decode_scan, with `dac` in place of the Huffman tables: the DAC
// conditioning of the 16 tables, L[16], U[16] (DC) then K[16] (AC). Tables
// are numbered 0-15. stop[0..4] as jpeg_decode_scan's (stop[2] is always
// -1: arithmetic decoding has no out-of-data state, a marker supplies zero
// bits), stop[5] the offset one past the last byte the decoder asked for
// (where a suspending reader must have had the data).
int jpeg_decode_arith_scan(const uint8_t* data, int64_t n, int64_t start,
                           int ncomp, const int* h, const int* v,
                           const int* dc, const int* ac,
                           int16_t* const* coef, const int* bw,
                           const uint8_t* dac, int mcux, int mcuy,
                           int restart, int progressive, int ss, int se,
                           int ah, int al, int64_t* stop) {
  const bool dc_first = !progressive || (ss == 0 && ah == 0);
  const bool ac_stats = !progressive || ss != 0;
  static thread_local uint8_t dc_stats[16][64], ac_stat[16][256];
  uint8_t fixed = 113;
  int last_dc[4] = {0, 0, 0, 0}, context[4] = {0, 0, 0, 0};
  auto reset = [&]() {
    for (int c = 0; c < ncomp; ++c) {
      if (dc_first) {
        std::memset(dc_stats[dc[c]], 0, 64);
        last_dc[c] = context[c] = 0;
      }
      if (ac_stats) std::memset(ac_stat[ac[c]], 0, 256);
    }
  };
  reset();
  ArithReader rd;
  rd.p = data + start;
  rd.end = data + n;
  int next_restart = 0;
  int to_go = restart;
  const int p1 = 1 << al, m1 = -(1 << al);
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      if (restart) {
        if (to_go == 0) {
          rd.restart(next_restart);
          reset();
          to_go = restart;
        }
        --to_go;
      }
      if (rd.ct == -1) continue;  // the MCUs stay as they were
      for (int c = 0; c < ncomp && rd.ct != -1; ++c) {
        for (int by = 0; by < v[c] && rd.ct != -1; ++by) {
          for (int bx = 0; bx < h[c] && rd.ct != -1; ++bx) {
            const int64_t blk =
                (int64_t)(my * v[c] + by) * bw[c] + (mx * h[c] + bx);
            int16_t* b = coef[c] + 64 * blk;
            if (progressive && ss == 0 && ah != 0) {  // DC refinement
              if (rd.decode(&fixed)) b[0] = (int16_t)(b[0] | p1);
              continue;
            }
            if (dc_first) {  // F.2.4.1: the DC difference
              uint8_t* stats = dc_stats[dc[c]];
              uint8_t* st = stats + context[c];
              if (rd.decode(st) == 0) {
                context[c] = 0;
              } else {
                const int sign = rd.decode(st + 1);
                int m;
                int val = arith_magnitude(rd, stats, st + 2 + sign, 20, true,
                                          m);
                if (val < 0) {
                  rd.ct = -1;
                  break;
                }
                const int L = dac[dc[c]], U = dac[16 + dc[c]];
                if (m < (int)((1L << L) >> 1))
                  context[c] = 0;
                else if (m > (int)((1L << U) >> 1))
                  context[c] = 12 + sign * 4;
                else
                  context[c] = 4 + sign * 4;
                val += 1;
                if (sign) val = -val;
                last_dc[c] = (last_dc[c] + val) & 0xFFFF;
              }
              b[0] = (int16_t)(progressive ? (unsigned)last_dc[c] << al
                                           : (unsigned)last_dc[c]);
              if (progressive) continue;
            }
            uint8_t* stats = ac_stat[ac[c]];
            const int K = dac[32 + ac[c]];
            const int lo = progressive ? ss : 1, hi = progressive ? se : 63;
            if (!progressive || ah == 0) {  // F.2.4.2: AC first
              for (int k = lo; k <= hi; ++k) {
                uint8_t* st = stats + 3 * (k - 1);
                if (rd.decode(st)) break;  // EOB
                while (rd.decode(st + 1) == 0) {
                  st += 3;
                  if (++k > hi) {
                    rd.ct = -1;  // spectral overflow
                    break;
                  }
                }
                if (rd.ct == -1) break;
                const int sign = rd.decode(&fixed);
                int m;
                int val = arith_magnitude(rd, stats, st + 2,
                                          k <= K ? 189 : 217, false, m);
                if (val < 0) {
                  rd.ct = -1;
                  break;
                }
                val += 1;
                if (sign) val = -val;
                b[kNatural[k]] = (int16_t)(progressive
                                               ? (unsigned)val << al
                                               : (unsigned)val);
              }
              continue;
            }
            int kex = hi;  // G.1.3.3: AC refinement
            for (; kex > 0; --kex)
              if (b[kNatural[kex]]) break;
            for (int k = lo; k <= hi; ++k) {
              uint8_t* st = stats + 3 * (k - 1);
              if (k > kex && rd.decode(st)) break;  // EOB
              for (;;) {
                int16_t* t = b + kNatural[k];
                if (*t) {
                  if (rd.decode(st + 2))
                    *t = (int16_t)(*t < 0 ? *t + m1 : *t + p1);
                  break;
                }
                if (rd.decode(st + 1)) {
                  *t = (int16_t)(rd.decode(&fixed) ? m1 : p1);
                  break;
                }
                st += 3;
                if (++k > hi) {
                  rd.ct = -1;
                  break;
                }
              }
              if (rd.ct == -1) break;
            }
          }
        }
      }
    }
  }
  stop[2] = -1;
  stop[3] = rd.eof ? 1 : 0;
  stop[5] = rd.p - data;
  if (rd.marker == 0) rd.next_marker();
  stop[0] = rd.p - data;
  stop[1] = rd.marker;
  stop[4] = rd.eof ? 1 : 0;
  return 0;
}

// Decodes the lossless scan whose Huffman-coded data starts at data[start]
// (libjpeg-turbo 3's jdlhuff.c, jddiffct.c and jdlossls.c) into the
// components' sample planes: plane[c] of rows of cw[c] samples, ch[c] rows.
// ncomp components in the scan, each with h[c] x v[c] samples in an MCU
// (1, 1 for a scan of one component) and its DC table dc[c] (bits, vals as
// jpeg_decode_scan's). `imcu_rows` iMCU rows, `mcu_rows[r]` MCU rows in
// iMCU row r, mcus_per_row MCUs in each; comp_v[c] the component's sample
// rows in an iMCU row; a restart every `restart_rows` MCU rows (0: none).
// precision P, predictor psv (1-7) and point transform pt: each sample
// undifferenced modulo 2^16 (the first row of the scan, and of the iMCU
// row in which a restart marker is read, by the 1-D rule from
// 2^(P - pt - 1)), then shifted left by pt into 8 bits. Where the data runs
// out, the rest of that MCU row decodes from zero bits and the next MCU
// rows are zero differences from restarted predictors (their samples
// 2^(P - pt - 1) << pt), until a restart. Returns 0; -1 for a Huffman
// table libjpeg rejects. stop as jpeg_decode_arith_scan's.
int jpeg_decode_lossless_scan(const uint8_t* data, int64_t n, int64_t start,
                              int ncomp, const int* h, const int* v,
                              const int* dc, uint8_t* const* plane,
                              const int* cw, const int* ch, const int* comp_v,
                              const uint8_t* bits, const uint8_t* vals,
                              int imcu_rows, const int* mcu_rows,
                              int mcus_per_row, int restart_rows,
                              int precision, int psv, int pt,
                              int64_t* stop) {
  Huff tables[4];
  for (int c = 0; c < ncomp; ++c)
    if (!derive(bits + 16 * dc[c], vals + 256 * dc[c], 16, tables[dc[c]]))
      return -1;
  Reader rd;
  rd.p = data + start;
  rd.end = data + n;
  // each component's differences of an iMCU row (comp_v rows of the MCU
  // row's width) and its previous undifferenced row
  int* diff[4];
  int* prev[4];
  int* cur[4];
  int width[4];
  bool first[4];
  for (int c = 0; c < ncomp; ++c) {
    width[c] = mcus_per_row * h[c];
    diff[c] = new int[(size_t)width[c] * comp_v[c]]();
    prev[c] = new int[(size_t)cw[c] + 1]();
    cur[c] = new int[(size_t)cw[c] + 1]();
    first[c] = true;
  }
  const int initial = 1 << (precision - pt - 1);
  int next_restart = 0;
  int to_go = restart_rows;
  for (int r = 0; r < imcu_rows; ++r) {
    for (int y = 0; y < mcu_rows[r]; ++y) {
      if (restart_rows) {
        if (to_go == 0) {
          rd.restart(next_restart);
          for (int c = 0; c < ncomp; ++c) first[c] = true;
          to_go = restart_rows;
        }
      }
      if (rd.insufficient) {  // zero differences, restarted predictors
        for (int c = 0; c < ncomp; ++c) {
          const int rows = ncomp > 1 ? v[c] : 1;
          for (int i = 0; i < rows; ++i)
            std::memset(diff[c] + (size_t)(y * rows + i) * width[c], 0,
                        sizeof(int) * width[c]);
          first[c] = true;
        }
      } else {
        for (int mx = 0; mx < mcus_per_row; ++mx) {
          for (int c = 0; c < ncomp; ++c) {
            const Huff& t = tables[dc[c]];
            const int rows = ncomp > 1 ? v[c] : 1;
            for (int by = 0; by < rows; ++by) {
              for (int bx = 0; bx < h[c]; ++bx) {
                int s = rd.decode(t);
                if (s == 16) {
                  s = 32768;
                } else if (s) {
                  s = extend(rd.get(s), s);
                }
                diff[c][(size_t)(y * rows + by) * width[c] + mx * h[c] + bx] =
                    s;
              }
            }
          }
        }
      }
      if (restart_rows) --to_go;
    }
    // undifference and scale the iMCU row's rows of each component
    for (int c = 0; c < ncomp; ++c) {
      for (int i = 0; i < comp_v[c]; ++i) {
        const int row = r * comp_v[c] + i;
        if (row >= ch[c]) break;
        const int* d = diff[c] + (size_t)i * width[c];
        int* out = cur[c];
        const int* up = prev[c];
        if (first[c]) {
          int ra = (d[0] + initial) & 0xFFFF;
          out[0] = ra;
          for (int x = 1; x < cw[c]; ++x) out[x] = ra = (d[x] + ra) & 0xFFFF;
          first[c] = false;
        } else {
          int rb = up[0];
          int ra = (d[0] + rb) & 0xFFFF;
          out[0] = ra;
          for (int x = 1; x < cw[c]; ++x) {
            const int rc = rb;
            rb = up[x];
            int pred;
            switch (psv) {
              case 1: pred = ra; break;
              case 2: pred = rb; break;
              case 3: pred = rc; break;
              case 4: pred = ra + rb - rc; break;
              case 5: pred = ra + ((rb - rc) >> 1); break;
              case 6: pred = rb + ((ra - rc) >> 1); break;
              default: pred = (ra + rb) >> 1; break;
            }
            out[x] = ra = (d[x] + pred) & 0xFFFF;
          }
        }
        uint8_t* o = plane[c] + (int64_t)row * cw[c];
        for (int x = 0; x < cw[c]; ++x) o[x] = (uint8_t)(out[x] << pt);
        std::swap(prev[c], cur[c]);
      }
    }
  }
  for (int c = 0; c < ncomp; ++c) {
    delete[] diff[c];
    delete[] prev[c];
    delete[] cur[c];
  }
  stop[2] = -1;
  stop[3] = rd.eof ? 1 : 0;
  stop[5] = rd.p - data;
  if (rd.marker == 0) rd.next_marker();
  stop[0] = rd.p - data;
  stop[1] = rd.marker;
  stop[4] = rd.eof ? 1 : 0;
  return 0;
}

// jdcoefct.c decompress_smooth_data for one component: each real block
// (hib rows of wib, in a buffer of bh rows of bw blocks) of `coef` copied
// to `out`, its DC and first nine AC coefficients predicted from the 5 x 5
// DC values around it where they are incomplete. vs: the component's block
// rows in an iMCU row, of which there are imcu_rows; the rows above and
// below a block are taken as the iMCU rows' buffer gives them. quant: the
// component's table (natural order); bits: its successive-approximation
// bits of zigzag coefficients 0-9 (-1: none received).
void jpeg_smooth_plane(const int16_t* coef, int bh, int bw, int hib, int wib,
                       int vs, int imcu_rows, const uint16_t* quant,
                       const int* cur_bits, const int* prev_bits,
                       int last_good, int16_t* out) {
  std::memcpy(out, coef, sizeof(int16_t) * 64 * (size_t)bh * bw);
  const int64_t Q00 = quant[0], Q01 = quant[1], Q10 = quant[8],
                Q20 = quant[16], Q11 = quant[9], Q02 = quant[2],
                Q03 = quant[3], Q12 = quant[10], Q21 = quant[17],
                Q30 = quant[24];
  auto dcv = [&](int row, int col) {
    col = col < 0 ? 0 : col >= wib ? wib - 1 : col;
    return (int)coef[64 * ((int64_t)row * bw + col)];
  };
  // pred of a coefficient of table entry q from numerator num, held below
  // 1 << al where al bits are still unknown
  auto pred = [](int64_t q, int64_t num, int al) {
    int p;
    if (num >= 0) {
      p = (int)(((q << 7) + num) / (q << 8));
      if (al > 0 && p >= (1 << al)) p = (1 << al) - 1;
    } else {
      p = (int)(((q << 7) - num) / (q << 8));
      if (al > 0 && p >= (1 << al)) p = (1 << al) - 1;
      p = -p;
    }
    return (int16_t)p;
  };
  const int last = imcu_rows - 1;
  for (int r = 0; r <= last; ++r) {
    const int* bits = r > last_good ? prev_bits : cur_bits;
    bool change_dc = true;  // no AC coefficient known: the DC is smoothed
    for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
    const int rows = r < last ? vs : (hib % vs ? hib % vs : vs);
    for (int br = 0; br < rows; ++br) {
      // the rows around, as libjpeg counts them: the iMCU row's own number
      // of block rows times the iMCU rows (so an interleaved scan's padding
      // row below the image's last can be taken; the last iMCU row clamps
      // at itself)
      const int R = r * vs + br;
      const int ibr = r * rows + br;
      const int ibrs = rows * imcu_rows;
      const int prev = ibr > 0 ? R - 1 : R;
      const int pprev = ibr > 1 ? R - 2 : prev;
      const int next = ibr < ibrs - 1 ? R + 1 : R;
      const int nnext = ibr < ibrs - 2 ? R + 2 : next;
      for (int col = 0; col < wib; ++col) {
        const int DC01 = dcv(pprev, col - 2), DC02 = dcv(pprev, col - 1),
                  DC03 = dcv(pprev, col), DC04 = dcv(pprev, col + 1),
                  DC05 = dcv(pprev, col + 2);
        const int DC06 = dcv(prev, col - 2), DC07 = dcv(prev, col - 1),
                  DC08 = dcv(prev, col), DC09 = dcv(prev, col + 1),
                  DC10 = dcv(prev, col + 2);
        const int DC11 = dcv(R, col - 2), DC12 = dcv(R, col - 1),
                  DC13 = dcv(R, col), DC14 = dcv(R, col + 1),
                  DC15 = dcv(R, col + 2);
        const int DC16 = dcv(next, col - 2), DC17 = dcv(next, col - 1),
                  DC18 = dcv(next, col), DC19 = dcv(next, col + 1),
                  DC20 = dcv(next, col + 2);
        const int DC21 = dcv(nnext, col - 2), DC22 = dcv(nnext, col - 1),
                  DC23 = dcv(nnext, col), DC24 = dcv(nnext, col + 1),
                  DC25 = dcv(nnext, col + 2);
        int16_t* w = out + 64 * ((int64_t)R * bw + col);
        int al;
        if ((al = bits[1]) != 0 && w[1] == 0) {  // AC01
          const int64_t num = Q00 * (change_dc ?
              (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
               13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 +
               3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
               DC21 - DC22 + DC24 + DC25) :
              (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          w[1] = pred(Q01, num, al);
        }
        if ((al = bits[2]) != 0 && w[8] == 0) {  // AC10
          const int64_t num = Q00 * (change_dc ?
              (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
               13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
               13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
               3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
              (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          w[8] = pred(Q10, num, al);
        }
        if ((al = bits[3]) != 0 && w[16] == 0) {  // AC20
          const int64_t num = Q00 * (change_dc ?
              (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
               14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 +
               DC23) :
              (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
          w[16] = pred(Q20, num, al);
        }
        if ((al = bits[4]) != 0 && w[9] == 0) {  // AC11
          const int64_t num = Q00 * (change_dc ?
              (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
               DC21 - DC25) :
              (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
               DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
          w[9] = pred(Q11, num, al);
        }
        if ((al = bits[5]) != 0 && w[2] == 0) {  // AC02
          const int64_t num = Q00 * (change_dc ?
              (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
               14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
               2 * DC19) :
              (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
          w[2] = pred(Q02, num, al);
        }
        if (change_dc) {
          if ((al = bits[6]) != 0 && w[3] == 0)  // AC03
            w[3] = pred(Q03, Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 +
                                    DC17 - DC19), al);
          if ((al = bits[7]) != 0 && w[10] == 0)  // AC12
            w[10] = pred(Q12, Q00 * (DC07 - 3 * DC08 + DC09 - DC17 +
                                     3 * DC18 - DC19), al);
          if ((al = bits[8]) != 0 && w[17] == 0)  // AC21
            w[17] = pred(Q21, Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 +
                                     DC17 - DC19), al);
          if ((al = bits[9]) != 0 && w[24] == 0)  // AC30
            w[24] = pred(Q30, Q00 * (DC07 + 2 * DC08 + DC09 - DC17 -
                                     2 * DC18 - DC19), al);
          // the DC itself, a weighted mean of the 25 (weights sum to 256)
          w[0] = pred(Q00, Q00 * (
              -2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
              6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
              8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
              6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
              2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25), 0);
        }
      }
    }
  }
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
