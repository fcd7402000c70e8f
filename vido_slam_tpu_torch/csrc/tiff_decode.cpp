// TIFF strip and tile decoding on the host, as libtiff 4.7 decodes them
// for cv2.imread and PIL: LZW (tif_lzw.c: the 5.0 form, codes MSB first
// with the width raised one code early, and the old form libtiff still
// reads, LSB first and raised on time, told apart by the first two
// bytes), PackBits (tif_packbits.c) and the undoing of the horizontal
// (2) and floating-point (3) predictors (tif_predict.c). Each fills the
// chunk's `need` bytes or fails, as libtiff fails a strip it cannot fill.
// Bound with ctypes by io/tiff.py, which holds a plain Python version of
// each beside it.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kFirst = 258;
constexpr int kTableSize = 5120;  // libtiff's CSIZE: 4096 + 1024

struct Entry {
  int prev;        // the entry this one extends, -1 for a literal
  int length;      // 0: not defined
  uint8_t first;   // its string's first byte
  uint8_t value;   // its last byte
};

}  // namespace

extern "C" {

// Returns `need`, or -1 for a corrupt stream (a bad code, a table past its
// end), -2 where the codes end before `need` bytes (no EOI or an early
// one).
int64_t tiff_lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t need) {
  const bool old_style = n >= 2 && src[0] == 0 && (src[1] & 1);
  std::vector<Entry> tab(kTableSize);
  for (int i = 0; i < 256; ++i) tab[i] = {-1, 1, uint8_t(i), uint8_t(i)};
  int nbits = 9;
  int free_ent = kFirst;
  int maxcode = old_style ? 511 : 510;
  int old = -1;
  bool started = false;
  int64_t bitpos = 0;
  const int64_t nbits_total = n * 8;
  int64_t out = 0;
  std::vector<uint8_t> stack;
  auto next_code = [&](int* code) -> bool {
    if (nbits_total - bitpos < nbits) return false;
    uint32_t v = 0;
    if (old_style) {
      for (int k = 0; k < nbits; ++k) {
        const int64_t b = bitpos + k;
        v |= uint32_t((src[b >> 3] >> (b & 7)) & 1) << k;
      }
    } else {
      for (int k = 0; k < nbits; ++k) {
        const int64_t b = bitpos + k;
        v = (v << 1) | ((src[b >> 3] >> (7 - (b & 7))) & 1);
      }
    }
    bitpos += nbits;
    *code = int(v);
    return true;
  };
  auto reset = [&]() {
    for (int i = kFirst; i < kTableSize; ++i) tab[i] = {-1, 0, 0, 0};
    nbits = 9;
    free_ent = kFirst;
    maxcode = old_style ? 511 : 510;
  };
  while (out < need) {
    int code;
    if (!next_code(&code)) return -2;
    if (code == kEoi) return -2;
    if (code == kClear) {
      do {
        reset();
        if (!next_code(&code)) return -2;
      } while (code == kClear);
      if (code == kEoi) return -2;
      if (code > kClear) return -1;
      dst[out++] = uint8_t(code);
      old = code;
      started = true;
      continue;
    }
    if (!started || free_ent >= kTableSize) return -1;
    // the new entry: the previous string and the first byte of this one
    Entry& e = tab[free_ent];
    e.prev = old;
    e.first = tab[old].first;
    e.length = tab[old].length + 1;
    e.value = code < free_ent ? tab[code].first : e.first;
    if (++free_ent > maxcode) {
      if (++nbits > 12) nbits = 12;
      maxcode = old_style ? (1 << nbits) - 1 : (1 << nbits) - 2;
    }
    old = code;
    if (code >= 256) {
      if (code >= kTableSize || tab[code].length == 0) return -1;
      stack.clear();
      for (int c = code; c >= 0; c = tab[c].prev) stack.push_back(tab[c].value);
      for (auto it = stack.rbegin(); it != stack.rend() && out < need; ++it)
        dst[out++] = *it;
    } else {
      dst[out++] = uint8_t(code);
    }
  }
  return out;
}

// Returns `need`, or -2 where the data ends first (libtiff's "Not enough
// data for scanline"); a run past `need` is cut.
int64_t tiff_packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                             int64_t need) {
  int64_t i = 0, out = 0;
  while (i < n && out < need) {
    int c = src[i++];
    if (c >= 128) c -= 256;
    if (c < 0) {
      if (c == -128) continue;
      int64_t run = -c + 1;
      if (run > need - out) run = need - out;
      if (i >= n) break;
      const uint8_t v = src[i++];
      std::memset(dst + out, v, size_t(run));
      out += run;
    } else {
      int64_t len = c + 1;
      if (len > need - out) len = need - out;
      if (n - i < len) break;
      std::memcpy(dst + out, src + i, size_t(len));
      out += len;
      i += len;
    }
  }
  return out < need ? -2 : out;
}

// Undoes the predictor in place over `rows` rows of `cols` pixels of `spp`
// samples of `bytes` bytes each. Predictor 2 accumulates each sample
// along its row in the file's byte order (`big_endian`) modulo its width;
// predictor 3 accumulates bytes `spp` apart along the row, then gathers
// each value's bytes from the row's byte planes (most significant first)
// and writes it in the file's byte order.
void tiff_undo_predictor(uint8_t* buf, int64_t rows, int64_t cols,
                         int64_t spp, int64_t bytes, int predictor,
                         int big_endian) {
  const int64_t rowbytes = cols * spp * bytes;
  std::vector<uint8_t> tmp(static_cast<size_t>(rowbytes));
  for (int64_t y = 0; y < rows; ++y) {
    uint8_t* row = buf + y * rowbytes;
    if (predictor == 2) {
      const int64_t n = cols * spp;
      for (int64_t i = spp; i < n; ++i) {
        if (bytes == 1) {
          row[i] = uint8_t(row[i] + row[i - spp]);
        } else if (bytes == 2) {
          uint8_t* p = row + 2 * i;
          const uint8_t* q = row + 2 * (i - spp);
          const uint16_t a = big_endian ? uint16_t(p[0] << 8 | p[1])
                                        : uint16_t(p[1] << 8 | p[0]);
          const uint16_t b = big_endian ? uint16_t(q[0] << 8 | q[1])
                                        : uint16_t(q[1] << 8 | q[0]);
          const uint16_t s = uint16_t(a + b);
          if (big_endian) { p[0] = uint8_t(s >> 8); p[1] = uint8_t(s); }
          else { p[1] = uint8_t(s >> 8); p[0] = uint8_t(s); }
        } else {
          uint8_t* p = row + 4 * i;
          const uint8_t* q = row + 4 * (i - spp);
          uint32_t a = 0, b = 0;
          for (int k = 0; k < 4; ++k) {
            const int s = big_endian ? 8 * (3 - k) : 8 * k;
            a |= uint32_t(p[k]) << s;
            b |= uint32_t(q[k]) << s;
          }
          const uint32_t s32 = a + b;
          for (int k = 0; k < 4; ++k)
            p[k] = uint8_t(s32 >> (big_endian ? 8 * (3 - k) : 8 * k));
        }
      }
    } else {
      for (int64_t i = spp; i < rowbytes; ++i)
        row[i] = uint8_t(row[i] + row[i - spp]);
      const int64_t wc = cols * spp;
      std::memcpy(tmp.data(), row, size_t(rowbytes));
      for (int64_t c = 0; c < wc; ++c)
        for (int64_t k = 0; k < bytes; ++k) {
          const uint8_t v = tmp[size_t(k * wc + c)];  // plane k: MSB first
          row[c * bytes + (big_endian ? k : bytes - 1 - k)] = v;
        }
    }
  }
}

}  // extern "C"
