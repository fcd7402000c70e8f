// CCITT fax decoding on the host, as libtiff 4.7's tif_fax3.c decodes a
// strip or tile for cv2.imread and PIL: modified Huffman runs (TIFF
// compression 2, byte-aligned rows, and 32771, word-aligned), T.4 1-D and
// 2-D (3, each row after an EOL, a tag bit choosing 1-D or 2-D) and T.6
// (4). The code tables come from the caller (io/tiff_fax.py builds them as
// mkg3states.c does): each entry, indexed by the next 7, 12 or 13 bits of
// the stream, first bit lowest, holds (state, width, run). The state
// machine is libtiff's: its bit accumulator, zero bits padded at the end
// of the data, its recovery from a bad code (the row ended at the code,
// then evened out to the row's width) and from a premature end (the strip
// fails, but for T.6, which keeps the rows before it). Bound with ctypes
// by io/tiff_fax.py, which holds a plain Python version beside it.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum State {
  kNull = 0, kPass, kHoriz, kV0, kVR, kVL, kExt, kTermW, kTermB, kMakeUpW,
  kMakeUpB, kMakeUp, kEol
};

struct Entry {
  int32_t state, width, param;
};

// the bit reader and the run arrays of one strip, tif_fax3.h's macros
struct Decoder {
  const uint8_t* cp;
  const uint8_t* ep;
  uint32_t acc = 0;
  int avail = 0;
  const Entry* main_tab;
  const Entry* white;
  const Entry* black;
  std::vector<uint32_t> runs;  // 2 * nruns: the current and reference rows
  int64_t nruns;
  int32_t lastx;

  static uint8_t rev(uint8_t b) {
    b = uint8_t((b & 0xF0) >> 4 | (b & 0x0F) << 4);
    b = uint8_t((b & 0xCC) >> 2 | (b & 0x33) << 2);
    return uint8_t((b & 0xAA) >> 1 | (b & 0x55) << 1);
  }
  // NeedBits8 / NeedBits16: false where the data ended with no bit left
  bool need8(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= uint32_t(rev(*cp++)) << avail;
        avail += 8;
      }
    }
    return true;
  }
  bool need16(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= uint32_t(rev(*cp++)) << avail;
        if ((avail += 8) < n) {
          if (cp >= ep) {
            avail = n;
          } else {
            acc |= uint32_t(rev(*cp++)) << avail;
            avail += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t get(int n) const { return acc & ((1u << n) - 1); }
  void clr(int n) {
    avail -= n;
    acc >>= n;
  }
};

// the outcome of a row's expansion
enum Outcome { kDone, kEof, kOverflow };

// libtiff's int arithmetic on the runs, which it keeps as uint32
inline int32_t wrap(int64_t v) { return int32_t(uint32_t(uint64_t(v))); }

struct Row {
  Decoder& d;
  int64_t thisrun;     // index of the row's first run
  int64_t pa;          // next run to write
  int32_t a0 = 0;
  int32_t run_length = 0;
  int64_t pb = 0;      // next reference run
  int32_t b1 = 0;
  int eol = 0;         // EOLcnt

  bool setvalue(int32_t x) {
    if (pa >= thisrun + d.nruns) return false;
    d.runs[size_t(pa++)] = uint32_t(wrap(int64_t(run_length) + x));
    a0 = wrap(int64_t(a0) + x);
    run_length = 0;
    return true;
  }
  bool cleanup() {
    if (run_length && !setvalue(0)) return false;
    if (a0 != d.lastx) {
      while (a0 > d.lastx && pa > thisrun)
        a0 = wrap(int64_t(uint32_t(a0)) - d.runs[size_t(--pa)]);
      if (a0 < d.lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - thisrun) & 1)
          if (!setvalue(0)) return false;
        if (!setvalue(wrap(int64_t(d.lastx) - a0))) return false;
      } else if (a0 > d.lastx) {
        if (!setvalue(d.lastx)) return false;
        if (!setvalue(0)) return false;
      }
    }
    return true;
  }
  uint32_t ref(int64_t i) const {
    return i >= 0 && i < int64_t(d.runs.size()) ? d.runs[size_t(i)] : 0;
  }
  bool check_b1(int64_t refbase) {
    if (pa != thisrun)
      while (b1 <= a0 && b1 < d.lastx) {
        if (pb + 1 >= refbase + d.nruns) return false;
        b1 = wrap(int64_t(uint32_t(b1)) + uint32_t(ref(pb) + ref(pb + 1)));
        pb += 2;
      }
    return true;
  }
  // one colour's run of make-up codes and its terminating code; 1 done,
  // 0 a bad code, -1 the data ended, -2 overflow
  int colour_run(bool is_black, bool one_d) {
    const Entry* tab = is_black ? d.black : d.white;
    const int wid = is_black ? 13 : 12;
    for (;;) {
      if (!d.need16(wid)) return -1;
      const Entry& e = tab[d.get(wid)];
      d.clr(e.width);
      if (e.state == (is_black ? kTermB : kTermW)) {
        return setvalue(e.param) ? 1 : -2;
      } else if (e.state == (is_black ? kMakeUpB : kMakeUpW) ||
                 e.state == kMakeUp) {
        a0 = wrap(int64_t(a0) + e.param);
        run_length = wrap(int64_t(run_length) + e.param);
      } else if (one_d && e.state == kEol) {
        eol = 1;
        return 0;
      } else {
        return 0;
      }
    }
  }
  // EXPAND1D
  Outcome expand1d() {
    for (;;) {
      int r = colour_run(false, true);
      if (r == -2) return kOverflow;
      if (r == -1) return cleanup() ? kEof : kOverflow;
      if (r == 0) break;
      if (a0 >= d.lastx) break;
      r = colour_run(true, true);
      if (r == -2) return kOverflow;
      if (r == -1) return cleanup() ? kEof : kOverflow;
      if (r == 0) break;
      if (a0 >= d.lastx) break;
      if (pa - thisrun >= 2 && d.runs[size_t(pa - 1)] == 0 &&
          d.runs[size_t(pa - 2)] == 0)
        pa -= 2;
    }
    return cleanup() ? kDone : kOverflow;
  }
  // EXPAND2D, the reference row at `refbase`
  Outcome expand2d(int64_t refbase) {
    auto eof = [&]() { return cleanup() ? kEof : kOverflow; };
    while (a0 < d.lastx) {
      if (pa >= thisrun + d.nruns) return kOverflow;
      if (!d.need8(7)) return eof();
      const Entry& e = d.main_tab[d.get(7)];
      d.clr(e.width);
      switch (e.state) {
        case kPass:
          if (!check_b1(refbase)) return kOverflow;
          b1 = wrap(int64_t(uint32_t(b1)) + ref(pb++));
          run_length = wrap(int64_t(run_length) + b1 - a0);
          a0 = b1;
          b1 = wrap(int64_t(uint32_t(b1)) + ref(pb++));
          break;
        case kHoriz: {
          const bool black_first = (pa - thisrun) & 1;
          int r = colour_run(black_first, false);
          if (r == -2) return kOverflow;
          if (r == -1) return eof();
          if (r == 0) return cleanup() ? kDone : kOverflow;
          r = colour_run(!black_first, false);
          if (r == -2) return kOverflow;
          if (r == -1) return eof();
          if (r == 0) return cleanup() ? kDone : kOverflow;
          if (!check_b1(refbase)) return kOverflow;
          break;
        }
        case kV0:
          if (!check_b1(refbase)) return kOverflow;
          if (!setvalue(wrap(int64_t(b1) - a0))) return kOverflow;
          b1 = wrap(int64_t(uint32_t(b1)) + ref(pb++));
          break;
        case kVR:
          if (!check_b1(refbase)) return kOverflow;
          if (!setvalue(wrap(int64_t(b1) - a0 + e.param))) return kOverflow;
          b1 = wrap(int64_t(uint32_t(b1)) + ref(pb++));
          break;
        case kVL:
          if (!check_b1(refbase)) return kOverflow;
          if (b1 < wrap(int64_t(a0) + e.param))
            return cleanup() ? kDone : kOverflow;
          if (!setvalue(wrap(int64_t(b1) - a0 - e.param))) return kOverflow;
          b1 = wrap(int64_t(uint32_t(b1)) - ref(--pb));
          break;
        case kExt:
          d.runs[size_t(pa++)] = uint32_t(wrap(int64_t(d.lastx) - a0));
          return cleanup() ? kDone : kOverflow;
        case kEol:
          d.runs[size_t(pa++)] = uint32_t(wrap(int64_t(d.lastx) - a0));
          if (!d.need8(4)) return eof();
          d.clr(4);
          eol = 1;
          return cleanup() ? kDone : kOverflow;
        default:
          return cleanup() ? kDone : kOverflow;
      }
    }
    if (run_length) {
      if (wrap(int64_t(run_length) + a0) < d.lastx) {
        if (!d.need8(1)) return eof();
        if (!d.get(1)) return cleanup() ? kDone : kOverflow;
        d.clr(1);
      }
      if (!setvalue(0)) return kOverflow;
    }
    return cleanup() ? kDone : kOverflow;
  }
};

// _TIFFFax3fillruns: white runs clear, black runs set (MSB first); the
// runs are clamped to the row in place, as the reference row keeps them
void fill(uint8_t* row, std::vector<uint32_t>& runs, int64_t start,
          int64_t end, uint32_t lastx) {
  if ((end - start) & 1) runs[size_t(end++)] = 0;
  uint32_t x = 0;
  for (int64_t i = start; i < end; i += 2) {
    for (int k = 0; k < 2; ++k) {
      uint32_t run = runs[size_t(i + k)];
      if (uint32_t(x + run) > lastx || run > lastx)
        run = runs[size_t(i + k)] = lastx - x;
      for (uint32_t p = x; p < x + run; ++p) {
        if (k) row[p >> 3] |= uint8_t(0x80 >> (p & 7));
        else row[p >> 3] &= uint8_t(~(0x80 >> (p & 7)));
      }
      x += run;
    }
  }
}

// SYNC_EOL: false where the data ends first
bool sync_eol(Decoder& d, int& eol) {
  if (eol == 0) {
    for (;;) {
      if (!d.need16(11)) return false;
      if (d.get(11) == 0) break;
      d.clr(1);
    }
  }
  for (;;) {
    if (!d.need8(8)) return false;
    if (d.get(8)) break;
    d.clr(8);
  }
  while (d.get(1) == 0) d.clr(1);
  d.clr(1);
  eol = 0;
  return true;
}

}  // namespace

extern "C" {

// Decodes `rows` rows of `width` pixels into dst (rows * ceil(width / 8)
// bytes, zeroed by the caller) from the stream `src` (first bit the most
// significant of each byte). `mode`: 2 modified Huffman runs, byte-aligned;
// 32771 the same, word-aligned; 3 T.4 1-D; 103 T.4 with 2-D rows; 4 T.6.
// `tables`: 128 + 4096 + 8192 entries of (state, width, run). Returns
// the rows written (all of them on success; for T.6, the rows up to the
// one where the data ended), or -1 where libtiff fails the strip.
int64_t tiff_fax_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t rows, int64_t width, int mode,
                        const int32_t* tables) {
  Decoder d;
  d.cp = src;
  d.ep = src + n;
  d.main_tab = reinterpret_cast<const Entry*>(tables);
  d.white = d.main_tab + 128;
  d.black = d.white + 4096;
  d.lastx = int32_t(width);
  const bool two_d = mode == 103 || mode == 4;
  d.nruns = ((width + 1 + 31) / 32) * 32;
  if (two_d) d.nruns *= 2;
  d.runs.assign(size_t(2 * d.nruns), 0);
  int64_t cur = 0, refr = d.nruns;
  if (two_d) {
    d.runs[size_t(refr)] = uint32_t(width);
    d.runs[size_t(refr + 1)] = 0;
  }
  const int64_t rowbytes = (width + 7) / 8;
  int eol = 0;
  for (int64_t line = 0; line < rows; ++line) {
    uint8_t* row = dst + line * rowbytes;
    Row r{d, cur, cur};
    r.eol = eol;
    Outcome out;
    if (mode == 2 || mode == 32771) {
      out = r.expand1d();
      if (out == kDone) {
        fill(row, d.runs, r.thisrun, r.pa, uint32_t(width));
        if (mode == 2) {
          d.clr(d.avail & 7);
        } else {
          // libtiff's word alignment: the accumulator's bits past a
          // 16-bit count, then a byte where the data pointer is odd
          d.clr(d.avail & 15);
          if (d.avail == 0 && ((d.cp - src) & 1)) ++d.cp;
        }
      }
    } else if (mode == 3) {
      if (!sync_eol(d, r.eol)) return -1;
      out = r.expand1d();
      if (out == kDone) fill(row, d.runs, r.thisrun, r.pa, uint32_t(width));
    } else if (mode == 103) {
      if (!sync_eol(d, r.eol)) return -1;
      if (!d.need8(1)) return -1;
      const bool is1d = d.get(1);
      d.clr(1);
      r.pb = refr;
      r.b1 = d.runs[size_t(r.pb++)];
      out = is1d ? r.expand1d() : r.expand2d(refr);
      if (out == kDone) {
        fill(row, d.runs, r.thisrun, r.pa, uint32_t(width));
        if (r.pa < r.thisrun + d.nruns && !r.setvalue(0)) return -1;
        std::swap(cur, refr);
      }
    } else {
      r.pb = refr;
      r.b1 = d.runs[size_t(r.pb++)];
      out = r.expand2d(refr);
      if (out == kOverflow) return -1;
      if (out == kEof || r.eol) {
        // EOFG4: the row as far as it went, and no more rows
        if (d.need16(13)) d.clr(13);
        fill(row, d.runs, r.thisrun, r.pa, uint32_t(width));
        return line ? line + 1 : -1;
      }
      fill(row, d.runs, r.thisrun, r.pa, uint32_t(width));
      if (!r.setvalue(0)) return -1;
      std::swap(cur, refr);
    }
    if (out != kDone) return -1;
    eol = r.eol;
  }
  return rows;
}

}  // extern "C"
