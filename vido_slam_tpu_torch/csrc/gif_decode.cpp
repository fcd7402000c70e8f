// GIF LZW decoding on the host, bound with ctypes by io/gif.py, which
// parses the blocks around it: the data sub-blocks of one image from
// data[pos], codes LSB first from min_code_size + 1 to 12 bits, the
// colour indices written to out (the first npix of them: the image's rows
// in the order the file stores them). The two readers the port copies stop
// differently, so `pil` picks the rules:
//
// - cv2 (OpenCV 5.0's grfmt_gif.cpp lzwDecode, pil = 0): a byte is read at
//   a time from the sub-blocks up to the block terminator and every code
//   its bits complete is decoded; the end code resets the table as a clear
//   code does and ends the byte's codes (the next bytes, if any, go on);
//   decoding fails where a byte is to be read once more than npix indices
//   were written, or where a string starting before index npix ends past
//   it. Returns the number of indices decoded (the caller fails on fewer
//   than npix).
// - PIL (GifDecode.c, pil = 1): a zero-length sub-block is skipped and
//   the next byte read as a block length (there is no terminator), a
//   block is only started when all of it is in the file; decoding stops
//   as soon as npix indices are written. Returns npix; -3 where the data
//   ends first (PIL: "image file is truncated"), -4 at an end code before
//   the image is full (PIL then waits for data that never comes: also
//   truncated).
//
// Both fail (-1) on a code past the table (a code after a clear other than
// a colour index, or one above the next free entry); a code equal to the
// next free entry is the string of the previous code and its first index.
// The table holds 4096 entries and stays full without a clear (the
// deferred clear). io/gif.py keeps a Python version of the same
// (``lzw_decode_plain``).

#include <cstdint>

namespace {

struct Table {
  uint16_t prefix[4096];
  uint8_t suffix[4096];
  uint8_t first[4096];
  uint16_t length[4096];
};

}  // namespace

extern "C" {

int64_t gif_lzw_decode(const uint8_t* data, int64_t n, int64_t pos,
                       int min_code_size, int pil, uint8_t* out,
                       int64_t npix) {
  static thread_local Table t;
  const int clear = 1 << min_code_size, end = clear + 1;
  for (int i = 0; i < clear && i < 4096; ++i) {
    t.prefix[i] = 0;
    t.suffix[i] = t.first[i] = (uint8_t)i;
    t.length[i] = 1;
  }
  int next = clear + 2, width = min_code_size + 1, prev = -1;
  uint32_t acc = 0;
  int nacc = 0;
  int64_t count = 0;
  uint8_t stack[4097];
  if (pos >= n) return pil ? -3 : 0;
  int64_t block = pil ? 0 : data[pos++];  // bytes left in the sub-block
  for (;;) {
    if (pil) {
      while (nacc < width) {  // PIL: whole blocks, no terminator
        while (block == 0) {
          if (pos >= n) return -3;
          block = data[pos++];
          if (pos + block > n) return -3;
        }
        acc |= (uint32_t)data[pos++] << nacc;
        nacc += 8;
        --block;
      }
    } else {
      if (block == 0) return count;  // the block terminator
      if (count > npix) return -2;
      if (nacc < width) {  // one byte, then the codes it completes
        if (pos >= n) return count;
        acc |= (uint32_t)data[pos++] << nacc;
        nacc += 8;
        --block;
      }
    }
    while (nacc >= width) {
      const int c = (int)(acc & ((1u << width) - 1));
      acc >>= width;
      nacc -= width;
      if (c == clear || c == end) {
        next = clear + 2;
        width = min_code_size + 1;
        prev = -1;
        if (c == clear) continue;
        if (pil) return -4;
        break;
      }
      int code = c;
      bool kwk = false;
      if ((prev < 0 && c > clear) || (prev >= 0 && (c > next || c >= 4096))) {
        // a code past the table: cv2 takes it only once the image is full
        // (and then it changes nothing)
        if (pil || count < npix) return -1;
        continue;
      }
      if (c == next) {
        kwk = true;
        code = prev;
      }
      int len = t.length[code];
      int k = len;
      for (int x = code; k > 0; x = t.prefix[x]) stack[--k] = t.suffix[x];
      if (kwk) stack[len++] = t.first[prev];
      if (pil) {
        for (int i = 0; i < len && count < npix; ++i) out[count++] = stack[i];
        if (count == npix) return npix;
      } else {
        if (count < npix && count + len > npix) return -2;
        for (int i = 0; i < len; ++i, ++count)
          if (count < npix) out[count] = stack[i];
      }
      if (prev >= 0 && next < 4096) {
        t.prefix[next] = (uint16_t)prev;
        t.suffix[next] = stack[0];  // the first index of this string
        t.first[next] = t.first[prev];
        t.length[next] = (uint16_t)(t.length[prev] + 1);
        ++next;
        if (next == (1 << width) && width < 12) ++width;
      }
      prev = c;
    }
    if (!pil && block == 0) {
      if (pos >= n) return count;
      block = data[pos++];
    }
  }
}

}  // extern "C"
