// Lossless WebP (VP8L) decoding on the host, with libwebp 1.x's rules
// (vp8l_dec.c, huffman_utils.c, lossless.c), bound with ctypes by
// io/webp.py, which parses the RIFF container around the bitstream:
//
// webp_vp8l_decode: the 5-byte header, the transforms in their stored order
// (predictor, cross-colour, subtract-green, colour indexing; each at most
// once), then the ARGB image: the colour cache, the meta prefix codes of
// an entropy image (the main image only), five prefix codes a group (each
// a simple code of one or two symbols, or a normal code read through the
// code-length code; libwebp's BuildHuffmanTable refuses all-zero,
// over-subscribed and incomplete lengths, one used length being a 0-bit
// code), and the pixels: literals, LZ77 backward references (lengths and
// distances by prefix symbol and extra bits, the first 120 distances
// through the plane-code map) and colour cache hits (hash 0x1e35a7bd).
// Subimages (transform data, the entropy image) are coded the same way
// without transforms or meta codes. The inverse transforms run in reverse
// order of reading. Bits are read LSB first; libwebp's reader reaches its
// end once more bits were read than max(64, 8 n) (its first 8 bytes are a
// window), and decoding then fails. Returns 0; a negative code where
// libwebp fails. io/webp.py keeps a Python version (``vp8l_plain``).
//
// webp_alph_decode: a lossy image's ALPH chunk as alpha_dec.c reads it: the
// header byte (compression 0 or 1, filter 0-3, pre-processing 0 or 1,
// reserved bits 0), then the raw plane (at least width x height bytes) or
// a VP8L stream of the frame's size without the 5-byte header, whose green
// channel is the plane; then the horizontal, vertical or gradient unfilter.
// libwebp decodes a stream whose one transform is colour indexing, with no
// colour cache and one-symbol red, blue and alpha codes, by DecodeAlphaData,
// which fails on reading past the end only where pixels are left (the
// pixels it then reads are its own garbage, which no reader returns: here
// they are read as zeros).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2,  3,  4,  5,  16, 6,
                                  7,  8,  9, 10, 11, 12, 13, 14, 15};
const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

struct Bits {
  const uint8_t* data;
  int64_t n;
  int64_t pos = 0;    // bits read
  int64_t avail;      // max(64, 8 n)

  // the 32 bits from bit i on (zeros past the data)
  uint32_t peek(int64_t i) const {
    const int64_t p = i >> 3;
    uint64_t w = 0;
    if (p + 8 <= n) {
      std::memcpy(&w, data + p, 8);  // little-endian hosts
    } else {
      for (int64_t k = 0; k < 8 && p + k < n; ++k)
        w |= (uint64_t)data[p + k] << (8 * k);
    }
    return (uint32_t)(w >> (i & 7));
  }
  uint32_t read(int k) {  // k <= 24
    const uint32_t v = k ? peek(pos) & ((1u << k) - 1) : 0;
    pos += k;
    return v;
  }
  bool eos() const { return pos > avail; }
};

// A canonical prefix code: symbols by (length, code), bits read MSB of the
// code first; `single` >= 0 is a code of one symbol and no bits.
struct Code {
  int single = -1;
  int count[16] = {0};
  int first_code[16] = {0};
  int first_index[16] = {0};
  std::vector<int> sorted;

  bool build(const std::vector<int>& lengths) {
    for (int& c : count) c = 0;
    int used = 0, last = -1;
    for (size_t s = 0; s < lengths.size(); ++s) {
      ++count[lengths[s]];
      if (lengths[s]) {
        ++used;
        last = (int)s;
      }
    }
    if (used == 0) return false;
    if (used == 1) {
      single = last;
      return true;
    }
    int left = 1;
    for (int l = 1; l < 16; ++l) {
      left = 2 * left - count[l];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    sorted.clear();
    int code = 0, index = 0;
    for (int l = 1; l < 16; ++l) {
      first_code[l] = code;
      first_index[l] = index;
      for (size_t s = 0; s < lengths.size(); ++s)
        if (lengths[s] == l) sorted.push_back((int)s);
      code = (code + count[l]) << 1;
      index += count[l];
    }
    return true;
  }

  int read(Bits& br) const {
    if (single >= 0) return single;
    const uint32_t bits = br.peek(br.pos);
    int code = 0;
    for (int l = 1; l < 16; ++l) {
      code = code << 1 | (int)((bits >> (l - 1)) & 1);
      if (code - first_code[l] < count[l]) {
        br.pos += l;
        return sorted[first_index[l] + code - first_code[l]];
      }
    }
    br.pos += 15;
    return 0;  // not reached: the code is complete
  }
};

// ReadHuffmanCode; false where libwebp fails
bool read_code(Bits& br, int alphabet, Code& out) {
  std::vector<int> lengths(alphabet, 0);
  if (br.read(1)) {  // a simple code
    const int num = br.read(1) + 1;
    const int s0 = br.read(br.read(1) ? 8 : 1);
    if (s0 < alphabet) lengths[s0] = 1;
    if (num == 2) {
      const int s1 = br.read(8);
      if (s1 < alphabet) lengths[s1] = 1;
    }
  } else {
    std::vector<int> cl(19, 0);
    const int num = br.read(4) + 4;
    for (int i = 0; i < num; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
    Code cl_code;
    if (!cl_code.build(cl)) return false;
    int max_symbol = alphabet;
    if (br.read(1)) {
      const int nbits = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(nbits);
      if (max_symbol > alphabet) return false;
    }
    int symbol = 0, prev = 8;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      const int n = cl_code.read(br);
      if (n < 16) {
        lengths[symbol++] = n;
        if (n) prev = n;
      } else {
        const int extra = n == 16 ? 2 : n == 17 ? 3 : 7;
        const int offset = n == 18 ? 11 : 3;
        const int repeat = br.read(extra) + offset;
        if (symbol + repeat > alphabet) return false;
        for (int i = 0; i < repeat; ++i)
          lengths[symbol++] = n == 16 ? prev : 0;
      }
    }
  }
  if (br.eos()) return false;
  return out.build(lengths);
}

inline int subsample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

inline int copy_value(int symbol, Bits& br) {  // GetCopyDistance/Length
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra;
  return offset + (int)br.read(extra) + 1;
}

inline int plane_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  const int dist_code = kCodeToPlane[code - 1];
  const int dist = (dist_code >> 4) * xsize + 8 - (dist_code & 0xf);
  return dist >= 1 ? dist : 1;
}

struct Transform {
  int kind, xsize, bits;
  std::vector<uint32_t> data;
};

int image_stream(Bits& br, int xsize, int ysize, bool level0,
                 std::vector<Transform>& transforms,
                 std::vector<uint32_t>& out, int& coded_width,
                 bool alpha = false);

// DecodeImageData; ``lenient``: DecodeAlphaData's end of stream
int image_data(Bits& br, int width, int height, std::vector<Code>& codes,
               const std::vector<uint32_t>* meta, int meta_bits,
               int cache_bits, std::vector<uint32_t>& out,
               bool lenient = false) {
  const int64_t total = (int64_t)width * height;
  out.assign(total, 0);
  std::vector<uint32_t> cache(cache_bits ? (size_t)1 << cache_bits : 0, 0);
  const int shift = 32 - cache_bits;
  const int mw = meta ? subsample(width, meta_bits) : 0;
  int64_t i = 0, cached = 0;
  auto insert = [&]() {
    if (cache_bits)
      for (; cached < i; ++cached)
        cache[(uint32_t)(out[cached] * 0x1e35a7bdu) >> shift] = out[cached];
  };
  while (i < total) {
    const int y = (int)(i / width), x = (int)(i % width);
    const int group =
        meta ? (int)(*meta)[(int64_t)(y >> meta_bits) * mw + (x >> meta_bits)]
             : 0;
    Code* g = &codes[5 * (size_t)group];
    const int code = g[0].read(br);
    if (br.eos() && !lenient) break;
    if (code < 256) {
      const int red = g[1].read(br);
      const int blue = g[2].read(br);
      const int alpha = g[3].read(br);
      if (br.eos() && !lenient) break;
      out[i++] = (uint32_t)alpha << 24 | (uint32_t)red << 16 |
                 (uint32_t)code << 8 | (uint32_t)blue;
    } else if (code < 280) {
      const int length = copy_value(code - 256, br);
      const int dist = plane_distance(width, copy_value(g[4].read(br), br));
      if (br.eos() && !lenient) break;
      if (i < dist || total - i < length) return -3;
      for (int64_t k = i; k < i + length; ++k) out[k] = out[k - dist];
      i += length;
    } else {
      insert();
      out[i] = cache[code - 280];
      ++i;
    }
    insert();
    if (lenient && br.eos()) break;
  }
  if (br.eos() && (!lenient || i < total)) return -4;
  return 0;
}

int image_stream(Bits& br, int xsize, int ysize, bool level0,
                 std::vector<Transform>& transforms,
                 std::vector<uint32_t>& out, int& coded_width, bool alpha) {
  if (level0) {
    int seen = 0;
    while (br.read(1)) {
      const int kind = br.read(2);
      if (seen & (1 << kind)) return -5;
      seen |= 1 << kind;
      Transform t{kind, xsize, 0, {}};
      int w;
      if (kind == 0 || kind == 1) {
        t.bits = br.read(3) + 2;
        std::vector<Transform> none;
        const int rc = image_stream(br, subsample(xsize, t.bits),
                                    subsample(ysize, t.bits), false, none,
                                    t.data, w);
        if (rc) return rc;
      } else if (kind == 3) {
        const int colors = br.read(8) + 1;
        t.bits = colors > 16 ? 0 : colors > 4 ? 1 : colors > 2 ? 2 : 3;
        std::vector<Transform> none;
        const int rc = image_stream(br, colors, 1, false, none, t.data, w);
        if (rc) return rc;
        xsize = subsample(xsize, t.bits);
      }
      transforms.push_back(std::move(t));
    }
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = br.read(4);
    if (cache_bits < 1 || cache_bits > 11) return -6;
  }
  std::vector<uint32_t> meta;
  int meta_bits = 0, groups = 1;
  if (level0 && br.read(1)) {
    meta_bits = br.read(3) + 2;
    std::vector<Transform> none;
    int w;
    const int rc = image_stream(br, subsample(xsize, meta_bits),
                                subsample(ysize, meta_bits), false, none,
                                meta, w);
    if (rc) return rc;
    for (uint32_t& m : meta) {
      m = (m >> 8) & 0xffff;
      if ((int)m + 1 > groups) groups = (int)m + 1;
    }
  }
  std::vector<Code> codes(5 * (size_t)groups);
  for (int gi = 0; gi < groups; ++gi)
    for (int j = 0; j < 5; ++j) {
      const int alphabet =
          kAlphabet[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
      if (!read_code(br, alphabet, codes[5 * (size_t)gi + j])) return -2;
    }
  coded_width = xsize;
  // VP8LDecodeAlphaHeader's Is8bOptimizable case
  bool lenient = alpha && transforms.size() == 1 && transforms[0].kind == 3 &&
                 cache_bits == 0;
  for (int gi = 0; lenient && gi < groups; ++gi)
    for (int j = 1; j < 4; ++j)
      if (codes[5 * (size_t)gi + j].single < 0) lenient = false;
  return image_data(br, xsize, ysize, codes,
                    level0 && !meta.empty() ? &meta : nullptr, meta_bits,
                    cache_bits, out, lenient);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}

inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

inline int ch(uint32_t p, int s) { return (int)((p >> s) & 0xff); }

uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TR, uint32_t TL) {
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: {  // Select(top, left, top-left)
      int d = 0;
      for (int s = 0; s < 32; s += 8)
        d += std::abs(ch(L, s) - ch(TL, s)) - std::abs(ch(T, s) - ch(TL, s));
      return d <= 0 ? T : L;
    }
    case 12: {
      uint32_t r = 0;
      for (int s = 0; s < 32; s += 8)
        r |= (uint32_t)clip255(ch(L, s) + ch(T, s) - ch(TL, s)) << s;
      return r;
    }
    case 13: {
      const uint32_t ave = average2(L, T);
      uint32_t r = 0;
      for (int s = 0; s < 32; s += 8) {
        const int a = ch(ave, s);
        r |= (uint32_t)clip255(a + (a - ch(TL, s)) / 2) << s;
      }
      return r;
    }
    default: return 0xff000000u;  // mode 0, and 14-15 as libwebp
  }
}

inline int delta(int pred, int color) {  // ColorTransformDelta
  return ((int)(int8_t)pred * (int)(int8_t)color) >> 5;
}

void inverse(const Transform& t, int height, std::vector<uint32_t>& px) {
  const int width = t.xsize;
  if (t.kind == 0) {
    const int tiles = subsample(width, t.bits);
    for (int y = 0; y < height; ++y)
      for (int x = 0; x < width; ++x) {
        const int64_t i = (int64_t)y * width + x;
        uint32_t pred;
        if (y == 0) {
          pred = x == 0 ? 0xff000000u : px[i - 1];
        } else if (x == 0) {
          pred = px[i - width];
        } else {
          const int mode =
              (t.data[(int64_t)(y >> t.bits) * tiles + (x >> t.bits)] >> 8) &
              0xf;
          pred = predict(mode, px[i - 1], px[i - width], px[i - width + 1],
                         px[i - width - 1]);
        }
        px[i] = add_pixels(px[i], pred);
      }
  } else if (t.kind == 1) {
    const int tiles = subsample(width, t.bits);
    for (int y = 0; y < height; ++y)
      for (int x = 0; x < width; ++x) {
        uint32_t& p = px[(int64_t)y * width + x];
        const uint32_t m =
            t.data[(int64_t)(y >> t.bits) * tiles + (x >> t.bits)];
        const int green = ch(p, 8);
        const int red = (ch(p, 16) + delta(m & 0xff, green)) & 0xff;
        const int blue = (ch(p, 0) + delta((m >> 8) & 0xff, green) +
                          delta((m >> 16) & 0xff, red)) & 0xff;
        p = (p & 0xff00ff00u) | (uint32_t)red << 16 | (uint32_t)blue;
      }
  } else if (t.kind == 2) {
    for (uint32_t& p : px) {
      const uint32_t g = (p >> 8) & 0xff;
      p = (p & 0xff00ff00u) | (((p >> 16) + g) & 0xff) << 16 |
          ((p + g) & 0xff);
    }
  } else {
    std::vector<uint32_t> table(t.bits ? (size_t)1 << (8 >> t.bits) : 256, 0);
    uint32_t prev = 0;
    for (size_t k = 0; k < t.data.size(); ++k) {
      prev = k ? add_pixels(prev, t.data[k]) : t.data[k];
      table[k] = prev;
    }
    const int packed = subsample(width, t.bits);
    const int per = 1 << t.bits, nbits = 8 >> t.bits;
    std::vector<uint32_t> out((size_t)width * height);
    for (int y = 0; y < height; ++y)
      for (int x = 0; x < width; ++x) {
        const int g = ch(px[(int64_t)y * packed + (x >> t.bits)], 8);
        const int index =
            t.bits ? (g >> (nbits * (x & (per - 1)))) & ((1 << nbits) - 1) : g;
        out[(int64_t)y * width + x] = table[index];
      }
    px.swap(out);
  }
}

// the unfilters of a row (filters_utils / dsp/filters.c); prev is the row
// above, null for the first
void unfilter(int filter, const uint8_t* prev, uint8_t* row, int width) {
  if (filter == 0) return;
  if (filter == 1 || prev == nullptr) {
    uint8_t pred = (filter == 1 && prev != nullptr) ? prev[0] : 0;
    for (int i = 0; i < width; ++i) pred = row[i] = (uint8_t)(pred + row[i]);
  } else if (filter == 2) {
    for (int i = 0; i < width; ++i) row[i] = (uint8_t)(prev[i] + row[i]);
  } else {
    int top_left = prev[0], left = prev[0];
    for (int i = 0; i < width; ++i) {
      const int top = prev[i];
      left = (uint8_t)(row[i] + clip255(left + top - top_left));
      top_left = top;
      row[i] = (uint8_t)left;
    }
  }
}

}  // namespace

extern "C" {

int webp_vp8l_decode(const uint8_t* data, int64_t n, uint32_t* out,
                     int width, int height) {
  if (n < 5 || data[0] != 0x2f) return -1;
  Bits br{data, n, 40, 8 * n > 64 ? 8 * n : 64};
  std::vector<Transform> transforms;
  std::vector<uint32_t> px;
  int coded;
  const int rc = image_stream(br, width, height, true, transforms, px, coded);
  if (rc) return rc;
  for (size_t k = transforms.size(); k-- > 0;)
    inverse(transforms[k], height, px);
  std::memcpy(out, px.data(), sizeof(uint32_t) * (size_t)width * height);
  return 0;
}

int webp_alph_decode(const uint8_t* data, int64_t n, uint8_t* out, int width,
                     int height) {
  if (n <= 1) return -1;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
  const int pre = (data[0] >> 4) & 3;
  if (method > 1 || pre > 1 || (data[0] >> 6)) return -1;
  const int64_t size = (int64_t)width * height;
  if (method == 0) {
    if (n - 1 < size) return -1;
    std::memcpy(out, data + 1, (size_t)size);
  } else {
    Bits br{data + 1, n - 1, 0, 8 * (n - 1) > 64 ? 8 * (n - 1) : 64};
    std::vector<Transform> transforms;
    std::vector<uint32_t> px;
    int coded;
    const int rc = image_stream(br, width, height, true, transforms, px,
                                coded, true);
    if (rc) return rc;
    for (size_t k = transforms.size(); k-- > 0;)
      inverse(transforms[k], height, px);
    for (int64_t i = 0; i < size; ++i) out[i] = (uint8_t)(px[i] >> 8);
  }
  for (int y = 0; y < height; ++y)
    unfilter(filter, y ? out + (int64_t)(y - 1) * width : nullptr,
             out + (int64_t)y * width, width);
  return 0;
}

}  // extern "C"
