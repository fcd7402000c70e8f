// The byte-stream loops of the formats PIL opens and cv2 does not, on the
// host, bound with ctypes by io/tga.py, io/pcx.py, io/sgi.py, io/qoi.py,
// io/xbm.py and io/msp.py, which parse the headers around them. Each copies
// its Pillow 12.1 decoder (TgaRleDecode.c, PcxDecode.c, SgiRleDecode.c,
// QoiImagePlugin's and MspImagePlugin's Python decoders, XbmDecode.c) as the
// Python version beside it does (``rle_plain``, ``decode_plain``,
// ``hex_plain``); the modules' docstrings give the rules. Return codes: 0
// done, -1 the data ends first (PIL: "image file is truncated" or its
// equivalent), -2 and below the decoder's own errors.

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 |
         p[3];
}

// expandrow / expandrow2 of SgiRleDecode.c: 0 at the row's end, 1 where PIL
// stops decoding, -1 on an overrun. `end` is the index of the last byte.
int sgi_expand(uint8_t* row, int64_t dest, const uint8_t* src, int64_t s,
               int64_t end, int64_t n, int z, int64_t width, int bpc) {
  int64_t x = 0;
  for (int64_t k = n; k > 0; --k) {
    if (s + bpc - 1 > end) return -1;
    const uint8_t pixel = src[s + bpc - 1];
    s += bpc;
    if (k == 1 && pixel != 0) return 1;
    const int count = pixel & 0x7F;
    if (!count) return 0;
    if (x + count > width) return -1;
    x += count;
    if (pixel & 0x80) {
      if (s + (int64_t)bpc * count > end) return -1;
      for (int i = 0; i < count; ++i) {
        std::memcpy(row + dest, src + s, bpc);
        s += bpc;
        dest += (int64_t)z * bpc;
      }
    } else {
      if (bpc == 2 ? s + 2 > end : s > end) return -1;
      for (int i = 0; i < count; ++i) {
        std::memcpy(row + dest, src + s, bpc);
        dest += (int64_t)z * bpc;
      }
      s += bpc;
    }
  }
  return 0;
}

inline int hex_digit(uint8_t c) {
  if (c >= '0' && c <= '9') return c - '0';
  if (c >= 'a' && c <= 'f') return c - 'a' + 10;
  if (c >= 'A' && c <= 'F') return c - 'A' + 10;
  return 0;
}

}  // namespace

extern "C" {

// Targa run-length packets from data[pos]: `rows` rows of `row` bytes,
// `pixel` bytes a pixel. A literal runs on across rows; a run may not
// leave its row (-2); a packet must be whole in the data (-1).
int tga_rle_decode(const uint8_t* data, int64_t n, int64_t pos, int pixel,
                   int64_t row, int64_t rows, uint8_t* out) {
  const int64_t total = row * rows;
  int64_t done = 0, x = 0;
  while (done < total) {
    if (pos >= n) return -1;
    const uint8_t head = data[pos];
    const int64_t count = (int64_t)pixel * ((head & 0x7F) + 1);
    if (head & 0x80) {
      if (n - pos < 1 + pixel) return -1;
      if (x + count > row) return -2;
      for (int64_t i = 0; i < count; i += pixel)
        std::memcpy(out + done + i, data + pos + 1, pixel);
      done += count;
      x = (x + count) % row;
      pos += 1 + pixel;
      continue;
    }
    if (n - pos < 1 + count) return -1;
    const int64_t take = count < total - done ? count : total - done;
    std::memcpy(out + done, data + pos + 1, take);
    done += take;
    x = (x + take) % row;
    pos += 1 + count;
  }
  return 0;
}

// PCX run-length bytes from data[pos]: `rows` rows of `size` bytes, each
// row's planes moved together as PcxDecode.c moves them (`planes`: the
// one-bit plane count of P;2L and P;4L, else 0). -2 where a run left its
// row (reported once the image is complete, as PIL reports it).
int pcx_rle_decode(const uint8_t* data, int64_t n, int64_t pos, int64_t size,
                   int64_t width, int planes, int64_t rows, uint8_t* out) {
  bool overrun = false;
  for (int64_t y = 0; y < rows; ++y) {
    uint8_t* row = out + y * size;
    int64_t x = 0;
    while (x < size) {
      if (pos >= n) return -1;
      const uint8_t b = data[pos];
      if ((b & 0xC0) == 0xC0) {
        if (pos + 1 >= n) return -1;
        int64_t count = b & 0x3F;
        if (x + count > size) {
          overrun = true;
          count = size - x;
        }
        std::memset(row + x, data[pos + 1], count);
        x += count;
        pos += 2;
      } else {
        row[x++] = b;
        pos += 1;
      }
    }
    int64_t xsize, bands, stride;
    if (planes == 2 || planes == 4) {
      xsize = (width + 7) / 8;
      bands = planes;
      stride = size / planes;
    } else {
      xsize = width;
      bands = size / width;
      stride = bands ? size / bands : 0;
    }
    if (stride > xsize)
      for (int64_t i = 1; i < bands; ++i)
        std::memmove(row + i * xsize, row + i * stride, xsize);
  }
  return overrun ? -2 : 0;
}

// SGI run-length rows by the start and length tables after the 512-byte
// header: (height, width * z * bpc) interleaved samples, rows in file
// order; rows PIL does not reach stay 0.
int sgi_rle_decode(const uint8_t* data, int64_t n, int64_t width,
                   int64_t height, int z, int bpc, uint8_t* out) {
  const int64_t header = 512, tablen = height * z;
  if (n < header + 8 * tablen) return -1;
  const uint8_t* src = data + header;
  const int64_t end = n - header - 1;
  const int64_t rowsize = width * z * bpc;
  uint8_t* row = out;  // the row buffer: each row starts from the last
  for (int64_t y = 0; y < height; ++y) {
    uint8_t* dst = out + y * rowsize;
    if (y > 0) std::memcpy(dst, row, rowsize);
    for (int c = 0; c < z; ++c) {
      const int64_t k = y + c * height;
      const uint32_t off = be32(data + header + 4 * k);
      const int64_t len =
          (int32_t)be32(data + header + 4 * (tablen + k));  // a C int
      if (off < header) return -2;
      const int status = sgi_expand(dst, (int64_t)c * bpc, src, off - header,
                                    end, len, z, width, bpc);
      if (status == -1) return -2;
      if (status == 1) {
        std::memset(dst, 0, rowsize);  // the row is never stored
        return 0;
      }
    }
    row = dst;
  }
  return 0;
}

// QOI ops from byte 14: npix pixels of `bands` (3 or 4) samples.
int qoi_decode(const uint8_t* data, int64_t n, int64_t npix, int bands,
               uint8_t* out) {
  uint8_t seen[64][4];
  bool set[64] = {false};
  uint8_t prev[4] = {0, 0, 0, 255};
  const int64_t need = npix * bands;
  int64_t done = 0, pos = 14;
  while (done < need) {
    if (pos >= n) return -1;
    const uint8_t b = data[pos++];
    uint8_t v[4];
    if (b == 0xFE) {
      if (pos + 3 > n) return -1;
      v[0] = data[pos]; v[1] = data[pos + 1]; v[2] = data[pos + 2];
      v[3] = prev[3];
      pos += 3;
    } else if (b == 0xFF) {
      if (pos + 4 > n) return -1;
      std::memcpy(v, data + pos, 4);
      pos += 4;
    } else if ((b >> 6) == 0) {
      if (set[b & 0x3F]) {
        std::memcpy(v, seen[b & 0x3F], 4);
      } else {
        std::memset(v, 0, 4);
      }
    } else if ((b >> 6) == 1) {
      v[0] = (uint8_t)(prev[0] + ((b >> 4) & 3) - 2);
      v[1] = (uint8_t)(prev[1] + ((b >> 2) & 3) - 2);
      v[2] = (uint8_t)(prev[2] + (b & 3) - 2);
      v[3] = prev[3];
    } else if ((b >> 6) == 2) {
      if (pos >= n) return -1;
      const uint8_t second = data[pos++];
      const int dg = (b & 0x3F) - 32;
      v[0] = (uint8_t)(prev[0] + dg + (second >> 4) - 8);
      v[1] = (uint8_t)(prev[1] + dg);
      v[2] = (uint8_t)(prev[2] + dg + (second & 15) - 8);
      v[3] = prev[3];
    } else {
      for (int r = (b & 0x3F) + 1; r > 0 && done < need; --r) {
        std::memcpy(out + done, prev, bands);
        done += bands;
      }
      continue;
    }
    std::memcpy(prev, v, 4);
    const int h = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
    std::memcpy(seen[h], v, 4);
    set[h] = true;
    std::memcpy(out + done, v, bands);
    done += bands;
  }
  return 0;
}

// XBM: `count` bytes, each from the two characters after an 'x' at or after
// data[pos].
int xbm_decode(const uint8_t* data, int64_t n, int64_t pos, int64_t count,
               uint8_t* out) {
  for (int64_t i = 0; i < count; ++i) {
    while (pos < n && data[pos] != 'x') ++pos;
    if (n - pos < 3) return -1;
    out[i] = (uint8_t)(hex_digit(data[pos + 1]) << 4 | hex_digit(data[pos + 2]));
    pos += 3;
  }
  return 0;
}

// MSP version 2: the row map after the 32-byte header, then its rows, the
// decoded rows joined; the first (W + 7) / 8 * H bytes written. -1 a cut
// row map, -2 a cut row, -3 a run without its two bytes, -4 fewer decoded
// bytes than the image.
int msp_rle_decode(const uint8_t* data, int64_t n, int64_t W, int64_t H,
                   uint8_t* out) {
  const int64_t row_bytes = (W + 7) / 8, need = row_bytes * H;
  if (n < 32 + 2 * H) return -1;
  int64_t pos = 32 + 2 * H, done = 0;
  auto put = [&](const uint8_t* p, int64_t k) {
    const int64_t room = need - done;
    if (room > 0) std::memcpy(out + done, p, k < room ? k : room);
    done += k;
  };
  for (int64_t y = 0; y < H; ++y) {
    const int64_t length = data[32 + 2 * y] | data[33 + 2 * y] << 8;
    if (length == 0) {
      for (int64_t i = 0; i < row_bytes; ++i) {
        const uint8_t white = 0xFF;
        put(&white, 1);
      }
      continue;
    }
    if (pos + length > n) return -2;
    const uint8_t* row = data + pos;
    pos += length;
    int64_t i = 0;
    while (i < length) {
      const uint8_t kind = row[i++];
      if (kind == 0) {
        if (i + 2 > length) return -3;
        for (int r = 0; r < row[i]; ++r) put(row + i + 1, 1);
        i += 2;
      } else {
        const int64_t k = i + kind <= length ? kind : length - i;
        put(row + i, k);
        i += kind;
      }
    }
  }
  return done < need ? -4 : 0;
}

}  // extern "C"
