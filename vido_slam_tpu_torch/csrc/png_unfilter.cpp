// PNG row unfiltering (PNG specification, section 9: filter method 0) on
// the host: the inflated IDAT stream of a non-interlaced image holds
// `height` rows of one filter-type byte and `rowbytes` filtered bytes.
// Each row is reconstructed from the filtered bytes, the reconstructed
// byte `bpp` to the left (a) and the reconstructed row above (b, c = its
// left neighbour); a and c are 0 left of the row, the row above the first
// is 0. Sub and Up could be vectorised, Avg and Paeth are sequential along
// a row, so the whole pass is plain C++. Bound with ctypes by io/png.py.

#include <cstdint>
#include <cstdlib>

extern "C" {

// Returns 0, or -(1 + row) for a row whose filter type is not 0..4.
int png_unfilter(const uint8_t* src, uint8_t* dst, int64_t height,
                 int64_t rowbytes, int64_t bpp) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = src + y * (rowbytes + 1);
    const uint8_t type = in[0];
    ++in;
    uint8_t* out = dst + y * rowbytes;
    const uint8_t* up = y > 0 ? out - rowbytes : nullptr;
    switch (type) {
      case 0:
        for (int64_t i = 0; i < rowbytes; ++i) out[i] = in[i];
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i)
          out[i] = uint8_t(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i)
          out[i] = uint8_t(in[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          out[i] = uint8_t(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = uint8_t(in[i] + pred);
        }
        break;
      default:
        return -int(1 + y);
    }
  }
  return 0;
}

}  // extern "C"
