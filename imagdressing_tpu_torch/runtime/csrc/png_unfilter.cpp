// PNG row reconstruction for `apps/png.py`: the specification's five row
// filters (None, Sub, Up, Average, Paeth), applied row by row in order.
//
// Plain C interface for ctypes; links no library and keeps no state, so
// calls from several threads run at once (ctypes releases the GIL).
//
//   igd_png_unfilter(rows, h, row_bytes, bpp, out)
//     rows: h rows of 1 + row_bytes bytes as inflated (filter byte first)
//     bpp:  bytes per complete pixel, 1 to 4 (1 for sub-byte depths)
//     out:  h rows of row_bytes reconstructed bytes
//   returns 0; the largest filter byte where one is above 4 (nothing is
//   written then); -1 for a bpp outside 1..4 or rows of partial pixels.
//   Rows of no bytes (a width of 0) are checked and left empty.

#include <cstdint>
#include <cstdlib>
#include <cstring>

#if defined(__SSSE3__)
#include <tmmintrin.h>
#endif

namespace {

#if defined(__SSSE3__)
// Average (KIND 3) or Paeth (KIND 4) along a row below another, one pixel a
// step with its byte lanes side by side as 16-bit lanes of one SSE register
// (libpng's scheme): the chain through the left pixel is a few vector
// operations, where the scalar loop stores each byte and reads it back, and
// Paeth's choice among left, above and upper left mispredicts as a branch.
// The row's first pixel is already done.
template <int BPP, int KIND>
void left_chain_simd(const uint8_t* f, const uint8_t* up, uint8_t* out,
                     int64_t n) {
  const __m128i zero = _mm_setzero_si128();
  // `bytes` from p into the low lanes; a whole 4-byte load wherever the
  // row has the bytes (the lanes past BPP are never stored), since a load
  // assembled from narrower ones stalls on store forwarding
  auto load = [&](const uint8_t* p, int bytes) {
    uint32_t v = 0;
    std::memcpy(&v, p, bytes);
    return _mm_unpacklo_epi8(_mm_cvtsi32_si128(static_cast<int>(v)), zero);
  };
  __m128i a = load(out, BPP), c = load(up, BPP);
  auto step = [&](int64_t i, int bytes) {
    const __m128i b = load(up + i, bytes);
    const __m128i x = load(f + i, bytes);
    __m128i pred;
    if constexpr (KIND == 3) {
      pred = _mm_srli_epi16(_mm_add_epi16(a, b), 1);
    } else {
      const __m128i da = _mm_sub_epi16(b, c);  // p - a for p = a + b - c
      const __m128i db = _mm_sub_epi16(a, c);  // p - b
      const __m128i pa = _mm_abs_epi16(da);
      const __m128i pb = _mm_abs_epi16(db);
      const __m128i pc = _mm_abs_epi16(_mm_add_epi16(da, db));
      const __m128i least = _mm_min_epi16(pc, _mm_min_epi16(pa, pb));
      const __m128i is_a = _mm_cmpeq_epi16(least, pa);
      const __m128i is_b = _mm_cmpeq_epi16(least, pb);
      const __m128i bc = _mm_or_si128(_mm_and_si128(is_b, b),
                                      _mm_andnot_si128(is_b, c));
      pred = _mm_or_si128(_mm_and_si128(is_a, a),
                          _mm_andnot_si128(is_a, bc));
    }
    // bytes wrap modulo 256 and the lanes' high bytes stay zero
    a = _mm_add_epi8(x, pred);
    const uint32_t v =
        static_cast<uint32_t>(_mm_cvtsi128_si32(_mm_packus_epi16(a, a)));
    std::memcpy(out + i, &v, BPP);
    c = b;
  };
  int64_t i = BPP;
  for (; i + 4 <= n; i += BPP) step(i, 4);
  for (; i + BPP <= n; i += BPP) step(i, BPP);
}
#else
inline int paeth(int a, int b, int c) {
  const int pa = std::abs(b - c);          // |p - a| for p = a + b - c
  const int pb = std::abs(a - c);          // |p - b|
  const int pc = std::abs(a + b - 2 * c);  // |p - c|
  return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}
#endif

// One row of n bytes; `up` is the reconstructed row above, or nullptr for
// the first row (whose row above is zero).
template <int BPP>
void unfilter_row(int kind, const uint8_t* f, const uint8_t* up,
                  uint8_t* out, int64_t n) {
  switch (kind) {
    case 0:
      std::memcpy(out, f, n);
      return;
    case 1:
      std::memcpy(out, f, BPP);
      for (int64_t i = BPP; i < n; ++i)
        out[i] = static_cast<uint8_t>(f[i] + out[i - BPP]);
      return;
    case 2:
      if (up == nullptr) {
        std::memcpy(out, f, n);
      } else {
        for (int64_t i = 0; i < n; ++i)
          out[i] = static_cast<uint8_t>(f[i] + up[i]);
      }
      return;
    case 3:
      if (up == nullptr) {
        std::memcpy(out, f, BPP);
        for (int64_t i = BPP; i < n; ++i)
          out[i] = static_cast<uint8_t>(f[i] + (out[i - BPP] >> 1));
        return;
      }
      for (int64_t i = 0; i < BPP; ++i)
        out[i] = static_cast<uint8_t>(f[i] + (up[i] >> 1));
#if defined(__SSSE3__)
      left_chain_simd<BPP, 3>(f, up, out, n);
#else
      for (int64_t i = BPP; i < n; ++i)
        out[i] = static_cast<uint8_t>(f[i] + ((out[i - BPP] + up[i]) >> 1));
#endif
      return;
    default:  // 4, Paeth
      if (up == nullptr) {
        // above and upper left are zero: Paeth(a, 0, 0) = a, i.e. Sub
        std::memcpy(out, f, BPP);
        for (int64_t i = BPP; i < n; ++i)
          out[i] = static_cast<uint8_t>(f[i] + out[i - BPP]);
        return;
      }
      // left and upper left are zero: the predictor is the byte above
      for (int64_t i = 0; i < BPP; ++i)
        out[i] = static_cast<uint8_t>(f[i] + up[i]);
#if defined(__SSSE3__)
      left_chain_simd<BPP, 4>(f, up, out, n);
#else
      for (int64_t i = BPP; i < n; ++i)
        out[i] = static_cast<uint8_t>(
            f[i] + paeth(out[i - BPP], up[i], up[i - BPP]));
#endif
      return;
  }
}

template <int BPP>
void unfilter(const uint8_t* rows, int64_t h, int64_t n, uint8_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* src = rows + y * (n + 1);
    unfilter_row<BPP>(src[0], src + 1, y ? out + (y - 1) * n : nullptr,
                      out + y * n, n);
  }
}

}  // namespace

extern "C" int igd_png_unfilter(const uint8_t* rows, int64_t h,
                                int64_t row_bytes, int bpp, uint8_t* out) {
  if (bpp < 1 || bpp > 4 || row_bytes % bpp) return -1;
  int worst = 0;
  for (int64_t y = 0; y < h; ++y) {
    const int kind = rows[y * (row_bytes + 1)];
    if (kind > worst) worst = kind;
  }
  if (worst > 4) return worst;
  if (row_bytes == 0) return 0;
  switch (bpp) {
    case 1: unfilter<1>(rows, h, row_bytes, out); break;
    case 2: unfilter<2>(rows, h, row_bytes, out); break;
    case 3: unfilter<3>(rows, h, row_bytes, out); break;
    default: unfilter<4>(rows, h, row_bytes, out); break;
  }
  return 0;
}
