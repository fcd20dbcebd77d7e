// Native image data path of the training input pipeline (the port's copy
// of the JAX package's runtime/csrc/image_ops.cpp, unchanged in its
// arithmetic so that both give the same arrays).
//
// The reference implementation feeds training through DataLoader worker
// processes doing PIL decode + torchvision transforms (its IGPair.py and
// train.py). Python-side decode easily starves a training step, so the hot
// path -- JPEG decode, bilinear resize, crop, normalize -- runs here in C++
// (libjpeg + plain loops), exposed through a plain C ABI consumed via ctypes
// (imagdressing_tpu_torch/runtime/native.py). Host code: nothing here runs
// on the card.
//
// All functions return 0 on success, negative on failure.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <algorithm>
#include <vector>

#include <jpeglib.h>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// PIL-equivalent separable triangle (BILINEAR) resampling: half-pixel
// center mapping with the filter support scaled by the downscale factor
// (PIL always antialiases on downscale — Resample.c). The previous
// align-corners 2-tap version aliased heavily on the >2x downscales the
// training pipeline does and sampled a shifted grid vs PIL/torchvision.
void compute_triangle_weights(int ssize, int dsize, std::vector<int>& xmins,
                              std::vector<int>& xmaxs,
                              std::vector<float>& weights, int& ksize) {
  const double scale = static_cast<double>(ssize) / dsize;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // triangle filter support
  ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  xmins.resize(dsize);
  xmaxs.resize(dsize);
  weights.assign(static_cast<size_t>(dsize) * ksize, 0.f);
  const double ss = 1.0 / filterscale;
  for (int xx = 0; xx < dsize; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > ssize) xmax = ssize;
    xmax -= xmin;
    float* k = &weights[static_cast<size_t>(xx) * ksize];
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      const double arg = (x + xmin - center + 0.5) * ss;
      const double a = arg < 0 ? -arg : arg;
      const double w = a < 1.0 ? 1.0 - a : 0.0;
      k[x] = static_cast<float>(w);
      ww += w;
    }
    if (ww != 0.0) {
      for (int x = 0; x < xmax; ++x) k[x] = static_cast<float>(k[x] / ww);
    }
    xmins[xx] = xmin;
    xmaxs[xx] = xmax;
  }
}

void resize_bilinear_u8(const uint8_t* src, int sh, int sw, uint8_t* dst,
                        int dh, int dw, int ch) {
  std::vector<int> xmins, xmaxs, ymins, ymaxs;
  std::vector<float> xw, yw;
  int xk = 0, yk = 0;
  compute_triangle_weights(sw, dw, xmins, xmaxs, xw, xk);
  compute_triangle_weights(sh, dh, ymins, ymaxs, yw, yk);

  // horizontal pass: (sh, sw, ch) u8 -> (sh, dw, ch) float
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * ch);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * ch;
    float* out = tmp.data() + static_cast<size_t>(y) * dw * ch;
    for (int x = 0; x < dw; ++x) {
      const float* k = &xw[static_cast<size_t>(x) * xk];
      const int xmin = xmins[x], xmax = xmaxs[x];
      for (int c = 0; c < ch; ++c) {
        float acc = 0.f;
        for (int i = 0; i < xmax; ++i)
          acc += row[(xmin + i) * ch + c] * k[i];
        out[x * ch + c] = acc;
      }
    }
  }
  // vertical pass: (sh, dw, ch) float -> (dh, dw, ch) u8
  for (int y = 0; y < dh; ++y) {
    const float* k = &yw[static_cast<size_t>(y) * yk];
    const int ymin = ymins[y], ymax = ymaxs[y];
    uint8_t* out = dst + static_cast<size_t>(y) * dw * ch;
    for (int x = 0; x < dw * ch; ++x) {
      float acc = 0.f;
      for (int i = 0; i < ymax; ++i)
        acc += tmp[static_cast<size_t>(ymin + i) * dw * ch + x] * k[i];
      const float v = acc + 0.5f;
      out[x] = v <= 0.f ? 0 : (v >= 255.f ? 255 : static_cast<uint8_t>(v));
    }
  }
}

}  // namespace

extern "C" {

// Decode a JPEG buffer. Returns 0 and fills *out_h/*out_w on success.
// `out` must hold max_h*max_w*3 bytes; decode fails (-2) if larger.
int igd_jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out,
                    int max_h, int max_w, int* out_h, int* out_w) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int h = cinfo.output_height;
  const int w = cinfo.output_width;
  if (h > max_h || w > max_w || cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out_h = h;
  *out_w = w;
  return 0;
}

// Resize (bilinear, shorter side -> `size`), crop at (top, left) to
// (crop_h, crop_w), normalize to [-1, 1] float32 HWC.
int igd_resize_crop_normalize(const uint8_t* src, int sh, int sw, int size,
                              int top, int left, int crop_h, int crop_w,
                              float* out) {
  int rh, rw;
  if (sh < sw) {
    rh = size;
    rw = std::max(1, static_cast<int>(static_cast<int64_t>(sw) * size / sh));
  } else {
    rw = size;
    rh = std::max(1, static_cast<int>(static_cast<int64_t>(sh) * size / sw));
  }
  if (top < 0 || left < 0 || top + crop_h > rh || left + crop_w > rw)
    return -1;
  std::vector<uint8_t> resized(static_cast<size_t>(rh) * rw * 3);
  resize_bilinear_u8(src, sh, sw, resized.data(), rh, rw, 3);
  for (int y = 0; y < crop_h; ++y) {
    const uint8_t* row =
        resized.data() + (static_cast<size_t>(top + y) * rw + left) * 3;
    float* orow = out + static_cast<size_t>(y) * crop_w * 3;
    for (int i = 0; i < crop_w * 3; ++i) {
      orow[i] = row[i] * (1.f / 127.5f) - 1.f;
    }
  }
  return 0;
}

// CLIP view: shortest-side bicubic-ish (bilinear here) resize to `size`,
// center crop size x size, CLIP mean/std normalize.
int igd_clip_preprocess(const uint8_t* src, int sh, int sw, int size,
                        float* out) {
  static const float kMean[3] = {0.48145466f, 0.4578275f, 0.40821073f};
  static const float kStd[3] = {0.26862954f, 0.26130258f, 0.27577711f};
  int rh, rw;
  if (sh < sw) {
    rh = size;
    rw = std::max(size, static_cast<int>(static_cast<int64_t>(sw) * size / sh));
  } else {
    rw = size;
    rh = std::max(size, static_cast<int>(static_cast<int64_t>(sh) * size / sw));
  }
  std::vector<uint8_t> resized(static_cast<size_t>(rh) * rw * 3);
  resize_bilinear_u8(src, sh, sw, resized.data(), rh, rw, 3);
  const int top = (rh - size) / 2;
  const int left = (rw - size) / 2;
  for (int y = 0; y < size; ++y) {
    const uint8_t* row =
        resized.data() + (static_cast<size_t>(top + y) * rw + left) * 3;
    float* orow = out + static_cast<size_t>(y) * size * 3;
    for (int x = 0; x < size; ++x) {
      for (int c = 0; c < 3; ++c) {
        orow[x * 3 + c] =
            (row[x * 3 + c] * (1.f / 255.f) - kMean[c]) / kStd[c];
      }
    }
  }
  return 0;
}

}  // extern "C"
