// Native host-side image pipeline: decode (libjpeg/libpng) + resize + crop +
// normalize, fused into one pass with no Python-side intermediates and no GIL.
// A copy of the JAX package's vqgan_tpu/data/native/decoder.cpp.
//
// The tar readers (data/tar_stream.py, data/indexed.py) call it through
// ctypes (data/native/__init__.py) from their worker threads; randomness
// (crop offsets, branch choices) stays in Python for testability, and C++
// receives fractional offsets and does the heavy lifting.
//
// Exposed C ABI:
//   vq_pipeline(buf, len, resize_to, crop_fx, crop_fy, target, out) -> int
//     decode → (optional) resize shorter side to `resize_to` (area for
//     downscale, bilinear for upscale) → crop `target`² at fractional offset
//     (fx, fy of the slack) → normalize uint8 → float32 in [-1, 1] (HWC RGB).
//     If the decoded/resized image is smaller than `target`, it is first
//     upscaled so the shorter side == target.
//   vq_pipeline_u8(...): the same, uint8 out (normalized on the device).
//   vq_probe(buf, len, &w, &h): the decoded size.
//   Each returns 0 on success, negative error codes otherwise.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 decoder.cpp -ljpeg -lpng, at first
// use, into vqgan_tpu_torch/_build/ (data/native/__init__.py).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <vector>
#include <algorithm>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
  std::vector<uint8_t> data;  // HWC RGB8
  int w = 0, h = 0;
};

// ---------------- JPEG ----------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

bool decode_jpeg(const uint8_t* buf, size_t len, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->data.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------- PNG ----------------

struct PngReadState {
  const uint8_t* buf;
  size_t len;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = reinterpret_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + n > s->len) {
    png_error(png, "read past end");
    return;
  }
  memcpy(out, s->buf + s->pos, n);
  s->pos += n;
}

bool decode_png(const uint8_t* buf, size_t len, Image* out) {
  if (len < 8 || png_sig_cmp(buf, 0, 8)) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState state{buf, len, 0};
  png_set_read_fn(png, &state, png_read_fn);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  // normalize to 8-bit RGB
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->w = int(w);
  out->h = int(h);
  out->data.resize(size_t(w) * h * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = out->data.data() + size_t(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// ---------------- resize ----------------

// area (box) resampling — correct for downscale (matches cv2 INTER_AREA
// within rounding for arbitrary ratios)
void resize_area(const Image& src, Image* dst, int nw, int nh) {
  dst->w = nw;
  dst->h = nh;
  dst->data.resize(size_t(nw) * nh * 3);
  const double sx = double(src.w) / nw, sy = double(src.h) / nh;
  for (int y = 0; y < nh; ++y) {
    const double y0 = y * sy, y1 = (y + 1) * sy;
    const int iy0 = int(y0), iy1 = std::min(int(std::ceil(y1)), src.h);
    for (int x = 0; x < nw; ++x) {
      const double x0 = x * sx, x1 = (x + 1) * sx;
      const int ix0 = int(x0), ix1 = std::min(int(std::ceil(x1)), src.w);
      double acc[3] = {0, 0, 0}, area = 0;
      for (int yy = iy0; yy < iy1; ++yy) {
        const double wy =
            std::min<double>(yy + 1, y1) - std::max<double>(yy, y0);
        const uint8_t* row = src.data.data() + size_t(yy) * src.w * 3;
        for (int xx = ix0; xx < ix1; ++xx) {
          const double wx =
              std::min<double>(xx + 1, x1) - std::max<double>(xx, x0);
          const double wgt = wx * wy;
          area += wgt;
          const uint8_t* p = row + size_t(xx) * 3;
          acc[0] += wgt * p[0];
          acc[1] += wgt * p[1];
          acc[2] += wgt * p[2];
        }
      }
      uint8_t* q = dst->data.data() + (size_t(y) * nw + x) * 3;
      for (int c = 0; c < 3; ++c)
        q[c] = uint8_t(std::min(255.0, std::max(0.0, acc[c] / area + 0.5)));
    }
  }
}

void resize_bilinear(const Image& src, Image* dst, int nw, int nh) {
  dst->w = nw;
  dst->h = nh;
  dst->data.resize(size_t(nw) * nh * 3);
  const double sx = double(src.w) / nw, sy = double(src.h) / nh;
  for (int y = 0; y < nh; ++y) {
    const double fy = (y + 0.5) * sy - 0.5;
    const int y0 = std::max(0, std::min(src.h - 1, int(std::floor(fy))));
    const int y1 = std::min(src.h - 1, y0 + 1);
    const double wy = fy - y0;
    for (int x = 0; x < nw; ++x) {
      const double fx = (x + 0.5) * sx - 0.5;
      const int x0 = std::max(0, std::min(src.w - 1, int(std::floor(fx))));
      const int x1 = std::min(src.w - 1, x0 + 1);
      const double wx = fx - x0;
      uint8_t* q = dst->data.data() + (size_t(y) * nw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        const double v00 = src.data[(size_t(y0) * src.w + x0) * 3 + c];
        const double v01 = src.data[(size_t(y0) * src.w + x1) * 3 + c];
        const double v10 = src.data[(size_t(y1) * src.w + x0) * 3 + c];
        const double v11 = src.data[(size_t(y1) * src.w + x1) * 3 + c];
        const double v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                         v10 * wy * (1 - wx) + v11 * wy * wx;
        q[c] = uint8_t(std::min(255.0, std::max(0.0, v + 0.5)));
      }
    }
  }
}

void resize_shorter_side(Image* img, int target) {
  int nw, nh;
  if (img->h <= img->w) {
    nh = target;
    nw = std::max(target, int(std::lround(double(img->w) * target / img->h)));
  } else {
    nw = target;
    nh = std::max(target, int(std::lround(double(img->h) * target / img->w)));
  }
  if (nw == img->w && nh == img->h) return;
  Image out;
  if (nw < img->w)
    resize_area(*img, &out, nw, nh);
  else
    resize_bilinear(*img, &out, nw, nh);
  *img = std::move(out);
}

}  // namespace

extern "C" {

// Decode only: caller provides a sufficiently large out buffer obtained after
// a vq_probe call. Returns 0, or <0 on error.
int vq_probe(const uint8_t* buf, size_t len, int* w, int* h) {
  Image img;
  bool ok = false;
  if (len > 3 && buf[0] == 0xFF && buf[1] == 0xD8)
    ok = decode_jpeg(buf, len, &img);
  else
    ok = decode_png(buf, len, &img);
  if (!ok) return -1;
  *w = img.w;
  *h = img.h;
  return 0;
}

// Shared decode + resize + crop; writes the crop offset into (ox, oy).
static int pipeline_common(const uint8_t* buf, size_t len, int resize_to,
                           double crop_fx, double crop_fy, int target,
                           Image* img, int* ox_out, int* oy_out) {
  bool ok = false;
  if (len > 3 && buf[0] == 0xFF && buf[1] == 0xD8)
    ok = decode_jpeg(buf, len, img);
  else
    ok = decode_png(buf, len, img);
  if (!ok) return -1;

  if (resize_to > 0) resize_shorter_side(img, resize_to);
  if (img->w < target || img->h < target) resize_shorter_side(img, target);

  const int max_x = img->w - target, max_y = img->h - target;
  int ox = int(crop_fx * (max_x + 1));
  int oy = int(crop_fy * (max_y + 1));
  *ox_out = std::max(0, std::min(max_x, ox));
  *oy_out = std::max(0, std::min(max_y, oy));
  return 0;
}

// Fused pipeline; see file header. mode:
//   resize_to == 0 → no shorter-side resize (beyond the ensure-min-target)
int vq_pipeline(const uint8_t* buf, size_t len, int resize_to, double crop_fx,
                double crop_fy, int target, float* out) {
  if (target <= 0 || !out) return -2;
  Image img;
  int ox, oy;
  int rc = pipeline_common(buf, len, resize_to, crop_fx, crop_fy, target,
                           &img, &ox, &oy);
  if (rc != 0) return rc;

  const float scale = 1.0f / 127.5f;
  for (int y = 0; y < target; ++y) {
    const uint8_t* row =
        img.data.data() + (size_t(oy + y) * img.w + ox) * 3;
    float* q = out + size_t(y) * target * 3;
    for (int i = 0; i < target * 3; ++i) q[i] = row[i] * scale - 1.0f;
  }
  return 0;
}

// Same pipeline, raw uint8 output: normalization happens on the device (4x
// less host-to-device traffic).
int vq_pipeline_u8(const uint8_t* buf, size_t len, int resize_to,
                   double crop_fx, double crop_fy, int target, uint8_t* out) {
  if (target <= 0 || !out) return -2;
  Image img;
  int ox, oy;
  int rc = pipeline_common(buf, len, resize_to, crop_fx, crop_fy, target,
                           &img, &ox, &oy);
  if (rc != 0) return rc;

  for (int y = 0; y < target; ++y) {
    const uint8_t* row =
        img.data.data() + (size_t(oy + y) * img.w + ox) * 3;
    std::memcpy(out + size_t(y) * target * 3, row, size_t(target) * 3);
  }
  return 0;
}

}  // extern "C"
