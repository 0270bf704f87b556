// Native image decode + preprocess pipeline for the training data loader.
//
// Replacement for the C++ worker machinery the reference leans on
// (torch DataLoader worker processes + libjpeg-turbo via PIL,
// `lumina_next_t2i/train.py:496-520`): JPEG/PNG decode, bilinear
// scale-to-cover, crop, and [-1,1] CHW float32 normalization run in one
// native pass with no intermediate Python objects. Python calls through
// ctypes (which releases the GIL), so a plain thread pool achieves parallel
// decode without subprocess workers.
//
// Build: lumina_t2x_tpu_torch/data/native_loader.py compiles it at first use
// (g++ -O3 -shared -fPIC -std=c++17 ... -ljpeg -lpng -lz) into
// build/native/<hash>/_image_loader.so.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <cstdlib>
#include <algorithm>
#include <vector>

#include <jpeglib.h>
#include <png.h>

extern "C" {

// ---------------------------------------------------------------------------
// decode to RGB8
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// Returns RGB8 buffer (malloc'd, caller frees via free_buffer) or nullptr.
static uint8_t* decode_jpeg(const uint8_t* data, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  uint8_t* out = nullptr;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    free(out);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  size_t stride = size_t(*w) * 3;
  out = static_cast<uint8_t*>(malloc(stride * size_t(*h)));
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + stride * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return out;
}

struct PngReadState {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

static void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + n > s->len) {
    png_error(png, "read past end");
  }
  memcpy(out, s->data + s->pos, n);
  s->pos += n;
}

static uint8_t* decode_png(const uint8_t* data, size_t len, int* w, int* h) {
  if (len < 8 || png_sig_cmp(data, 0, 8)) return nullptr;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return nullptr;
  png_infop info = png_create_info_struct(png);
  uint8_t* out = nullptr;
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    free(out);
    return nullptr;
  }
  PngReadState state{data, len, 0};
  png_set_read_fn(png, &state, png_read_fn);
  png_read_info(png, info);
  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);
  // normalize everything to 8-bit RGB
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY || color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color_type & PNG_COLOR_MASK_ALPHA || png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  png_read_update_info(png, info);

  *w = int(width);
  *h = int(height);
  size_t stride = size_t(width) * 3;
  out = static_cast<uint8_t*>(malloc(stride * height));
  rows.resize(height);
  for (png_uint_32 y = 0; y < height; y++) rows[y] = out + stride * y;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return out;
}

uint8_t* decode_image(const uint8_t* data, size_t len, int* w, int* h) {
  if (len >= 3 && data[0] == 0xFF && data[1] == 0xD8) return decode_jpeg(data, len, w, h);
  if (len >= 8 && data[0] == 0x89 && data[1] == 'P') return decode_png(data, len, w, h);
  return nullptr;
}

void free_buffer(uint8_t* buf) { free(buf); }

// ---------------------------------------------------------------------------
// bilinear scale-to-cover + center/offset crop + normalize to CHW float
// ---------------------------------------------------------------------------

// src: RGB8 (h, w); writes (3, crop_h, crop_w) float32 in [-1, 1].
// crop_x/crop_y: crop origin in the scaled image; pass -1 for center crop.
static void resize_crop_normalize(const uint8_t* src, int w, int h, int crop_w,
                                  int crop_h, int crop_x, int crop_y, float* out) {
  const double scale = std::max(double(crop_w) / w, double(crop_h) / h);
  const int sw = std::max(int(w * scale + 0.5), crop_w);
  const int sh = std::max(int(h * scale + 0.5), crop_h);
  if (crop_x < 0) crop_x = (sw - crop_w) / 2;
  if (crop_y < 0) crop_y = (sh - crop_h) / 2;
  crop_x = std::min(crop_x, sw - crop_w);
  crop_y = std::min(crop_y, sh - crop_h);

  const float inv = 1.0f / 127.5f;
  const size_t plane = size_t(crop_w) * crop_h;
  for (int oy = 0; oy < crop_h; oy++) {
    // map output pixel to source coordinates (align-corners=false convention)
    const double sy = (oy + crop_y + 0.5) / scale - 0.5;
    int y0 = int(std::floor(sy));
    const double fy = sy - y0;
    y0 = std::clamp(y0, 0, h - 1);
    const int y1 = std::min(y0 + 1, h - 1);
    for (int ox = 0; ox < crop_w; ox++) {
      const double sx = (ox + crop_x + 0.5) / scale - 0.5;
      int x0 = int(std::floor(sx));
      const double fx = sx - x0;
      x0 = std::clamp(x0, 0, w - 1);
      const int x1 = std::min(x0 + 1, w - 1);
      const uint8_t* p00 = src + (size_t(y0) * w + x0) * 3;
      const uint8_t* p01 = src + (size_t(y0) * w + x1) * 3;
      const uint8_t* p10 = src + (size_t(y1) * w + x0) * 3;
      const uint8_t* p11 = src + (size_t(y1) * w + x1) * 3;
      for (int ch = 0; ch < 3; ch++) {
        const double v =
            (1 - fy) * ((1 - fx) * p00[ch] + fx * p01[ch]) +
            fy * ((1 - fx) * p10[ch] + fx * p11[ch]);
        out[plane * ch + size_t(oy) * crop_w + ox] = float(v) * inv - 1.0f;
      }
    }
  }
}

// Full pipeline from encoded bytes. Returns 0 on success.
int decode_to_tensor(const uint8_t* data, size_t len, int crop_w, int crop_h,
                     int crop_x, int crop_y, float* out) {
  int w = 0, h = 0;
  uint8_t* rgb = decode_image(data, len, &w, &h);
  if (!rgb) return 1;
  resize_crop_normalize(rgb, w, h, crop_w, crop_h, crop_x, crop_y, out);
  free(rgb);
  return 0;
}

// Probe the natural size without full decode path (decodes header only for
// jpeg; png reads info). Returns 0 on success.
int probe_size(const uint8_t* data, size_t len, int* w, int* h) {
  if (len >= 3 && data[0] == 0xFF && data[1] == 0xD8) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jb)) {
      jpeg_destroy_decompress(&cinfo);
      return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
      jpeg_destroy_decompress(&cinfo);
      return 1;
    }
    *w = cinfo.image_width;
    *h = cinfo.image_height;
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  int ww, hh;
  uint8_t* buf = decode_png(data, len, &ww, &hh);
  if (!buf) return 1;
  free(buf);
  *w = ww;
  *h = hh;
  return 0;
}

}  // extern "C"
