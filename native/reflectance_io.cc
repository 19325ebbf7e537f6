// Native IO runtime for reflectance_filtering.
//
// Replaces the host-side role OpenCV's C++ core played for the reference
// (imread/resize feeding the network, SURVEY.md N5): a dependency-light,
// thread-pooled image decoder + resizer that fills caller-allocated
// [N, H, W, 3] uint8 RGB batches at full core parallelism, so a single
// Python thread can keep the accelerator's input pipeline fed.
//
// Formats: PNG (libpng, any bit depth/colortype -> 8-bit RGB) and JPEG
// (libjpeg).  Resize: bilinear with half-pixel centers (OpenCV
// INTER_LINEAR convention).
//
// C ABI only (consumed via ctypes from
// reflectance_filtering/data/native_loader.py).  All functions return
// 0 on success, negative error codes otherwise; no exceptions cross the
// boundary.

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <atomic>
#include <memory>
#include <thread>
#include <vector>

#include <png.h>
#include <jpeglib.h>

namespace {

constexpr int kErrOpen = -1;
constexpr int kErrFormat = -2;
constexpr int kErrDecode = -3;
constexpr int kErrArgs = -4;
constexpr int kErrMemory = -5;

// Reject absurd declared dimensions before allocating (a corrupt header
// can claim terapixel images in a few KB of file).
constexpr size_t kMaxPixels = size_t(1) << 28;  // 268 MP ~ 800 MB RGB

struct Image {
  int h = 0, w = 0;
  std::vector<unsigned char> rgb;  // h*w*3
};

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

int decode_png(FILE* f, Image* out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return kErrDecode;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return kErrDecode;
  }
  // declared BEFORE setjmp: a longjmp back across a scope that
  // constructed non-trivial objects after setjmp is UB (and leaked the
  // row buffer on every failed decode); alive-at-setjmp objects are
  // destroyed normally when the function returns
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrDecode;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (static_cast<size_t>(h) * w > kMaxPixels || h == 0 || w == 0) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrDecode;
  }

  // normalize every variant to 8-bit RGB
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->h = static_cast<int>(h);
  out->w = static_cast<int>(w);
  try {
    out->rgb.resize(static_cast<size_t>(h) * w * 3);
    rows.resize(h);
  } catch (const std::exception&) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrMemory;
  }
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = out->rgb.data() + static_cast<size_t>(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

int decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return kErrDecode;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  out->h = static_cast<int>(cinfo.output_height);
  out->w = static_cast<int>(cinfo.output_width);
  if (static_cast<size_t>(out->h) * out->w > kMaxPixels ||
      out->h <= 0 || out->w <= 0) {
    jpeg_destroy_decompress(&cinfo);
    return kErrDecode;
  }
  try {
    out->rgb.resize(static_cast<size_t>(out->h) * out->w * 3);
  } catch (const std::exception&) {
    jpeg_destroy_decompress(&cinfo);
    return kErrMemory;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row =
        out->rgb.data() +
        static_cast<size_t>(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int probe_png(FILE* f, int* h, int* w) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return kErrDecode;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return kErrDecode;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrDecode;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 ph = png_get_image_height(png, info);
  png_uint_32 pw = png_get_image_width(png, info);
  png_destroy_read_struct(&png, &info, nullptr);
  // Same sanity gate as the decode path: a corrupt header claiming
  // terapixel dims would otherwise drive a huge np.empty in the Python
  // batch loader (which allocates from probed sizes before decoding).
  if (static_cast<size_t>(ph) * pw > kMaxPixels || ph == 0 || pw == 0)
    return kErrDecode;
  *h = static_cast<int>(ph);
  *w = static_cast<int>(pw);
  return 0;
}

int probe_jpeg(FILE* f, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return kErrDecode;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  size_t ph = cinfo.image_height, pw = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  if (ph * pw > kMaxPixels || ph == 0 || pw == 0) return kErrDecode;
  *h = static_cast<int>(ph);
  *w = static_cast<int>(pw);
  return 0;
}

enum class Op { kDecode, kProbe };

int open_dispatch(const char* path, Op op, Image* out, int* h, int* w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return kErrOpen;
  unsigned char magic[4] = {0, 0, 0, 0};
  size_t got = std::fread(magic, 1, 4, f);
  std::rewind(f);
  int rc;
  if (got >= 4 && magic[0] == 0x89 && magic[1] == 'P' && magic[2] == 'N' &&
      magic[3] == 'G') {
    rc = op == Op::kDecode ? decode_png(f, out) : probe_png(f, h, w);
  } else if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    rc = op == Op::kDecode ? decode_jpeg(f, out) : probe_jpeg(f, h, w);
  } else {
    rc = kErrFormat;
  }
  std::fclose(f);
  return rc;
}

int decode_any(const char* path, Image* out) {
  return open_dispatch(path, Op::kDecode, out, nullptr, nullptr);
}

// ---------------------------------------------------------------------------
// Resize (bilinear, half-pixel centers — OpenCV INTER_LINEAR convention)
// ---------------------------------------------------------------------------

void resize_bilinear(const Image& src, unsigned char* dst, int dh, int dw) {
  if (src.h == dh && src.w == dw) {
    std::memcpy(dst, src.rgb.data(), static_cast<size_t>(dh) * dw * 3);
    return;
  }
  const float sy = static_cast<float>(src.h) / dh;
  const float sx = static_cast<float>(src.w) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = y0 + 1;
    if (y0 < 0) { y0 = 0; y1 = 0; wy = 0.f; }
    if (y1 >= src.h) { y1 = src.h - 1; if (y0 > y1) { y0 = y1; wy = 0.f; } }
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x1 = x0 + 1;
      if (x0 < 0) { x0 = 0; x1 = 0; wx = 0.f; }
      if (x1 >= src.w) { x1 = src.w - 1; if (x0 > x1) { x0 = x1; wx = 0.f; } }
      const unsigned char* p00 = &src.rgb[(static_cast<size_t>(y0) * src.w + x0) * 3];
      const unsigned char* p01 = &src.rgb[(static_cast<size_t>(y0) * src.w + x1) * 3];
      const unsigned char* p10 = &src.rgb[(static_cast<size_t>(y1) * src.w + x0) * 3];
      const unsigned char* p11 = &src.rgb[(static_cast<size_t>(y1) * src.w + x1) * 3];
      unsigned char* q = dst + (static_cast<size_t>(y) * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = (1 - wy) * ((1 - wx) * p00[c] + wx * p01[c]) +
                  wy * ((1 - wx) * p10[c] + wx * p11[c]);
        int iv = static_cast<int>(v + 0.5f);
        q[c] = static_cast<unsigned char>(iv < 0 ? 0 : (iv > 255 ? 255 : iv));
      }
    }
  }
}

}  // namespace

extern "C" {

const char* rio_version() { return "reflectance_io 1.0"; }

// Probe dimensions header-only (png_read_info / jpeg_read_header; no
// pixel decode or allocation).
int rio_image_size(const char* path, int* h, int* w) {
  if (!path || !h || !w) return kErrArgs;
  try {
    return open_dispatch(path, Op::kProbe, nullptr, h, w);
  } catch (...) {
    return kErrDecode;  // contract: no exceptions cross the C ABI
  }
}

// Decode one image into out[target_h * target_w * 3] (RGB, resized).
int rio_decode_rgb(const char* path, unsigned char* out, int target_h,
                   int target_w) {
  if (!path || !out || target_h <= 0 || target_w <= 0) return kErrArgs;
  try {
    Image img;
    int rc = decode_any(path, &img);
    if (rc) return rc;
    resize_bilinear(img, out, target_h, target_w);
    return 0;
  } catch (...) {
    return kErrMemory;  // contract: no exceptions cross the C ABI
  }
}

// Decode n images in parallel into out[n * h * w * 3].  Returns 0 if all
// succeeded, else the first failing index encoded as -(1000 + index).
int rio_load_batch_rgb(const char** paths, int n, unsigned char* out,
                       int target_h, int target_w, int nthreads) {
  if (!paths || !out || n <= 0 || target_h <= 0 || target_w <= 0)
    return kErrArgs;
  if (nthreads <= 0)
    nthreads = static_cast<int>(std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = n;

  std::atomic<int> next(0);
  std::atomic<int> first_fail(-1);
  const size_t stride = static_cast<size_t>(target_h) * target_w * 3;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int rc;
      try {
        rc = rio_decode_rgb(paths[i], out + stride * i, target_h,
                            target_w);
      } catch (...) {
        rc = kErrMemory;  // an escaping exception would std::terminate
      }
      if (rc) {
        int expected = -1;
        first_fail.compare_exchange_strong(expected, i);
      }
    }
  };

  // The calling thread always runs the work-stealing loop too, so thread
  // creation failure (EAGAIN under pid limits) degrades gracefully: catch
  // std::system_error instead of letting it terminate() across the C ABI,
  // and whatever threads did start (possibly zero) share the queue.
  std::vector<std::thread> pool;
  try {
    for (int t = 0; t < nthreads - 1; ++t) pool.emplace_back(worker);
  } catch (const std::exception&) {
  }
  worker();
  for (auto& th : pool) th.join();

  int fail = first_fail.load();
  return fail < 0 ? 0 : -(1000 + fail);
}

}  // extern "C"
