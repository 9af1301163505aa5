// Native data-loader core: PNG decode for the RGB-D frame pipeline.
//
// Counterpart of the reference's C++ image-loading layer
// (cpp/include/img_loader/ImageLoader.h:130-188 — 16-bit depth PNGs and
// 8-bit color PNGs decoded via OpenCV).  Here the decode is libpng
// directly, exposed over a C ABI and loaded from Python via ctypes
// (psgradientsdf/native.py); io/loaders.py falls back to the zlib codec
// in io/png.py when this library is unavailable.  The prefetching loader (io/prefetch.py)
// calls these from worker threads — every function is re-entrant and
// holds no global state, and ctypes releases the GIL around the call.
//
// Semantics match the io/png.py fallback in io/loaders.py:
//   * depth  (psg_png_read_u16): 16-bit grayscale returned in host byte
//     order; 8-bit grayscale widened value-preserving to u16.
//   * color  (psg_png_read_rgb8): any PNG (palette / gray / 16-bit /
//     alpha) to 8-bit RGB, alpha stripped, palette and gray expanded.
//     Output is RGB — the framework swaps BGR->RGB once at load
//     (io/loaders.py), so no per-sample swap exists downstream.
//
// Return codes: 0 ok; 1 open/parse failure; 2 unsupported layout;
// 3 caller buffer too small.

#include <png.h>

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Reader {
  FILE* fp = nullptr;
  png_structp png = nullptr;
  png_infop info = nullptr;

  ~Reader() {
    if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    if (fp) fclose(fp);
  }

  // fopen + struct creation only — no libpng call that can longjmp, so the
  // caller's setjmp frame is the first (and only) one error paths unwind to.
  bool open(const char* path) {
    fp = fopen(path, "rb");
    if (!fp) return false;
    png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr,
                                 nullptr);
    if (!png) return false;
    info = png_create_info_struct(png);
    return info != nullptr;
  }
};

bool host_is_little_endian() {
  const uint16_t one = 1;
  return *reinterpret_cast<const uint8_t*>(&one) == 1;
}

}  // namespace

extern "C" {

// Header-only probe: dimensions, stored bit depth, channel count.
int psg_png_probe(const char* path, int32_t* w, int32_t* h,
                  int32_t* bit_depth, int32_t* channels) {
  Reader r;
  if (!r.open(path)) return 1;
  if (setjmp(png_jmpbuf(r.png))) return 1;
  png_init_io(r.png, r.fp);
  png_read_info(r.png, r.info);
  *w = static_cast<int32_t>(png_get_image_width(r.png, r.info));
  *h = static_cast<int32_t>(png_get_image_height(r.png, r.info));
  *bit_depth = png_get_bit_depth(r.png, r.info);
  *channels = png_get_channels(r.png, r.info);
  return 0;
}

// Grayscale depth map -> uint16 buffer of capacity cap (elements).
// 16-bit stays exact (byte-swapped to host order); 8-bit widens
// value-preserving (the float32 * unit conversion in io/loaders.py
// then gives the same metres as OpenCV's IMREAD_ANYDEPTH).
int psg_png_read_u16(const char* path, uint16_t* out, int64_t cap) {
  Reader r;
  if (!r.open(path)) return 1;
  if (setjmp(png_jmpbuf(r.png))) return 1;
  png_init_io(r.png, r.fp);
  png_read_info(r.png, r.info);

  const png_uint_32 w = png_get_image_width(r.png, r.info);
  const png_uint_32 h = png_get_image_height(r.png, r.info);
  const int color = png_get_color_type(r.png, r.info);
  int depth = png_get_bit_depth(r.png, r.info);
  if (color != PNG_COLOR_TYPE_GRAY) return 2;
  if (static_cast<int64_t>(w) * h > cap) return 3;

  if (depth < 8) png_set_expand_gray_1_2_4_to_8(r.png);
  if (depth == 16 && host_is_little_endian()) png_set_swap(r.png);
  png_set_interlace_handling(r.png);
  png_read_update_info(r.png, r.info);
  depth = png_get_bit_depth(r.png, r.info);

  std::vector<png_bytep> rows(h);
  std::vector<uint8_t> buf;
  if (depth == 16) {
    for (png_uint_32 y = 0; y < h; ++y)
      rows[y] = reinterpret_cast<png_bytep>(out + static_cast<size_t>(y) * w);
  } else {
    buf.resize(static_cast<size_t>(w) * h);
    for (png_uint_32 y = 0; y < h; ++y)
      rows[y] = buf.data() + static_cast<size_t>(y) * w;
  }
  // re-arm the jump point now that rows/buf are fully constructed: a
  // longjmp from a truncated IDAT inside png_read_image returns here with
  // both objects in a well-defined state, so their destructors run.
  if (setjmp(png_jmpbuf(r.png))) return 1;
  png_read_image(r.png, rows.data());
  if (depth != 16)
    for (size_t i = 0; i < buf.size(); ++i) out[i] = buf[i];
  return 0;
}

// Any PNG -> 8-bit RGB (H*W*3 bytes into out, capacity cap bytes).
// Palette/gray expanded, 16-bit narrowed, alpha stripped — the same
// normalization OpenCV's imread applies (in BGR order).
int psg_png_read_rgb8(const char* path, uint8_t* out, int64_t cap) {
  Reader r;
  if (!r.open(path)) return 1;
  if (setjmp(png_jmpbuf(r.png))) return 1;
  png_init_io(r.png, r.fp);
  png_read_info(r.png, r.info);

  const png_uint_32 w = png_get_image_width(r.png, r.info);
  const png_uint_32 h = png_get_image_height(r.png, r.info);
  if (static_cast<int64_t>(w) * h * 3 > cap) return 3;

  const int color = png_get_color_type(r.png, r.info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(r.png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA) {
    if (png_get_bit_depth(r.png, r.info) < 8)
      png_set_expand_gray_1_2_4_to_8(r.png);
    png_set_gray_to_rgb(r.png);
  }
  if (png_get_valid(r.png, r.info, PNG_INFO_tRNS))
    png_set_tRNS_to_alpha(r.png);
  if (png_get_bit_depth(r.png, r.info) == 16) png_set_strip_16(r.png);
  png_set_strip_alpha(r.png);
  png_set_interlace_handling(r.png);
  png_read_update_info(r.png, r.info);
  if (png_get_channels(r.png, r.info) != 3 ||
      png_get_bit_depth(r.png, r.info) != 8)
    return 2;

  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = out + static_cast<size_t>(y) * w * 3;
  // re-arm after construction (see psg_png_read_u16)
  if (setjmp(png_jmpbuf(r.png))) return 1;
  png_read_image(r.png, rows.data());
  return 0;
}

}  // extern "C"
