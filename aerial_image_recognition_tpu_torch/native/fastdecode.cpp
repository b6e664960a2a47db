// fastdecode — libjpeg(-turbo) RGB decode for the ingest plane.
//
// The reference leans on Pillow/libjpeg via PIL.Image.open for every fetched
// tile (SURVEY.md §2.2, e.g. reference simple_detector.py:129). This module
// is the framework's first-party native decode path: it decodes JPEG bytes
// straight into a caller-provided numpy buffer (no PIL object layer, no
// intermediate copies) and supports libjpeg's fractional DCT scaling
// (scale 1/1, 1/2, 1/4, 1/8) so oversized sources can be downscaled during
// decode instead of resized afterwards. Called via ctypes from
// aerial_image_recognition_tpu_torch/gio/decode.py; the GIL is released for
// the duration of the call, so the existing fetch thread pools scale across
// cores. A copy of native/fastdecode.cpp without its quad-layout packer,
// which is in fastpack.cpp beside it (it needs no libjpeg).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <csetjmp>
#include <cstdint>
#include <cstring>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}

void emit_nothing(j_common_ptr, int) {}

}  // namespace

extern "C" {

// Decode JPEG bytes to tightly-packed RGB.
//
//   data/len     compressed bytes
//   out/out_cap  destination buffer (pass out=nullptr to probe dimensions)
//   w/h          receive output dimensions (after scaling)
//   scale_denom  1, 2, 4 or 8 — decode at 1/scale_denom resolution
//
// Returns 0 on success, negative on error (corrupt stream, buffer too
// small, bad arguments). Never throws, never longjmps past the caller.
int jpeg_decode_rgb(const uint8_t* data, int64_t len, uint8_t* out,
                    int64_t out_cap, int* w, int* h, int scale_denom) {
  if (data == nullptr || len <= 0 || w == nullptr || h == nullptr) return -4;
  if (scale_denom != 1 && scale_denom != 2 && scale_denom != 4 &&
      scale_denom != 8)
    return -5;

  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  jerr.pub.emit_message = emit_nothing;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = 1;
  cinfo.scale_denom = static_cast<unsigned int>(scale_denom);
  jpeg_calc_output_dimensions(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  if (out == nullptr) {  // dimension probe only
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  const int64_t need = static_cast<int64_t>(cinfo.output_width) *
                       cinfo.output_height * 3;
  if (out_cap < need) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  jpeg_start_decompress(&cinfo);
  const int64_t stride = static_cast<int64_t>(cinfo.output_width) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<int64_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
