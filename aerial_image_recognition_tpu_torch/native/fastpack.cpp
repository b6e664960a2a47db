// fastpack — the quad stem's host relayout for the ingest plane.
//
// pack_quad_u8 of native/fastdecode.cpp, in a source of its own that needs
// no libjpeg, so that the packer builds wherever g++ does. Built at first
// use by aerial_image_recognition_tpu_torch/utils/native.py (g++ -O3
// -ffp-contract=off -shared -fPIC, into the repository's build/) and
// called via ctypes, which releases the GIL for the call: packing scales
// across the ingest threads.

#include <cstdint>

extern "C" {

// Quad-layout pack (ops/quadstem.py host order (e, dy, f, dx, c)):
//   out[R, C, ((e*2+dy)*4 + (f*2+dx))*3 + c] = px[4R+2e+dy, 4C+2f+dx, c]
// For input row y the channel-group index is exactly y%4 and each
// 4-pixel quad is a contiguous 12-byte run, so the whole relayout is
// h * (w/4) small memcpys. h and w must be %4 == 0.
int pack_quad_u8(const uint8_t* px, int64_t h, int64_t w, uint8_t* out) {
  if ((h | w) & 3) return -1;
  const int64_t wq = w / 4;
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* src = px + y * w * 3;
    uint8_t* dst = out + (y / 4) * wq * 48 + (y & 3) * 12;
    for (int64_t c = 0; c < wq; ++c) {
      __builtin_memcpy(dst, src, 12);
      src += 12;
      dst += 48;
    }
  }
  return 0;
}

}  // extern "C"
