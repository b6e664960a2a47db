// CLAHE LUT application for Hopper (sm_90a), all clip variants in one pass.
//
// Replaces the Pallas TPU kernel aerial_image_recognition_tpu/ops/
// clahe_pallas.py:apply_luts_pallas (_apply_kernel). Same function: for
// each pixel (b, y, x) with value v in 0..255 and each clip variant vv,
//   out[vv,b,y,x] = (1-wy)*((1-wx)*p00 + wx*p01) + wy*((1-wx)*p10 + wx*p11)
// where pYX = luts[b, yY, xX, vv, v] are the LUT entries of the four tiles
// whose centres surround the pixel, and wy[y], wx[x] are the fractional
// bilinear weights toward the next tile. LUTs [B,gh,gw,V,256] f32, pixels
// [B,H,W] int32, out [V,B,H,W] f32 (before rounding to levels).
//
// The TPU kernel turns the lookup into a one-hot x LUT matrix product,
// because a TPU gathers badly. A GPU gathers well from shared memory, so
// here the lookup is a lookup.
//
// What bounds it: bytes. Per pixel 4 bytes come in and 4*V go out, against
// 11*V f32 operations; the LUTs (B*gh*gw*V KB) are read a few times but
// stay in L2. Design: the pixels that share their four corner tiles form a
// rectangle ("cell": rows with the same lower tile row y0, columns with the
// same lower tile column x0; the wrapper passes the cell boundaries, which
// it takes from the same f32 arithmetic as the weights, so ragged
// geometries need no special case and no division happens here). One
// thread block per (cell, image): it stages the cell's 4*V LUTs in shared
// memory, interleaved so that one 16-byte read fetches the four corners of
// one (variant, value), then its threads sweep the cell row by row, 32
// neighbouring columns per warp, so the pixel reads and the V output writes
// are coalesced.
//
// Numerics match the plain version bit for bit: every operation of the
// blend is an explicitly rounded IEEE op in the reference's nesting (no FMA
// contraction; the file is also built with -fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kMaxSharedBytes = 227 * 1024;

__global__ void clahe_apply_kernel(const float* __restrict__ luts,
                                   const int32_t* __restrict__ l8,
                                   const float* __restrict__ wy,
                                   const float* __restrict__ wx,
                                   const int32_t* __restrict__ ystart,
                                   const int32_t* __restrict__ xstart,
                                   int batch, int h, int w, int gh, int gw,
                                   int nv, float* __restrict__ out) {
  extern __shared__ float4 s_lut[];          // [nv*256] (p00, p01, p10, p11)

  const int x0 = blockIdx.x, y0 = blockIdx.y, b = blockIdx.z;
  const int ys = ystart[y0], ye = ystart[y0 + 1];
  const int xs = xstart[x0], xe = xstart[x0 + 1];
  if (ys >= ye || xs >= xe) return;          // an empty cell (ragged edge)
  const int y1 = min(y0 + 1, gh - 1), x1 = min(x0 + 1, gw - 1);

  // stage the four corner LUTs of all variants: coalesced global reads
  const int n = nv * 256;
  const size_t tile = (size_t)n;
  const float* l00 = luts + (((size_t)b * gh + y0) * gw + x0) * tile;
  const float* l01 = luts + (((size_t)b * gh + y0) * gw + x1) * tile;
  const float* l10 = luts + (((size_t)b * gh + y1) * gw + x0) * tile;
  const float* l11 = luts + (((size_t)b * gh + y1) * gw + x1) * tile;
  const int t = threadIdx.y * kThreadsX + threadIdx.x;
  for (int i = t; i < n; i += kThreadsX * kThreadsY) {
    s_lut[i] = make_float4(l00[i], l01[i], l10[i], l11[i]);
  }
  __syncthreads();

  const size_t plane = (size_t)h * w;
  const size_t vstride = (size_t)batch * plane;
  for (int y = ys + threadIdx.y; y < ye; y += kThreadsY) {
    const float fy = wy[y];
    const float gy = __fsub_rn(1.f, fy);
    const size_t row = (size_t)b * plane + (size_t)y * w;
    for (int x = xs + threadIdx.x; x < xe; x += kThreadsX) {
      const float fx = wx[x];
      const float gx = __fsub_rn(1.f, fx);
      // values outside 0..255 are clamped: never read outside the LUT
      const int v = min(max(l8[row + x], 0), 255);
      for (int vv = 0; vv < nv; ++vv) {
        const float4 p = s_lut[vv * 256 + v];
        const float top = __fadd_rn(__fmul_rn(gx, p.x), __fmul_rn(fx, p.y));
        const float bot = __fadd_rn(__fmul_rn(gx, p.z), __fmul_rn(fx, p.w));
        out[(size_t)vv * vstride + row + x] =
            __fadd_rn(__fmul_rn(gy, top), __fmul_rn(fy, bot));
      }
    }
  }
}

}  // namespace

// C entry point (ctypes). Pointers are device pointers; stream is a
// cudaStream_t. ystart [gh+1] and xstart [gw+1] are the cell boundaries:
// rows ystart[k]..ystart[k+1] have lower tile row k. Returns the CUDA error
// of the launch (0 = success).
extern "C" int clahe_apply_launch(const float* luts, const int32_t* l8,
                                  const float* wy, const float* wx,
                                  const int32_t* ystart,
                                  const int32_t* xstart, int batch, int h,
                                  int w, int gh, int gw, int nv, float* out,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (gh < 1 || gw < 1 || nv < 1 || gh > 65535 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || h == 0 || w == 0) return 0;
  const size_t shared = (size_t)nv * 256 * sizeof(float4);
  if (shared > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(clahe_apply_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(gw, gh, batch);
  const dim3 block(kThreadsX, kThreadsY, 1);
  clahe_apply_kernel<<<grid, block, shared, (cudaStream_t)stream>>>(
      luts, l8, wy, wx, ystart, xstart, batch, h, w, gh, gw, nv, out);
  return (int)cudaGetLastError();
}
