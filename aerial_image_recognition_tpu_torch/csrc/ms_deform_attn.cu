// Multi-scale deformable attention sampling for Hopper (sm_90a): the
// cross-attention of RT-DETR's decoder (Deformable DETR's MSDeformAttn).
//
// Replaces no TPU kernel: the JAX package has no transformer detector. It
// was added with the RT-DETR family, whose decoder samples, in each of its
// six layers, every query's 8 heads x 3 levels x 4 points bilinearly from
// the value map and sums them with softmaxed weights. No single PyTorch
// call computes that; the plain form (ops/ms_deform_attn.py, and
// grid_sample once a level in the benchmark's reference) makes a gathered
// [B, Q, heads, points, D] copy of four corners per level before the sum.
//
// Function: value [B, sum(H_l*W_l), heads, D] f32 (the levels' maps
// flattened row by row, level after level), loc [B, Q, heads, levels,
// points, 2] f32 (x, y in [0, 1] of the level's width and height), w [B, Q,
// heads, levels, points] f32 ->
//   out[b, q, h*D + c] = sum_{l,p} w * bilinear(value_l[b, :, h, c], loc)
// with grid_sample's align_corners=False convention: the sample sits at
// pixel (x*W - 0.5, y*H - 0.5), and a corner outside the map reads zero.
//
// What bounds it on this card: bytes. At the scan's shapes (B=64, 8400
// tokens, Q=300, 8 heads of 32, 3 levels x 4 points) a launch reads 550 MB
// of value map at most and 22 MB of locations and weights, and writes
// 20 MB, against 0.56 GFLOP of blending: about 1 flop a byte, far below the
// card's 20 f32 flops a byte. The samples are scattered, so the design
// makes each read a whole 128-byte line: one warp per (b, q, head), lane c
// holding channel c, so that the four corners of a sample are four
// coalesced 128-byte reads of [token, head, 0..31]. The warp's 12 samples
// (locations and weights, 36 floats) are read once by 12 lanes and handed
// to the others by shuffles; the blend stays in registers and the output is
// written once, coalesced. Nothing is staged in shared memory: a line is
// read by few samples, and those that share one (neighbouring queries, the
// coarse levels) find it in L2.
//
// Numerics: every operation is an IEEE f32 op (the file is built with
// -fmad=false), in the plain version's order within a sample; the sum over
// samples runs level by level, point by point.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kWarps = 8;               // warps a block
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];                // first token of each level
};

__global__ void ms_deform_attn_kernel(const float* __restrict__ value,
                                      const float* __restrict__ loc,
                                      const float* __restrict__ attw,
                                      float* __restrict__ out, int batch,
                                      int tokens, int heads, int dim,
                                      int queries, int levels, int points,
                                      Levels lv) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= (long long)batch * queries * heads) return;
  const int h = (int)(warp % heads);
  const int b = (int)(warp / heads / queries);
  const int n = levels * points;        // <= 32, checked by the launcher

  // this (b, q, h)'s samples: lane s holds sample s
  float sx = 0.f, sy = 0.f, sw = 0.f;
  if (lane < n) {
    sx = loc[(warp * n + lane) * 2];
    sy = loc[(warp * n + lane) * 2 + 1];
    sw = attw[warp * n + lane];
  }
  const size_t col = (size_t)heads * dim;   // one token's stride
  const float* vb = value + (size_t)b * tokens * col + (size_t)h * dim;

  for (int c0 = 0; c0 < dim; c0 += 32) {
    const int c = c0 + lane;
    const bool on = c < dim;
    float acc = 0.f;
    for (int s = 0; s < n; ++s) {
      const float x = __shfl_sync(kFull, sx, s);
      const float y = __shfl_sync(kFull, sy, s);
      const float a = __shfl_sync(kFull, sw, s);
      const int l = s / points;
      const int hl = lv.h[l], wl = lv.w[l];
      const float px = __fsub_rn(__fmul_rn(x, (float)wl), 0.5f);
      const float py = __fsub_rn(__fmul_rn(y, (float)hl), 0.5f);
      const float flx = floorf(px), fly = floorf(py);
      const float fx = __fsub_rn(px, flx), fy = __fsub_rn(py, fly);
      const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
      // far outside (or NaN): no corner is inside, and no int overflows
      const bool near = flx >= -1.f && flx < (float)wl && fly >= -1.f &&
                        fly < (float)hl;
      float sample = 0.f;
      if (near && on) {
        const int x0 = (int)flx, y0 = (int)fly;
        const float* base = vb + (size_t)lv.start[l] * col + c;
        const bool xi0 = x0 >= 0, xi1 = x0 + 1 < wl;
        const bool yi0 = y0 >= 0, yi1 = y0 + 1 < hl;
        const size_t r0 = (size_t)y0 * wl, r1 = r0 + wl;
        if (yi0 && xi0)
          sample = __fadd_rn(sample,
                             __fmul_rn(base[(r0 + x0) * col],
                                       __fmul_rn(gy, gx)));
        if (yi0 && xi1)
          sample = __fadd_rn(sample,
                             __fmul_rn(base[(r0 + x0 + 1) * col],
                                       __fmul_rn(gy, fx)));
        if (yi1 && xi0)
          sample = __fadd_rn(sample,
                             __fmul_rn(base[(r1 + x0) * col],
                                       __fmul_rn(fy, gx)));
        if (yi1 && xi1)
          sample = __fadd_rn(sample,
                             __fmul_rn(base[(r1 + x0 + 1) * col],
                                       __fmul_rn(fy, fx)));
      }
      acc = __fadd_rn(acc, __fmul_rn(sample, a));
    }
    if (on) out[warp * dim + c] = acc;
  }
}

// Makes `device` the calling thread's current device for the life of the
// object and restores the device that was current before, on every return
// path: a launch changes no state of the process.
class CurrentDevice {
 public:
  explicit CurrentDevice(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      changed_ = err_ == cudaSuccess;
    }
  }
  ~CurrentDevice() {
    if (changed_) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool changed_ = false;
  cudaError_t err_;
};

}  // namespace

// C entry point (ctypes). Pointers are device pointers except `hw`, a host
// array of (H_l, W_l) for each level; stream is a cudaStream_t. Returns
// cudaGetLastError() after the launch (0 = success). The calling thread's
// current device is the same after the call as before.
extern "C" int ms_deform_attn_launch(const float* value, const float* loc,
                                     const float* attw, float* out, int batch,
                                     int tokens, int heads, int dim,
                                     int queries, int levels, int points,
                                     const int* hw, int device,
                                     void* stream) {
  const CurrentDevice on(device);
  if (on.error() != cudaSuccess) return (int)on.error();
  if (levels < 1 || levels > kMaxLevels || points < 1 ||
      levels * points > 32 || dim < 1 || heads < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  int start = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.h[l] = l < levels ? hw[2 * l] : 0;
    lv.w[l] = l < levels ? hw[2 * l + 1] : 0;
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != tokens) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)batch * queries * heads;
  if (warps == 0) return 0;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  ms_deform_attn_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                          (cudaStream_t)stream>>>(
      value, loc, attw, out, batch, tokens, heads, dim, queries, levels,
      points, lv);
  return (int)cudaGetLastError();
}
