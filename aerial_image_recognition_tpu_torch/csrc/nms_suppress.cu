// Greedy NMS suppression tail for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel aerial_image_recognition_tpu/ops/
// pallas_kernels.py:nms_suppress_pallas (_nms_kernel). Same function: per
// image, K preselected cxcywh boxes (coordinate-major [B,4,K]), scores with
// -1 marking candidates below the confidence threshold, int32 classes →
// max_det greedy rounds. Each round picks the argmax of the available
// scores (ties, including the all -1 case, go to the lowest index), writes
// idx/conf/cls, and sets to -1 the pick and every box whose IoU with it
// exceeds the threshold (cross-class IoU counts as 0 when class-aware).
//
// What bounds it: not bytes (~0.4 MB per batch-64 call) and not arithmetic
// (~16 M flops), but the chain of max_det dependent rounds, each a
// block-wide argmax. Design: one thread block per image (blocks run in
// parallel over the batch), one thread per candidate. Thread j keeps box
// j's corners, area and class in registers and its available score in
// shared memory; the pick's box is read back from shared memory. The TPU
// kernel built the K×K IoU matrix in VMEM; here each round computes only
// the pick's row on the fly (max_det < K rounds need fewer IoUs than the
// full matrix, and nothing but the available scores is carried across
// rounds), so the kernel needs ~7·K words of shared memory.
//
// Numerics match the reference bit for bit: every IoU operation is an
// explicitly rounded IEEE op (no FMA contraction; the file is also built
// with -fmad=false), in the reference's order: corners as c -/+ w*0.5,
// area = (x2-x1)*(y2-y1), iou = inter / max((area_pick + area_j) - inter,
// 1e-9), compared as iou > thr in f32.
//
// Unlike the TPU kernel, which writes class 0 in class-agnostic mode, this
// kernel always writes the picked box's class (as _nms_single does).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 1024;
constexpr unsigned kFull = 0xffffffffu;

// (score desc, index asc): true when (v2, i2) ranks before (v1, i1)
__device__ __forceinline__ bool better(float v2, int i2, float v1, int i1) {
  return v2 > v1 || (v2 == v1 && i2 < i1);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, v, off);
    const int oi = __shfl_down_sync(kFull, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void nms_suppress_kernel(const float* __restrict__ boxes_t,
                                    const float* __restrict__ scores,
                                    const int32_t* __restrict__ classes,
                                    int k, int max_det, float iou_threshold,
                                    int class_aware,
                                    int32_t* __restrict__ out_idx,
                                    float* __restrict__ out_conf,
                                    int32_t* __restrict__ out_cls) {
  __shared__ float s_avail[kMaxK];
  __shared__ float s_x1[kMaxK], s_y1[kMaxK], s_x2[kMaxK], s_y2[kMaxK];
  __shared__ float s_area[kMaxK];
  __shared__ int32_t s_cls[kMaxK];
  __shared__ float s_warp_v[32];
  __shared__ int s_warp_i[32];
  __shared__ int s_pick;

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool live = j < k;

  float x1 = 0.f, y1 = 0.f, x2 = 0.f, y2 = 0.f, area = 0.f;
  int32_t cls = 0;
  if (live) {
    const float* bx = boxes_t + (size_t)b * 4 * k;
    const float cx = bx[j], cy = bx[k + j];
    const float hw = __fmul_rn(bx[2 * k + j], 0.5f);
    const float hh = __fmul_rn(bx[3 * k + j], 0.5f);
    x1 = __fsub_rn(cx, hw);
    x2 = __fadd_rn(cx, hw);
    y1 = __fsub_rn(cy, hh);
    y2 = __fadd_rn(cy, hh);
    area = __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
    cls = classes[(size_t)b * k + j];
    s_x1[j] = x1;
    s_y1[j] = y1;
    s_x2[j] = x2;
    s_y2[j] = y2;
    s_area[j] = area;
    s_cls[j] = cls;
    s_avail[j] = scores[(size_t)b * k + j];
  }

  for (int d = 0; d < max_det; ++d) {
    // 1. block argmax: warp shuffles, then one warp over the warp winners
    float v = live ? s_avail[j] : -INFINITY;
    int i = live ? j : INT32_MAX;
    warp_argmax(v, i);
    if (lane == 0) {
      s_warp_v[warp] = v;
      s_warp_i[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < nwarps ? s_warp_v[lane] : -INFINITY;
      i = lane < nwarps ? s_warp_i[lane] : INT32_MAX;
      warp_argmax(v, i);
      // 2. thread 0 records the pick
      if (lane == 0) {
        s_pick = i;
        const size_t o = (size_t)b * max_det + d;
        out_idx[o] = i;
        out_conf[o] = v;
        out_cls[o] = s_cls[i];
      }
    }
    __syncthreads();
    // 3. every thread tests its box against the pick and knocks itself out
    if (live) {
      const int p = s_pick;
      const float ix = fmaxf(0.f, __fsub_rn(fminf(s_x2[p], x2),
                                            fmaxf(s_x1[p], x1)));
      const float iy = fmaxf(0.f, __fsub_rn(fminf(s_y2[p], y2),
                                            fmaxf(s_y1[p], y1)));
      const float inter = __fmul_rn(ix, iy);
      const float uni = __fsub_rn(__fadd_rn(s_area[p], area), inter);
      float iou = __fdiv_rn(inter, fmaxf(uni, 1e-9f));
      if (class_aware && s_cls[p] != cls) iou = 0.f;
      if (iou > iou_threshold || j == p) s_avail[j] = -1.f;
    }
    // the next round's shuffles read s_avail and thread 0 rewrites
    // s_warp_*/s_pick only after its first barrier, which every thread
    // reaches after its reads of this round
  }
}

}  // namespace

// C entry point (ctypes). Pointers are device pointers; stream is a
// cudaStream_t. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int nms_suppress_launch(const float* boxes_t, const float* scores,
                                   const int32_t* classes, int batch, int k,
                                   int max_det, float iou_threshold,
                                   int class_aware, int32_t* out_idx,
                                   float* out_conf, int32_t* out_cls,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (batch == 0 || max_det == 0) return 0;
  const int threads = (k + 31) / 32 * 32;
  nms_suppress_kernel<<<batch, threads, 0, (cudaStream_t)stream>>>(
      boxes_t, scores, classes, k, max_det, iou_threshold, class_aware,
      out_idx, out_conf, out_cls);
  return (int)cudaGetLastError();
}
