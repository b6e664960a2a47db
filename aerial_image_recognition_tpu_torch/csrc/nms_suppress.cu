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
// What bounds it on this card: not bytes (~0.4 MB per batch-64 call) and
// not arithmetic (~16 M flops), but the chain of dependent picks: a pick
// cannot be chosen before the picks ahead of it have knocked their
// neighbours out. With one block-wide round per pick (a block-wide argmax,
// the pick's IoU row with its IEEE division, two barriers) every link of
// that chain cost 0.67 us. The design below leaves a find-first-set and a
// warp ballot in a link, batches the IoUs, which then pipeline, puts one
// barrier behind 32 candidates instead of two behind every pick, and stops
// when no candidate is left.
//
// Design: one thread block per image (blocks run in parallel over the
// batch), one thread per candidate. Thread j keeps box j's corners, area
// and class in registers; the other boxes are read from shared memory. The
// TPU kernel's K x K IoU matrix is never built: a thread tests its box
// against the 32 candidates of its own chunk and, later, against the picks
// made before it.
//
//   * Priority order. batched_nms hands the candidates over sorted: a
//     stable descending sort, then masking to -1, so every score row is
//     non-increasing and >= -1. For such a row "argmax of the available
//     scores, ties to the lowest index" is "the first candidate not yet
//     knocked out", so no score is ever compared: the pick is the lowest
//     set bit of an alive mask, and a candidate can only be knocked out by
//     one before it. The alive candidates (s > -1) are a prefix.
//   * The sweep goes chunk by chunk (warp w owns candidates 32w..32w+31),
//     one step and one __syncthreads per chunk, not per pick. Before the
//     first step every thread computes the 32 bits that say which members
//     of its own chunk knock it out; these depend on no pick. In step w,
//     warp w settles its chunk alone: its alive lanes are a ballot word;
//     the lowest set bit is the next pick; it leaves the word together with
//     every lane it knocks out (a second ballot, over those bits), until
//     the word is empty or max_det picks are made. The picks go to a list
//     in shared memory; after the barrier every alive candidate of a later
//     chunk tests its box against the new picks, and only against those: a
//     tile with 20 objects costs a thread some 20 tests, however many
//     near-duplicates surround them.
//   * Batched tests. Both kinds of test run in two passes: a branch-free
//     one that only asks whether two boxes intersect at all (independent
//     loads and a dozen ALU ops, so they pipeline), then the division for
//     the few pairs that do. Where boxes do not intersect the reference's
//     IoU is exactly 0, so nothing is lost.
//   * Early exit. The steps end with the last chunk that had an alive
//     candidate, or when max_det picks are made. Every remaining greedy
//     round would pick index 0 with conf -1 (argmax of all -1), so the
//     picks and that tail are written in one parallel pass, one slot per
//     thread, coalesced.
//   * The general path. The block votes (__syncthreads_and) whether its
//     score row is non-increasing and >= -1 (false for NaN). If not (a
//     caller that did not preselect, scores below -1), the argument above
//     does not hold (a knocked-out candidate is set to -1, which is "last"
//     only if nothing lies below -1), and the block runs one explicit
//     round per slot instead: block-wide argmax over (score desc, index
//     asc), then the pick's IoU row. Both paths give the reference's picks
//     bit for bit; the vote only chooses the faster one where it is valid.
//
// Nothing here is a matrix product or a bulk copy, so wgmma, TMA and
// thread-block clusters have no use in this kernel: a block's whole input
// is 7 KB and is read once.
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
constexpr int kMaxWarps = kMaxK / 32;
constexpr unsigned kFull = 0xffffffffu;

// One image's candidates in shared memory: corners (x1, y1, x2, y2), area,
// class, score.
struct Tile {
  float4 box[kMaxK];
  float area[kMaxK];
  float score[kMaxK];
  int32_t cls[kMaxK];
};

// Intersection area of two corner boxes, the reference's operation order.
__device__ __forceinline__ float intersection(const float4& q,
                                              const float4& c) {
  const float ix = fmaxf(0.f, __fsub_rn(fminf(q.z, c.z), fmaxf(q.x, c.x)));
  const float iy = fmaxf(0.f, __fsub_rn(fminf(q.w, c.w), fmaxf(q.y, c.y)));
  return __fmul_rn(ix, iy);
}

// Does the box (c, area, cls) overlap candidate p of the tile by more than
// the threshold? Each op rounded as in the reference. Where the boxes do
// not intersect, or their classes differ in class-aware mode, the
// reference's IoU is 0 (0 / x with x >= 1e-9, or the mask), so the division
// is skipped: most pairs end here.
__device__ __forceinline__ bool knocked_out(const Tile& t, int p,
                                            const float4& c, float area,
                                            int32_t cls, float iou_threshold,
                                            int class_aware) {
  const float inter = intersection(t.box[p], c);
  float iou = 0.f;
  if (inter != 0.f && !(class_aware && t.cls[p] != cls)) {
    const float uni = __fsub_rn(__fadd_rn(t.area[p], area), inter);
    iou = __fdiv_rn(inter, fmaxf(uni, 1e-9f));
  }
  return iou > iou_threshold;
}

// The box (c, area, cls) against the `members` candidates from `first` on:
// bit m of the result says that candidate first + m knocks the box out.
// Two passes: a branch-free one over all members that only asks whether the
// boxes intersect (independent loads and a dozen ALU ops each, so they
// pipeline), then the full test for the few that do.
__device__ __forceinline__ unsigned chunk_tests(const Tile& t, int first,
                                                int members, const float4& c,
                                                float area, int32_t cls,
                                                float iou_threshold,
                                                int class_aware) {
  unsigned touch = 0u;
#pragma unroll 8
  for (int m = 0; m < members; ++m)
    touch |= (intersection(t.box[first + m], c) != 0.f ? 1u : 0u) << m;
  // an IoU of 0 exceeds a negative threshold: then every member that does
  // not touch the box knocks it out as well
  const unsigned all = members == 32 ? kFull : (1u << members) - 1u;
  unsigned mine = 0.f > iou_threshold ? all & ~touch : 0u;
  for (; touch != 0u; touch &= touch - 1u) {
    const int m = __ffs(touch) - 1;
    if (knocked_out(t, first + m, c, area, cls, iou_threshold, class_aware))
      mine |= 1u << m;
  }
  return mine;
}

// Does any of the picks[from..to) (at most 32) knock the box out? The same
// two passes.
__device__ __forceinline__ bool knocked_by_picks(const Tile& t,
                                                 const int32_t* picks,
                                                 int from, int to,
                                                 const float4& c, float area,
                                                 int32_t cls,
                                                 float iou_threshold,
                                                 int class_aware) {
  unsigned touch = 0u;
#pragma unroll 4
  for (int i = from; i < to; ++i)
    touch |= (intersection(t.box[picks[i]], c) != 0.f ? 1u : 0u)
             << (i - from);
  const int count = to - from;
  const unsigned all = count == 32 ? kFull : (1u << count) - 1u;
  if (0.f > iou_threshold && touch != all) return true;
  for (; touch != 0u; touch &= touch - 1u)
    if (knocked_out(t, picks[from + __ffs(touch) - 1], c, area, cls,
                    iou_threshold, class_aware))
      return true;
  return false;
}

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

// The general path: max_det explicit rounds for any score row. t.score
// holds the available scores and is overwritten.
__device__ void explicit_rounds(Tile& t, bool live, const float4& c,
                                float area, int32_t cls, int max_det,
                                float iou_threshold, int class_aware,
                                int32_t* out_idx, float* out_conf,
                                int32_t* out_cls) {
  __shared__ float s_warp_v[kMaxWarps];
  __shared__ int s_warp_i[kMaxWarps];
  __shared__ int s_pick;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int d = 0; d < max_det; ++d) {
    // 1. block argmax: warp shuffles, then one warp over the warp winners
    float v = live ? t.score[j] : -INFINITY;
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
        out_idx[d] = i;
        out_conf[d] = v;
        out_cls[d] = t.cls[i];
      }
    }
    __syncthreads();
    // 3. every thread tests its box against the pick and knocks itself out
    if (live) {
      const int p = s_pick;
      if (knocked_out(t, p, c, area, cls, iou_threshold, class_aware) ||
          j == p)
        t.score[j] = -1.f;
    }
    // the next round's shuffles read t.score and thread 0 rewrites
    // s_warp_*/s_pick only after its first barrier, which every thread
    // reaches after its reads of this round
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
  __shared__ Tile t;
  __shared__ unsigned s_rows[kMaxWarps];   // alive at the start, per chunk
  __shared__ int s_n[kMaxWarps];           // picks up to and with each chunk
  __shared__ int32_t s_picks[kMaxK];       // in order; at most min(K, max_det)

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool live = j < k;
  const float* row = scores + (size_t)b * k;
  out_idx += (size_t)b * max_det;
  out_conf += (size_t)b * max_det;
  out_cls += (size_t)b * max_det;

  // 1. load: box j in registers and in shared memory
  float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
  float area = 0.f, s = -1.f;
  int32_t cls = 0;
  bool in_order = true;
  if (live) {
    const float* bx = boxes_t + (size_t)b * 4 * k;
    const float cx = bx[j], cy = bx[k + j];
    const float hw = __fmul_rn(bx[2 * k + j], 0.5f);
    const float hh = __fmul_rn(bx[3 * k + j], 0.5f);
    c.x = __fsub_rn(cx, hw);
    c.z = __fadd_rn(cx, hw);
    c.y = __fsub_rn(cy, hh);
    c.w = __fadd_rn(cy, hh);
    area = __fmul_rn(__fsub_rn(c.z, c.x), __fsub_rn(c.w, c.y));
    cls = classes[(size_t)b * k + j];
    s = row[j];
    t.box[j] = c;
    t.area[j] = area;
    t.cls[j] = cls;
    t.score[j] = s;
    // 2. this thread's part of the vote (both tests are false for NaN)
    in_order = s >= -1.0f && (j + 1 == k || s >= row[j + 1]);
  }
  bool alive = live && s > -1.0f;
  const unsigned word = __ballot_sync(kFull, alive);
  if (lane == 0) s_rows[warp] = word;
  // the vote is also the barrier that publishes the tile and the mask
  if (!__syncthreads_and(in_order)) {
    // 4. the general path
    explicit_rounds(t, live, c, area, cls, max_det, iou_threshold,
                    class_aware, out_idx, out_conf, out_cls);
    return;
  }

  // 3. the sweep, one chunk (a warp's 32 candidates) per step
  // bit m: member m of this candidate's own chunk knocks it out. These
  // tests depend on no pick, so every warp makes its own before the chain
  // of steps begins.
  const unsigned mine =
      alive ? chunk_tests(t, warp << 5, __popc(word), c, area, cls,
                          iou_threshold, class_aware) : 0u;
  int n = 0;                                   // picks so far
  for (int step = 0; step < nwarps; ++step) {
    if (s_rows[step] == 0u) break;   // in priority order the alive
                                     // candidates are a prefix: none is left
    const int before = n;
    if (warp == step) {
      // 3a. the chunk's own warp settles it with ballots alone: the pick is
      // the lowest lane left; it leaves, and so does every lane it knocks
      unsigned left = __ballot_sync(kFull, alive);
      while (left != 0u && n < max_det) {
        const int m = __ffs(left) - 1;
        if (lane == 0) s_picks[n] = (step << 5) + m;
        ++n;
        const unsigned out = __ballot_sync(kFull, (mine >> m) & 1u);
        left &= ~(out | (1u << m));
      }
      if (lane == 0) s_n[step] = n;
    }
    __syncthreads();             // the one barrier of a step
    // 3b. every later candidate tests its box against this chunk's picks
    n = s_n[step];
    if (n >= max_det) break;
    if (warp > step && alive)
      alive = !knocked_by_picks(t, s_picks, before, n, c, area, cls,
                                iou_threshold, class_aware);
  }
  // picks and tail together, one slot per thread: a slot past the last pick
  // holds what a greedy round over all -1 scores writes, (0, -1, cls[0])
  for (int d = j; d < max_det; d += blockDim.x) {
    const int p = d < n ? s_picks[d] : 0;
    out_idx[d] = p;
    out_conf[d] = d < n ? t.score[p] : -1.0f;
    out_cls[d] = t.cls[p];
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
