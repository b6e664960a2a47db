// Requantizing epilogue of the int8 convolutions for Hopper (sm_90a).
//
// Port-only kernel: it replaces no Pallas TPU kernel. The reference writes
// this chain as jnp operations after lax.conv_general_dilated
// (aerial_image_recognition_tpu/models/int8.py, _Run.conv and _stems_int8)
// and XLA fuses them into the convolution; eager PyTorch would run it as
// seven elementwise passes over an s32/f32 [rows, cols] tensor. Same
// function:
//   t = float(r) * m[c] + b[c]            (a multiply, then an add)
//   y = leaky_relu(t, 0.1) | relu(t) | silu(t) * inv
//   out = int8(clamp(round_half_even(y), -127, 127))
// r [rows, cols] int32 (the s8 x s8 -> s32 sums, channels last), m and b
// [cols] f32, out [rows, cols] int8.
//
// Border mode (the fully-int8 quad stem's first conv, whose uint8 input is
// shifted to int8 so that its zero padding stands for pixel 128): the rows
// are the [B, h, w] positions of an NHWC map, and a per-channel term that
// depends on whether the row's position lies in the map's first row (y0)
// or first column (x0) enters between the product and the bias:
//   corr = ((S[c] - y0*Su0[c]) - x0*Sv0[c]) + (y0*x0)*Suv[c]
//   t = (float(r) * m[c] + corr) + b[c]
// corr [4, cols] f32 holds S, Su0, Sv0, Suv; y0 and x0 are 0 or 1.
//
// What bounds it: bytes. 4 bytes in and 1 byte out per element against
// about six operations (eleven in border mode). Design: one pass; a thread
// takes four neighbouring channels of one row (one 16-byte load, one 4-byte
// store, the warp's accesses contiguous), in a grid-stride loop; m, b and
// corr are read through the read-only cache as float4. The row length must
// be a multiple of four and the pointers 16-byte aligned (every channel
// count of the trunks is a multiple of 32, and the buffers are fresh
// allocations); anything else is refused with cudaErrorInvalidValue.
//
// Numerics match the plain version bit for bit for leaky and relu: every
// multiply, add and subtract is an explicitly rounded IEEE operation in the
// reference's order (no FMA contraction; the file is also built with
// -fmad=false), rounding is to nearest even (__float2int_rn saturates, the
// clamp follows). silu uses expf and an IEEE division as torch.sigmoid
// does.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kActLeaky = 0, kActRelu = 1;   // 2: silu

__device__ __forceinline__ int8_t activate(float t, float inv, int act) {
  if (act == kActLeaky) {
    t = t > 0.f ? t : __fmul_rn(t, 0.1f);
  } else if (act == kActRelu) {
    t = t > 0.f ? t : 0.f;
  } else {
    const float s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-t)));
    t = __fmul_rn(__fmul_rn(t, s), inv);
  }
  const int q = __float2int_rn(t);
  return (int8_t)min(max(q, -127), 127);
}

__device__ __forceinline__ int8_t requant(int32_t r, float m, float b,
                                          float inv, int act) {
  return activate(__fadd_rn(__fmul_rn((float)r, m), b), inv, act);
}

// The border term of one channel, in the reference's order.
__device__ __forceinline__ float border(float s, float su0, float sv0,
                                        float suv, float y0, float x0) {
  return __fadd_rn(__fsub_rn(__fsub_rn(s, __fmul_rn(y0, su0)),
                             __fmul_rn(x0, sv0)),
                   __fmul_rn(__fmul_rn(y0, x0), suv));
}

__device__ __forceinline__ int8_t requant_border(int32_t r, float m, float b,
                                                 float corr, float inv,
                                                 int act) {
  return activate(__fadd_rn(__fadd_rn(__fmul_rn((float)r, m), corr), b),
                  inv, act);
}

__global__ void int8_epilogue_vec4_kernel(const int4* __restrict__ r,
                                          const float4* __restrict__ m,
                                          const float4* __restrict__ b,
                                          float inv, int act, long long n4,
                                          int cols4,
                                          char4* __restrict__ out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += step) {
    const int c = (int)(i % cols4);
    const int4 v = r[i];
    const float4 mm = __ldg(m + c), bb = __ldg(b + c);
    char4 o;
    o.x = requant(v.x, mm.x, bb.x, inv, act);
    o.y = requant(v.y, mm.y, bb.y, inv, act);
    o.z = requant(v.z, mm.z, bb.z, inv, act);
    o.w = requant(v.w, mm.w, bb.w, inv, act);
    out[i] = o;
  }
}

// Border mode: the row i / cols4 is the position (y, x) = ((row / w) % h,
// row % w) of an NHWC [B, h, w, cols] map.
__global__ void int8_epilogue_border_vec4_kernel(
    const int4* __restrict__ r, const float4* __restrict__ m,
    const float4* __restrict__ b, const float4* __restrict__ corr, int h,
    int w, float inv, int act, long long n4, int cols4,
    char4* __restrict__ out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += step) {
    const long long row = i / cols4;
    const int c = (int)(i - row * cols4);
    const long long yx = row % ((long long)h * w);
    const float y0 = yx < w ? 1.f : 0.f;
    const float x0 = yx % w == 0 ? 1.f : 0.f;
    const int4 v = r[i];
    const float4 mm = __ldg(m + c), bb = __ldg(b + c);
    const float4 s = __ldg(corr + c), su0 = __ldg(corr + cols4 + c);
    const float4 sv0 = __ldg(corr + 2 * cols4 + c);
    const float4 suv = __ldg(corr + 3 * cols4 + c);
    char4 o;
    o.x = requant_border(v.x, mm.x, bb.x,
                         border(s.x, su0.x, sv0.x, suv.x, y0, x0), inv, act);
    o.y = requant_border(v.y, mm.y, bb.y,
                         border(s.y, su0.y, sv0.y, suv.y, y0, x0), inv, act);
    o.z = requant_border(v.z, mm.z, bb.z,
                         border(s.z, su0.z, sv0.z, suv.z, y0, x0), inv, act);
    o.w = requant_border(v.w, mm.w, bb.w,
                         border(s.w, su0.w, sv0.w, suv.w, y0, x0), inv, act);
    out[i] = o;
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

// C entry point (ctypes). Pointers are device pointers; stream is a
// cudaStream_t; act is 0 leaky, 1 relu, 2 silu (inv is read by silu only).
// corr is null, or the border mode's [4, cols] terms, and then rows counts
// the positions of [B, h, w] maps (a multiple of h * w). cols must be a
// multiple of 4 and r, m, b, corr 16-byte aligned. Returns the CUDA error of
// the launch (0 = success). The calling thread's current device is the same
// after the call as before.
extern "C" int int8_epilogue_launch(const int32_t* r, const float* m,
                                    const float* b, const float* corr, int h,
                                    int w, float inv, int act,
                                    long long rows, int cols, int8_t* out,
                                    int device, void* stream) {
  const CurrentDevice on(device);
  if (on.error() != cudaSuccess) return (int)on.error();
  if (rows < 0 || cols < 1 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  if (corr != nullptr &&
      (h < 1 || w < 1 || rows % ((long long)h * w) != 0 ||
       (uintptr_t)corr % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const long long n = rows * cols;
  // enough blocks to fill the card several times over; the loop takes the rest
  const long long kMaxBlocks = 132LL * 32;
  const bool aligned = (uintptr_t)r % 16 == 0 && (uintptr_t)m % 16 == 0 &&
                       (uintptr_t)b % 16 == 0 && (uintptr_t)out % 4 == 0;
  if (cols % 4 != 0 || !aligned) return (int)cudaErrorInvalidValue;
  const long long n4 = n / 4;
  const int blocks = (int)std::min((n4 + kThreads - 1) / kThreads, kMaxBlocks);
  if (corr == nullptr) {
    int8_epilogue_vec4_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int4*)r, (const float4*)m, (const float4*)b, inv, act, n4,
        cols / 4, (char4*)out);
  } else {
    int8_epilogue_border_vec4_kernel<<<blocks, kThreads, 0,
                                       (cudaStream_t)stream>>>(
        (const int4*)r, (const float4*)m, (const float4*)b,
        (const float4*)corr, h, w, inv, act, n4, cols / 4, (char4*)out);
  }
  return (int)cudaGetLastError();
}
