// Requantizing epilogue of the int8 convolutions for Hopper (sm_90a).
//
// Port-only kernel: it replaces no Pallas TPU kernel. The reference writes
// this chain as jnp operations after lax.conv_general_dilated
// (aerial_image_recognition_tpu/models/int8.py, _Run.conv) and XLA fuses
// them into the convolution; eager PyTorch would run it as seven
// elementwise passes over an s32/f32 [rows, cols] tensor. Same function:
//   t = float(r) * m[c] + b[c]            (a multiply, then an add)
//   y = leaky_relu(t, 0.1) | relu(t) | silu(t) * inv
//   out = int8(clamp(round_half_even(y), -127, 127))
// r [rows, cols] int32 (the s8 x s8 -> s32 sums, channels last), m and b
// [cols] f32, out [rows, cols] int8.
//
// What bounds it: bytes. 4 bytes in and 1 byte out per element against
// about six operations. Design: one pass; a thread takes four neighbouring
// channels of one row (one 16-byte load, one 4-byte store, the warp's
// accesses contiguous), in a grid-stride loop; m and b are read through the
// read-only cache as float4. The row length must be a multiple of four and
// the pointers 16-byte aligned (every channel count of the trunks is a
// multiple of 32, and the buffers are fresh allocations); anything else is
// refused with cudaErrorInvalidValue.
//
// Numerics match the plain version bit for bit for leaky and relu: the
// multiply and the add are explicitly rounded IEEE operations (no FMA
// contraction; the file is also built with -fmad=false), rounding is to
// nearest even (__float2int_rn saturates, the clamp follows). silu uses
// expf and an IEEE division as torch.sigmoid does.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kActLeaky = 0, kActRelu = 1;   // 2: silu

__device__ __forceinline__ int8_t requant(int32_t r, float m, float b,
                                          float inv, int act) {
  float t = __fadd_rn(__fmul_rn((float)r, m), b);
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

}  // namespace

// C entry point (ctypes). Pointers are device pointers; stream is a
// cudaStream_t; act is 0 leaky, 1 relu, 2 silu (inv is read by silu only).
// cols must be a multiple of 4 and r, m, b 16-byte aligned. Returns the CUDA
// error of the launch (0 = success).
extern "C" int int8_epilogue_launch(const int32_t* r, const float* m,
                                    const float* b, float inv, int act,
                                    long long rows, int cols, int8_t* out,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 0 || cols < 1 || act < 0 || act > 2)
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
  int8_epilogue_vec4_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)r, (const float4*)m, (const float4*)b, inv, act, n4,
      cols / 4, (char4*)out);
  return (int)cudaGetLastError();
}
