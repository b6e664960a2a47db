// The residual join of RT-DETR's ResNet-vd bottleneck for Hopper (sm_90a):
// y <- max(y + s, 0), in place into y, the output of the block's last 1x1
// convolution; s is the shortcut.
//
// Replaces no TPU kernel: the JAX package has no RT-DETR, and XLA fuses
// such an add and ReLU into the ops around it by itself. In PyTorch's eager
// form, F.relu(y + s), the join is two passes and two new maps: at the
// first stage's [64, 256, 160, 160] bf16 that is 839 MB each, and with x,
// y and s five maps are live at once, the forward pass's memory peak.
//
// Function: y and s of one shape and dtype (f32 or bf16), dense in the same
// memory format, so that element i of the flat storage of one pairs with
// element i of the other. The sum in f32, rounded once to y's dtype, then
// max(v, 0) with a NaN kept, as PyTorch's add and clamp_min compute them:
// bit-equal to F.relu(y + s).
//
// What bounds it on this card: bytes. One add and one max an element
// against 6 bytes (bf16) or 12 (f32) read and written. The design moves
// the fewest bytes the join can: one pass, reading y and s once and
// writing y once (3 maps' bytes where add-then-ReLU moves 5), in place, so
// no map is allocated; 16-byte loads and stores (8 bf16 or 4 f32 a
// thread), a grid-stride loop over the flat storage sized to keep every
// SM full, and a scalar tail for a length that is no multiple of the
// vector.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // threads a block
constexpr int kBlocksPerSm = 8;         // 2048 threads: a full SM

__device__ __forceinline__ float relu(float v) {
  return isnan(v) ? v : fmaxf(v, 0.f);
}

__device__ __forceinline__ float join(float y, float s) {
  return relu(__fadd_rn(y, s));
}

__device__ __forceinline__ __nv_bfloat16 join(__nv_bfloat16 y,
                                              __nv_bfloat16 s) {
  const __nv_bfloat16 sum = __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(y), __bfloat162float(s)));
  return __float2bfloat16_rn(relu(__bfloat162float(sum)));
}

// T is float or __nv_bfloat16; kVec elements make 16 bytes.
template <typename T>
__global__ void residual_relu_kernel(T* __restrict__ y,
                                     const T* __restrict__ s,
                                     long long n) {
  constexpr int kVec = 16 / sizeof(T);
  const long long vecs = n / kVec;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint4* yv = reinterpret_cast<uint4*>(y);
  const uint4* sv = reinterpret_cast<const uint4*>(s);
  for (long long i = first; i < vecs; i += stride) {
    uint4 a = yv[i];
    const uint4 b = sv[i];
    T* av = reinterpret_cast<T*>(&a);
    const T* bv = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int k = 0; k < kVec; ++k) av[k] = join(av[k], bv[k]);
    yv[i] = a;
  }
  for (long long i = vecs * kVec + first; i < n; i += stride)
    y[i] = join(y[i], s[i]);
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

template <typename T>
cudaError_t launch(void* y, const void* s, long long n, int device,
                   cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long vecs = n / (16 / (long long)sizeof(T));
  const long long need = (vecs + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSm;
  const unsigned blocks = (unsigned)(need < 1 ? 1 : need < cap ? need : cap);
  residual_relu_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<T*>(y), static_cast<const T*>(s), n);
  return cudaGetLastError();
}

}  // namespace

// C entry point (ctypes). y and s are device pointers, 16-byte aligned, to
// n elements each; dtype 0 is f32, 1 is bf16; stream is a cudaStream_t.
// Returns cudaGetLastError() after the launch (0 = success). The calling
// thread's current device is the same after the call as before.
extern "C" int residual_relu_launch(void* y, const void* s, long long n,
                                    int dtype, int device, void* stream) {
  const CurrentDevice on(device);
  if (on.error() != cudaSuccess) return (int)on.error();
  if (n < 0 || (dtype != 0 && dtype != 1) ||
      (reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(s)) % 16)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0 ? launch<float>(y, s, n, device, st)
                          : launch<__nv_bfloat16>(y, s, n, device, st));
}
