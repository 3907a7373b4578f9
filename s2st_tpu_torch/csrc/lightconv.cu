// Lightweight convolution forward for Hopper (sm_90a): a depthwise K-tap
// convolution over time whose (H, K) weights are softmax-normalised in fp32
// and shared by the C/H channels of each head:
//
//   y[b, t, c] = sum_k softmax(w)[c / (C/H), k] * x[b, t + k - padding_l, c]
//
// with x read as 0 outside [0, T). Replaces the Pallas TPU kernel
// s2st_tpu/ops/conv_kernels.py::lightconv / _lightconv_kernel (:55-94,
// pallas_call at :81), which the LightConv encoder (padding_l = K/2) and the
// teacher-forced decoder (causal, padding_l = K-1) run. Any padding_l in
// [0, K-1] is taken. The softmax is taken in fp32 inside the kernel, the taps
// accumulate in fp32 and the output is written in x's type (fp32 or bf16),
// as the TPU kernel does.
//
// Bound on the card. The function reads x once and writes y once; the
// weights are H*K floats. At the encoder's B=64, T=64, C=512 in bf16 that is
// 8.4 MB, 2.5 us at 3.35 TB/s, against 2*K*B*T*C = 130 MFLOP for K=31, 1.9 us
// of fp32 FMAs at 67 TFLOP/s: bytes bound it, and a launch costs more than
// either at this size.
//
// Design. One block per (128-channel chunk, 32-step time tile, b); one thread
// a channel, so the loads of a time row are contiguous across the warp. Each
// thread stages its channel's tile of x plus the K-1 rows of halo (zero
// outside [0, T)) in fp32 in shared memory, in its own column, and its head's
// K softmaxed weights beside it; every x element is then read from device
// memory (32 + K - 1) / 32 times instead of K times. A thread only ever reads
// its own column, so the block needs no barrier. The sums are scalar fp32
// FMAs, tap by tap in k order, as the plain version adds them.
//
// Plain C interface for ctypes; x, w and y are contiguous, w is fp32 (H, K).
// Returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 128;   // channels a block, one a thread
constexpr int kTimeTile = 32;    // output steps a block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kChannels)
lightconv_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 T* __restrict__ y, int64_t T_len, int64_t C, int H, int K,
                 int padding_l) {
  extern __shared__ float smem[];
  const int rows = kTimeTile + K - 1;
  float* xs = smem;                        // rows x kChannels
  float* ws = smem + rows * kChannels;     // K x kChannels
  const int tid = threadIdx.x;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kChannels + tid;
  if (c >= C) return;
  const int64_t t0 = static_cast<int64_t>(blockIdx.y) * kTimeTile;
  const int64_t b = blockIdx.z;

  // this channel's head row of the weights, softmaxed in fp32
  const float* wr = w + (c / (C / H)) * K;
  float m = wr[0];
  for (int k = 1; k < K; ++k) m = fmaxf(m, wr[k]);
  float s = 0.f;
  for (int k = 0; k < K; ++k) s += expf(wr[k] - m);
  for (int k = 0; k < K; ++k) ws[k * kChannels + tid] = expf(wr[k] - m) / s;

  // x rows t0 - padding_l .. t0 - padding_l + rows - 1 of this channel
  const T* xb = x + b * T_len * C + c;
  for (int r = 0; r < rows; ++r) {
    const int64_t t = t0 - padding_l + r;
    xs[r * kChannels + tid] =
        (t >= 0 && t < T_len) ? to_float(xb[t * C]) : 0.f;
  }

  T* yb = y + b * T_len * C + c;
  const int n_out = T_len - t0 < kTimeTile ? static_cast<int>(T_len - t0)
                                            : kTimeTile;
  for (int i = 0; i < n_out; ++i) {
    float acc = 0.f;
    for (int k = 0; k < K; ++k)
      acc = fmaf(xs[(i + k) * kChannels + tid], ws[k * kChannels + tid], acc);
    store(yb + (t0 + i) * C, acc);
  }
}

template <typename T>
int launch(const void* x, const float* w, void* y, long long B, long long T_len,
           long long C, int H, int K, int padding_l, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(kTimeTile + 2 * K - 1) * kChannels * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lightconv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>((C + kChannels - 1) / kChannels),
            static_cast<unsigned>((T_len + kTimeTile - 1) / kTimeTile),
            static_cast<unsigned>(B));
  lightconv_kernel<T><<<grid, kChannels, smem, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(y), T_len, C, H, K,
      padding_l);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (x and y).
extern "C" int s2st_lightconv_fwd(const void* x, const void* w, void* y,
                                  long long B, long long T_len, long long C,
                                  int H, int K, int padding_l, int dtype,
                                  void* stream) {
  if (B <= 0 || B > 65535 || T_len <= 0 || C <= 0 || H <= 0 || C % H != 0 ||
      K <= 0 || padding_l < 0 || padding_l > K - 1 ||
      (T_len + kTimeTile - 1) / kTimeTile > 65535 ||
      static_cast<size_t>(kTimeTile + 2 * K - 1) * kChannels * sizeof(float) >
          227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0)
    return launch<float>(x, wf, y, B, T_len, C, H, K, padding_l, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wf, y, B, T_len, C, H, K, padding_l, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
