// Dynamic convolution forward for Hopper (sm_90a): a depthwise K-tap
// convolution over time whose weights are predicted per position, one
// softmax over K for each (b, t, head), shared by the C/H channels of the
// head:
//
//   y[b, t, c] = sum_k softmax(w[b, t, c / (C/H), :])[k] * x[b, t + k - padding_l, c]
//
// with x read as 0 outside [0, T). Replaces the Pallas TPU kernel
// s2st_tpu/ops/conv_kernels.py::dynamicconv / _dynamicconv_kernel (:133-175,
// pallas_call at :162), which the DynamicConv encoder (padding_l = K/2) and
// teacher-forced decoder (causal, padding_l = K-1) run. The TPU function
// softmaxes the (B, T, H, K) logits in fp32 and expands them to (B, K, T, C)
// outside its kernel, because Mosaic has no cross-lane repeat; this kernel
// reads the logits itself, takes each softmax in fp32 and indexes the head as
// c / (C/H), so the expanded weights never exist. It takes every T: the TPU
// function's fall back to XLA above a 12 MiB VMEM budget (:155) has no
// counterpart here. Any padding_l in [0, K-1] is taken; x and y are fp32 or
// bf16, the logits fp32 or bf16, independently; the taps accumulate in fp32.
//
// Bound on the card. The function reads x and the logits once and writes y
// once: at the encoder's B=64, T=64, C=512, H=4, K=31 in bf16 that is 9.4 MB,
// 2.8 us at 3.35 TB/s, against 2*K*B*T*C = 130 MFLOP, 1.9 us of fp32 FMAs at
// 67 TFLOP/s: bytes bound it, and a launch costs more than either.
//
// Design. As csrc/lightconv.cu: one block per (128-channel chunk, 32-step
// time tile, b), one thread a channel, the thread's tile of x plus K-1 halo
// rows staged in fp32 in its own column of shared memory. For each output
// step the thread reads its head's K logits (the threads of a head read the
// same addresses, so a warp's read is one transaction, and the row stays in
// L1 for the next warps), takes their max and sum of exponentials, and adds
// exp(l_k - max) / sum * x tap by tap in k order, as the plain version does.
//
// Plain C interface for ctypes; x, w and y are contiguous. Returns the
// cudaError_t of the launch.

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

template <typename TX, typename TW>
__global__ void __launch_bounds__(kChannels)
dynamicconv_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   TX* __restrict__ y, int64_t T_len, int64_t C, int H, int K,
                   int padding_l) {
  extern __shared__ float xs[];            // (kTimeTile + K - 1) x kChannels
  const int rows = kTimeTile + K - 1;
  const int tid = threadIdx.x;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kChannels + tid;
  if (c >= C) return;
  const int64_t t0 = static_cast<int64_t>(blockIdx.y) * kTimeTile;
  const int64_t b = blockIdx.z;
  const int64_t h = c / (C / H);

  const TX* xb = x + b * T_len * C + c;
  for (int r = 0; r < rows; ++r) {
    const int64_t t = t0 - padding_l + r;
    xs[r * kChannels + tid] =
        (t >= 0 && t < T_len) ? to_float(xb[t * C]) : 0.f;
  }

  TX* yb = y + b * T_len * C + c;
  const int n_out = T_len - t0 < kTimeTile ? static_cast<int>(T_len - t0)
                                            : kTimeTile;
  for (int i = 0; i < n_out; ++i) {
    const TW* lr = w + ((b * T_len + t0 + i) * H + h) * K;
    float m = to_float(lr[0]);
    for (int k = 1; k < K; ++k) m = fmaxf(m, to_float(lr[k]));
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += expf(to_float(lr[k]) - m);
    float acc = 0.f;
    for (int k = 0; k < K; ++k)
      acc = fmaf(xs[(i + k) * kChannels + tid],
                 expf(to_float(lr[k]) - m) / s, acc);
    store(yb + (t0 + i) * C, acc);
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* y, long long B,
           long long T_len, long long C, int H, int K, int padding_l,
           cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(kTimeTile + K - 1) * kChannels * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dynamicconv_kernel<TX, TW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>((C + kChannels - 1) / kChannels),
            static_cast<unsigned>((T_len + kTimeTile - 1) / kTimeTile),
            static_cast<unsigned>(B));
  dynamicconv_kernel<TX, TW><<<grid, kChannels, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(y), T_len, C, H, K, padding_l);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_dtype (x and y) and w_dtype: 0 fp32, 1 bf16.
extern "C" int s2st_dynamicconv_fwd(const void* x, const void* w, void* y,
                                    long long B, long long T_len, long long C,
                                    int H, int K, int padding_l, int x_dtype,
                                    int w_dtype, void* stream) {
  if (B <= 0 || B > 65535 || T_len <= 0 || C <= 0 || H <= 0 || C % H != 0 ||
      K <= 0 || padding_l < 0 || padding_l > K - 1 ||
      (T_len + kTimeTile - 1) / kTimeTile > 65535 ||
      static_cast<size_t>(kTimeTile + K - 1) * kChannels * sizeof(float) >
          227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, w, y, B, T_len, C, H, K, padding_l, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w, y, B, T_len, C, H, K,
                                        padding_l, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, y, B, T_len, C, H, K,
                                        padding_l, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, B, T_len, C, H, K,
                                                padding_l, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
