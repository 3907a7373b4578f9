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
// weights are H*K floats. At the encoder's B=64, T=64, C=512, H=4, K=31 in
// bf16 that is 8.4 MB, 2.5 us at 3.35 TB/s, against 2*K*B*T*C = 130 MFLOP,
// 1.9 us of fp32 FMAs at 67 TFLOP/s: bytes bound it, FMAs nearly so, and a
// launch costs about as much as either at this size.
//
// Design (csrc/conv_common.cuh has the shared parts). A block owns 32
// channels, a lane each, and `warps` x 16 time steps; a thread computes 16
// consecutive outputs of its channel with 16 independent accumulators. The
// block loads the logits of the heads its channels span (a warp a head, a
// lane a tap) and stages x's tile plus its K-1 halo rows in fp32 in shared
// memory, with 16-byte loads where C and the pointer allow (one element a
// thread otherwise: odd C, an unaligned view), each thread issuing its
// loads before its first store; the warps then softmax their head rows in
// fp32 into shared memory. One barrier. A thread copies its head's K
// weights into registers and streams the 16 + K - 1 rows of x past them:
// each x value, read once from shared memory (a conflict-free row of the
// warp), feeds up to 16 FMAs that do not depend on each other. K is a
// template argument for the model's kernel sizes 3, 7, 15 and 31, so the
// tap loop unrolls and the weights stay in registers; one instantiation
// with a run-time K (weights read from shared memory) takes every other K.
// Each output still adds its taps in k order, 0 .. K-1, as the plain
// version does. The launcher takes 4 warps (64 steps a block) down to 1 for
// short sequences; at the main case that is 16 x 1 x 64 = 1024 blocks of 4
// warps. Of the shapes tried on the card, 16 outputs a thread in 4 warps
// beat 8 in 8 warps and 4 in 8, and two loads in flight a thread beat four
// (more registers, fewer blocks an SM).
//
// Plain C interface for ctypes; x, w and y are contiguous, w is fp32 (H, K).
// Returns the cudaError_t of the launch.

#include "conv_common.cuh"

namespace {

using namespace s2st_conv;

// fp32 words of shared memory: the softmaxed rows of the heads a chunk
// spans, padded to 16 bytes, then x's staged tile
long long smem_words(long long C, int H, int K, int warps) {
  return round4(static_cast<long long>(max_heads_in_chunk(C, H)) * K) +
         staged_words(warps, K);
}

template <typename T, int KT>
__global__ void __launch_bounds__(kMaxWarps * kLanes, 3)
lightconv_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 T* __restrict__ y, int64_t T_len, int64_t C, int H,
                 int k_runtime, int padding_l, bool vec) {
  constexpr bool kFixed = KT > 0;
  const int K = kFixed ? KT : k_runtime;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tile = blockDim.y * kRows;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kLanes;
  const int64_t t0 = static_cast<int64_t>(blockIdx.y) * tile;
  const int64_t b = blockIdx.z;
  const int h_lo = first_head(c0, C, H);
  const int nh = heads_in_chunk(c0, C, H);
  float* ws = smem;                                   // nh x K
  float* xs = smem + round4(static_cast<long long>(nh) * K);

  // a warp a head row: its logits are loaded before x's tile, so that the
  // two loads overlap, where a lane a tap and a warp a head suffice
  const bool one_pass = K <= kLanes && nh <= static_cast<int>(blockDim.y);
  float logit = 0.f;
  if (one_pass && warp < nh && lane < K)
    logit = w[static_cast<int64_t>(h_lo + warp) * K + lane];
  stage_x(x + b * T_len * C, xs, T_len, C, c0, t0 - padding_l,
          tile + K - 1, vec);
  if (one_pass) {
    if (warp < nh) softmax_lanes(logit, ws + warp * K, K);
  } else {
    for (int i = warp; i < nh; i += blockDim.y)
      softmax_row(w + static_cast<int64_t>(h_lo + i) * K, ws + i * K, K);
  }
  __syncthreads();

  const int64_t c = c0 + lane;
  const int r0 = warp * kRows;
  if (c >= C || t0 + r0 >= T_len) return;
  const float* wh = ws + (c / (C / H) - h_lo) * K;
  const float* xr = xs + r0 * kLanes + lane;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  if constexpr (kFixed) {
    float wk[KT];
#pragma unroll
    for (int k = 0; k < KT; ++k) wk[k] = wh[k];
#pragma unroll
    for (int j = 0; j < kRows + KT - 1; ++j) {
      const float xv = xr[j * kLanes];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int k = j - r;
        if (k >= 0 && k < KT) acc[r] = fmaf(xv, wk[k], acc[r]);
      }
    }
  } else {
    for (int j = 0; j < kRows + K - 1; ++j) {
      const float xv = xr[j * kLanes];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int k = j - r;
        if (k >= 0 && k < K) acc[r] = fmaf(xv, wh[k], acc[r]);
      }
    }
  }
  T* yc = y + (b * T_len + t0 + r0) * C + c;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (t0 + r0 + r < T_len) store(yc + r * C, acc[r]);
}

template <typename T, int KT>
int launch(const void* x, const float* w, void* y, long long B,
           long long T_len, long long C, int H, int K, int padding_l,
           int warps, bool vec, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(smem_words(C, H, K, warps)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lightconv_kernel<T, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long tile = static_cast<long long>(warps) * kRows;
  dim3 grid(static_cast<unsigned>((C + kLanes - 1) / kLanes),
            static_cast<unsigned>((T_len + tile - 1) / tile),
            static_cast<unsigned>(B));
  dim3 block(kLanes, warps);
  lightconv_kernel<T, KT><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(y), T_len, C, H, K,
      padding_l, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k(const void* x, const float* w, void* y, long long B,
             long long T_len, long long C, int H, int K, int padding_l,
             int warps, int vec, cudaStream_t s) {
  if (vec && (C % Vec<T>::kN != 0 ||
              reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (K) {
    case 3:
      return launch<T, 3>(x, w, y, B, T_len, C, H, K, padding_l, warps, vec,
                          s);
    case 7:
      return launch<T, 7>(x, w, y, B, T_len, C, H, K, padding_l, warps, vec,
                          s);
    case 15:
      return launch<T, 15>(x, w, y, B, T_len, C, H, K, padding_l, warps, vec,
                           s);
    case 31:
      return launch<T, 31>(x, w, y, B, T_len, C, H, K, padding_l, warps, vec,
                           s);
    default:
      return launch<T, 0>(x, w, y, B, T_len, C, H, K, padding_l, warps, vec,
                          s);
  }
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (x and y). warps: 1, 2 or 4, the block's warps
// over time. vec: stage x with 16-byte loads (C a multiple of 16
// bytes' elements and x 16-byte aligned, else refused).
extern "C" int s2st_lightconv_fwd(const void* x, const void* w, void* y,
                                  long long B, long long T_len, long long C,
                                  int H, int K, int padding_l, int dtype,
                                  int warps, int vec, void* stream) {
  if (B <= 0 || B > 65535 || T_len <= 0 || C <= 0 || H <= 0 || C % H != 0 ||
      K <= 0 || padding_l < 0 || padding_l > K - 1 || !valid_warps(warps) ||
      (T_len + warps * kRows - 1) / (warps * kRows) > 65535 ||
      static_cast<size_t>(smem_words(C, H, K, warps)) * sizeof(float) >
          kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0)
    return launch_k<float>(x, wf, y, B, T_len, C, H, K, padding_l, warps,
                           vec, s);
  if (dtype == 1)
    return launch_k<__nv_bfloat16>(x, wf, y, B, T_len, C, H, K, padding_l,
                                   warps, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
