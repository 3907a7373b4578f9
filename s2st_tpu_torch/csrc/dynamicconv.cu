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
// 67 TFLOP/s: bytes bound it, FMAs nearly so.
//
// Design (csrc/conv_common.cuh has the shared parts). As csrc/lightconv.cu,
// a block owns 32 channels, a lane each, and `warps` x 16 time steps, and
// a thread computes 16 consecutive outputs of its channel. The softmax is
// taken once per (b, t, head) of the block, not once per channel: the block
// copies the logits of its steps and of the heads its channels span into
// shared memory in fp32 (a warp a step, coalesced; where a step's logits
// fit in the lanes a warp loads all its steps, then x's tile, before its
// first store) and stages x's tile plus its K-1 halo rows beside them,
// with 16-byte loads where C and the pointer allow. After a barrier a
// thread softmaxes one (step, head) row in place: the max, exp(l - max)
// summed in k order, then each times the sum's reciprocal (within an ulp of
// the plain version's division; rows padded to an odd count of 16-byte
// groups, so 16-byte accesses to 8 rows meet no bank conflict). After a
// second barrier, for K in {3, 7, 15, 31} (a template argument) a thread
// loads its 16 + K - 1 x values into registers and, output by output,
// reads the weight row 4 taps at a time (16-byte loads; the lanes of a
// head read the same address, a broadcast) and adds the taps in k order,
// 0 .. K-1, as the plain version does; any other K streams the rows of x
// past 16 accumulators, reading each weight from shared memory. The
// launcher takes 4 warps (64 steps a block) down to 1 for short sequences
// or where the weight tile would not fit in shared memory. At the main
// case: 1024 blocks of 4 warps, each softmaxing 64 rows, so every
// (b, t, head) is softmaxed by the C/H / 32 = 4 blocks of its head. On the
// card a thread a softmax row beat a warp a row (whose 10 shuffles a row
// cost more issue slots than a thread's K exponentials), and loads issued
// together beat loads issued one row after another.
//
// Plain C interface for ctypes; x, w and y are contiguous. Returns the
// cudaError_t of the launch.

#include "conv_common.cuh"

namespace {

using namespace s2st_conv;

// fp32 words from one row of weights to the next: K rounded up to whole
// 16-byte groups, and to an odd number of them, so that the 8 threads of a
// 16-byte shared-memory access reading 8 consecutive rows hit 8 different
// bank groups
__host__ __device__ inline int row_words(int K) {
  const int kp = static_cast<int>(round4(K));
  return (kp / 4) % 2 ? kp : kp + 4;
}

// fp32 words of shared memory: the weights of the tile's steps and the
// heads a chunk spans, a row each, then x's tile
long long smem_words(long long C, int H, int K, int warps) {
  return static_cast<long long>(warps) * kRows * max_heads_in_chunk(C, H) *
             row_words(K) +
         staged_words(warps, K);
}

// softmax of one row of K logits in shared memory, in place, by one thread:
// the max, then exp(l - max) and their sum in k order, then each times the
// sum's reciprocal. With K compiled in (KT > 0) the row is read and written
// with 16-byte accesses and held in registers.
template <int KT>
__device__ __forceinline__ void softmax_in_place(float* row, int K) {
  if constexpr (KT > 0) {
    constexpr int kQ = (KT + 3) / 4;
    float v[4 * kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float4 f = reinterpret_cast<const float4*>(row)[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
    float m = v[0];
#pragma unroll
    for (int k = 1; k < KT; ++k) m = fmaxf(m, v[k]);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      v[k] = expf(v[k] - m);
      s += v[k];
    }
    const float inv = __frcp_rn(s);
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      reinterpret_cast<float4*>(row)[q] =
          make_float4(v[4 * q] * inv, v[4 * q + 1] * inv,
                      v[4 * q + 2] * inv, v[4 * q + 3] * inv);
  } else {
    float m = row[0];
    for (int k = 1; k < K; ++k) m = fmaxf(m, row[k]);
    float s = 0.f;
    for (int k = 0; k < K; ++k) {
      row[k] = expf(row[k] - m);
      s += row[k];
    }
    const float inv = __frcp_rn(s);
    for (int k = 0; k < K; ++k) row[k] *= inv;
  }
}

template <typename TX, typename TW, int KT>
__global__ void __launch_bounds__(kMaxWarps * kLanes, 3)
dynamicconv_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   TX* __restrict__ y, int64_t T_len, int64_t C, int H,
                   int k_runtime, int padding_l, bool vec) {
  constexpr bool kFixed = KT > 0;
  const int K = kFixed ? KT : k_runtime;
  const int kp = row_words(K);
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tile = blockDim.y * kRows;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kLanes;
  const int64_t t0 = static_cast<int64_t>(blockIdx.y) * tile;
  const int64_t b = blockIdx.z;
  const int h_lo = first_head(c0, C, H);
  const int nh = heads_in_chunk(c0, C, H);
  float* ws = smem;                       // tile x nh rows of kp words
  float* xs = smem + tile * nh * kp;

  // the logits of the tile's steps and the chunk's heads, a warp a step
  // (nh K contiguous values), and x's tile. Where a step's logits fit in a
  // warp's lanes, a warp loads all its kRows steps, then x's tile, before
  // its first store, so that the loads overlap.
  const TW* wb = w + (b * T_len * H + h_lo) * K;
  const int seg = nh * K;
  if (seg <= kLanes) {
    float lv[kRows];
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      const int64_t t = t0 + warp + g * blockDim.y;
      lv[g] = t < T_len && lane < seg ? to_float(wb[t * H * K + lane]) : 0.f;
    }
    stage_x(x + b * T_len * C, xs, T_len, C, c0, t0 - padding_l,
            tile + K - 1, vec);
    const int hh = lane / K;
#pragma unroll
    for (int g = 0; g < kRows; ++g)
      if (lane < seg)
        ws[((warp + g * blockDim.y) * nh + hh) * kp + lane - hh * K] = lv[g];
  } else {
    for (int tl = warp; tl < tile; tl += blockDim.y) {
      const int64_t t = t0 + tl;
      if (t >= T_len) break;
      for (int e = lane; e < seg; e += kLanes) {
        const int hh = e / K;
        ws[(tl * nh + hh) * kp + e - hh * K] = to_float(wb[t * H * K + e]);
      }
    }
    stage_x(x + b * T_len * C, xs, T_len, C, c0, t0 - padding_l,
            tile + K - 1, vec);
  }
  __syncthreads();
  // one softmax per (step, head): a thread a row
  const int n_rows = static_cast<int>(
      (T_len - t0 < tile ? T_len - t0 : tile) * nh);
  for (int i = warp * kLanes + lane; i < n_rows; i += blockDim.y * kLanes)
    softmax_in_place<KT>(ws + i * kp, K);
  __syncthreads();

  const int64_t c = c0 + lane;
  const int r0 = warp * kRows;
  if (c >= C || t0 + r0 >= T_len) return;
  const int step_words = nh * kp;         // from one step's row to the next
  const float* wr = ws + r0 * step_words + (c / (C / H) - h_lo) * kp;
  const float* xr = xs + r0 * kLanes + lane;
  TX* yc = y + (b * T_len + t0 + r0) * C + c;
  if constexpr (kFixed) {
    constexpr int kP = (KT + 3) / 4 * 4;
    float xv[kRows + KT - 1];
#pragma unroll
    for (int j = 0; j < kRows + KT - 1; ++j) xv[j] = xr[j * kLanes];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4* w4 = reinterpret_cast<const float4*>(wr + r * step_words);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kP / 4; ++q) {
        const float4 wq = w4[q];
        const float wv[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * q + e < KT) acc = fmaf(xv[r + 4 * q + e], wv[e], acc);
      }
      if (t0 + r0 + r < T_len) store(yc + r * C, acc);
    }
  } else {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int j = 0; j < kRows + K - 1; ++j) {
      const float xj = xr[j * kLanes];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int k = j - r;
        if (k >= 0 && k < K)
          acc[r] = fmaf(xj, wr[r * step_words + k], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (t0 + r0 + r < T_len) store(yc + r * C, acc[r]);
  }
}

template <typename TX, typename TW, int KT>
int launch(const void* x, const void* w, void* y, long long B,
           long long T_len, long long C, int H, int K, int padding_l,
           int warps, bool vec, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(smem_words(C, H, K, warps)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dynamicconv_kernel<TX, TW, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long tile = static_cast<long long>(warps) * kRows;
  dim3 grid(static_cast<unsigned>((C + kLanes - 1) / kLanes),
            static_cast<unsigned>((T_len + tile - 1) / tile),
            static_cast<unsigned>(B));
  dim3 block(kLanes, warps);
  dynamicconv_kernel<TX, TW, KT><<<grid, block, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(y), T_len, C, H, K, padding_l, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW>
int launch_k(const void* x, const void* w, void* y, long long B,
             long long T_len, long long C, int H, int K, int padding_l,
             int warps, int vec, cudaStream_t s) {
  if (vec && (C % Vec<TX>::kN != 0 ||
              reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (K) {
    case 3:
      return launch<TX, TW, 3>(x, w, y, B, T_len, C, H, K, padding_l, warps,
                               vec, s);
    case 7:
      return launch<TX, TW, 7>(x, w, y, B, T_len, C, H, K, padding_l, warps,
                               vec, s);
    case 15:
      return launch<TX, TW, 15>(x, w, y, B, T_len, C, H, K, padding_l, warps,
                                vec, s);
    case 31:
      return launch<TX, TW, 31>(x, w, y, B, T_len, C, H, K, padding_l, warps,
                                vec, s);
    default:
      return launch<TX, TW, 0>(x, w, y, B, T_len, C, H, K, padding_l, warps,
                               vec, s);
  }
}

}  // namespace

// x_dtype (x and y) and w_dtype: 0 fp32, 1 bf16. warps: 1, 2 or 4, the
// block's warps over time. vec: stage x with 16-byte loads (C a multiple of
// 16 bytes' elements and x 16-byte aligned, else refused).
extern "C" int s2st_dynamicconv_fwd(const void* x, const void* w, void* y,
                                    long long B, long long T_len, long long C,
                                    int H, int K, int padding_l, int x_dtype,
                                    int w_dtype, int warps, int vec,
                                    void* stream) {
  if (B <= 0 || B > 65535 || T_len <= 0 || C <= 0 || H <= 0 || C % H != 0 ||
      K <= 0 || padding_l < 0 || padding_l > K - 1 || !valid_warps(warps) ||
      (T_len + warps * kRows - 1) / (warps * kRows) > 65535 ||
      static_cast<size_t>(smem_words(C, H, K, warps)) * sizeof(float) >
          kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dtype == 0 && w_dtype == 0)
    return launch_k<float, float>(x, w, y, B, T_len, C, H, K, padding_l,
                                  warps, vec, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_k<float, bf16>(x, w, y, B, T_len, C, H, K, padding_l,
                                 warps, vec, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_k<bf16, float>(x, w, y, B, T_len, C, H, K, padding_l,
                                 warps, vec, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_k<bf16, bf16>(x, w, y, B, T_len, C, H, K, padding_l, warps,
                                vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
