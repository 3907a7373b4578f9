// Device code shared by csrc/lightconv.cu and csrc/dynamicconv.cu: the
// block shape, the staging of x's tile with its halo, and the softmax of
// one row of logits by one warp.
//
// Block shape. A block owns kLanes = 32 consecutive channels (lane l owns
// channel c0 + l, so every load and store of a time row is contiguous
// across the warp and every shared-memory read of x is conflict-free) and
// `warps` x kRows consecutive time steps; warp w computes the kRows outputs
// t0 + w kRows .. t0 + w kRows + kRows - 1 of its lane's channel, with
// kRows independent accumulators. The x values a warp needs are the
// kRows + K - 1 rows from t0 + w kRows - padding_l, staged once for the
// block in fp32 in shared memory (zero outside [0, T) and past C).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace s2st_conv {

constexpr int kLanes = 32;        // channels a block, one a lane
constexpr int kRows = 16;         // consecutive outputs a thread
constexpr int kMaxWarps = 4;      // warps a block, stacked over time
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of x: kN elements loaded from a 16-byte aligned address as one
// Raw word, then widened to fp32.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ static void widen(const Raw& v, float* out) {
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  using Raw = uint4;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void widen(const Raw& u, float* out) {
    const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // a bf16 is the top half of an fp32
      out[2 * i] = __uint_as_float(words[i] << 16);
      out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
};

// Rows t_first .. t_first + rows - 1 of channels c0 .. c0 + kLanes - 1 of
// one sequence xb (T_len x C, contiguous) into xs (rows x kLanes fp32),
// by every thread of the block. With `vec` (C a multiple of Vec<T>::kN and
// xb 16-byte aligned, checked by the launcher) a thread moves 16 bytes at a
// time; otherwise one element. A thread issues up to kUnroll loads before
// its first store, so their latencies overlap.
template <typename T>
__device__ __forceinline__ void stage_x(const T* __restrict__ xb, float* xs,
                                        int64_t T_len, int64_t C, int64_t c0,
                                        int64_t t_first, int rows, bool vec) {
  constexpr int kUnroll = 2;
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const int nthreads = blockDim.y * kLanes;
  if (vec) {
    using V = Vec<T>;
    constexpr int kPerRow = kLanes / V::kN;
    const int n = rows * kPerRow;
    for (int i0 = tid; i0 < n; i0 += kUnroll * nthreads) {
      typename V::Raw raw[kUnroll];
      bool in[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * nthreads;
        const int r = i / kPerRow;
        const int64_t t = t_first + r;
        const int64_t c = c0 + (i - r * kPerRow) * V::kN;
        in[u] = i < n && t >= 0 && t < T_len && c < C;
        if (in[u]) raw[u] = V::load(xb + t * C + c);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * nthreads;
        if (i >= n) break;
        float vals[V::kN];
        if (in[u]) {
          V::widen(raw[u], vals);
        } else {
#pragma unroll
          for (int e = 0; e < V::kN; ++e) vals[e] = 0.f;
        }
        float4* dst = reinterpret_cast<float4*>(xs) + i * (V::kN / 4);
#pragma unroll
        for (int q = 0; q < V::kN / 4; ++q)
          dst[q] = make_float4(vals[4 * q], vals[4 * q + 1], vals[4 * q + 2],
                               vals[4 * q + 3]);
      }
    }
  } else {
    const int n = rows * kLanes;
    for (int i0 = tid; i0 < n; i0 += kUnroll * nthreads) {
      float vals[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * nthreads;
        const int r = i / kLanes;
        const int64_t t = t_first + r;
        const int64_t c = c0 + (i - r * kLanes);
        vals[u] = i < n && t >= 0 && t < T_len && c < C
                      ? to_float(xb[t * C + c]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (i0 + u * nthreads < n) xs[i0 + u * nthreads] = vals[u];
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// softmax over the lanes: v is lane's logit (lanes < K), the normalised
// weight goes to out[lane]. One whole warp; the max and the sum reduce over
// the lanes as a tree.
__device__ __forceinline__ void softmax_lanes(float v, float* out, int K) {
  const int lane = threadIdx.x;
  const float m = warp_max(lane < K ? v : -INFINITY);
  const float e = lane < K ? expf(v - m) : 0.f;
  const float s = warp_sum(e);
  if (lane < K) out[lane] = e / s;
}

// softmax(l[0 .. K-1]) in fp32 into out[0 .. K-1], by one whole warp: a
// lane a tap for K <= 32, lanes striding over the taps above.
template <typename TW>
__device__ __forceinline__ void softmax_row(const TW* __restrict__ l,
                                            float* out, int K) {
  const int lane = threadIdx.x;
  if (K <= kLanes) {
    softmax_lanes(lane < K ? to_float(l[lane]) : 0.f, out, K);
    return;
  }
  float m = -INFINITY;
  for (int k = lane; k < K; k += kLanes) m = fmaxf(m, to_float(l[k]));
  m = warp_max(m);
  float s = 0.f;
  for (int k = lane; k < K; k += kLanes) s += expf(to_float(l[k]) - m);
  s = warp_sum(s);
  for (int k = lane; k < K; k += kLanes)
    out[k] = expf(to_float(l[k]) - m) / s;
}

// The heads that channels c0 .. min(c0 + kLanes, C) - 1 belong to: lo, and
// how many.
__host__ __device__ __forceinline__ int first_head(int64_t c0, int64_t C,
                                                   int H) {
  return static_cast<int>(c0 / (C / H));
}
__host__ __device__ __forceinline__ int heads_in_chunk(int64_t c0, int64_t C,
                                                       int H) {
  const int64_t last = (c0 + kLanes < C ? c0 + kLanes : C) - 1;
  return static_cast<int>(last / (C / H)) - first_head(c0, C, H) + 1;
}

// The most heads any block's channel chunk spans.
inline int max_heads_in_chunk(long long C, int H) {
  int most = 1;
  for (long long c0 = 0; c0 < C; c0 += kLanes) {
    const int n = heads_in_chunk(c0, C, H);
    most = n > most ? n : most;
  }
  return most;
}

inline bool valid_warps(int warps) {
  return warps >= 1 && warps <= kMaxWarps && (warps & (warps - 1)) == 0;
}

__host__ __device__ inline long long round4(long long n) {
  return (n + 3) / 4 * 4;
}

// fp32 words of x's staged tile
__host__ __device__ inline long long staged_words(int warps, int K) {
  return static_cast<long long>(warps * kRows + K - 1) * kLanes;
}

}  // namespace s2st_conv
